"""Carry JAX-package weights across to the port.

`params_from_numpy` takes the JAX `LlamaParams` as a nested dict of numpy
arrays (`dataclasses.asdict` of the pytree with numpy leaves) and returns
the port's `LlamaParams`. The layouts are the same, the int4 nibble layout
included, so this is a copy; it imports no JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from magicpig_tpu_torch.models.llama import (
    LayerParams,
    LlamaParams,
    Quant4Weight,
    QuantWeight,
)


def params_from_numpy(tree: dict,
                      device: torch.device | str = "cuda") -> LlamaParams:
    """tree: {"embed", "lm_head", "final_ln", "cos", "sin": array,
    "layers": {"wq", ..., "ln_mlp", "wqkv", "w_gateup": array}}. A
    quantized weight is a {"q", "scale"} dict: int8 per channel (scale with
    one axis fewer than q) or group-128 int4 (scale [..., in/128, out]); a
    None weight (the fused slots, or the parts a fused tree dropped) stays
    None. Every array keeps its dtype (bf16 included)."""

    def t(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":      # numpy has no native bf16
            return torch.from_numpy(a.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def weight(w):
        if w is None:
            return None
        if isinstance(w, dict):
            q, scale = t(w["q"]), t(w["scale"])
            kind = Quant4Weight if scale.dim() == q.dim() else QuantWeight
            return kind(q=q, scale=scale)
        return t(w)

    layer_fields = [f.name for f in dataclasses.fields(LayerParams)]
    layers = LayerParams(**{k: weight(tree["layers"].get(k))
                            for k in layer_fields})
    return LlamaParams(embed=t(tree["embed"]),
                       lm_head=weight(tree["lm_head"]),
                       final_ln=t(tree["final_ln"]), layers=layers,
                       cos=t(tree["cos"]), sin=t(tree["sin"]))

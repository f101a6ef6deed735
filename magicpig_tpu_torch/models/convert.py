"""Carry JAX-package weights across to the port.

`params_from_numpy` takes the JAX `LlamaParams` as a nested dict of numpy
arrays (`dataclasses.asdict` of the pytree with numpy leaves) and returns
the port's `LlamaParams`. The layouts are the same, the int4 nibble layout
included, so this is a copy; it imports no JAX.

`load_params` reads the JAX package's `.npz` checkpoints
(`examples/train_needle.py::save_params`: `n`, the pytree's `treedef`
string and its leaves `leaf_0 .. leaf_{n-1}` in JAX's flatten order of
`LlamaParams`). That order is fixed here (`NPZ_LEAVES`), and the saved
structure is checked against it, without JAX. `save_params` writes that
layout: JAX's `load_params` (`examples/train_needle.py`) and this module's
read it back unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from magicpig_tpu_torch.config import ModelConfig
from magicpig_tpu_torch.models.llama import (
    LayerParams,
    LlamaParams,
    Quant4Weight,
    QuantWeight,
)
from magicpig_tpu_torch.ops.rope import rope_cos_sin

# JAX's flatten order of an unquantized, unfused `LlamaParams` (flax
# dataclass fields in declaration order; the fused slots, None, hold no
# leaf), and the structure strings its `treedef` prints: without the fused
# slots (checkpoints saved before they existed) and with them.
NPZ_LAYER_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                    "ln_attn", "ln_mlp")
NPZ_LEAVES = ("embed", "lm_head", "final_ln",
              *(f"layers.{k}" for k in NPZ_LAYER_LEAVES), "cos", "sin")
_TREEDEF = ("PyTreeDef(CustomNode(LlamaParams[()], [*, *, *, "
            "CustomNode(LayerParams[()], [{}]), *, *]))")
NPZ_TREEDEFS = (_TREEDEF.format(", ".join(["*"] * 9)),
                _TREEDEF.format(", ".join(["*"] * 9 + ["None"] * 2)))


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


def _npz_shapes(config: ModelConfig, max_len: int) -> dict[str, tuple]:
    """The shape of each `NPZ_LEAVES` leaf for `config` and `max_len`."""
    n, h, v = config.num_hidden_layers, config.hidden_size, config.vocab_size
    d, inter = config.head_dim, config.intermediate_size
    hq, hkv = config.num_attention_heads * d, config.num_key_value_heads * d
    layer = dict(wq=(h, hq), wk=(h, hkv), wv=(h, hkv), wo=(hq, h),
                 w_gate=(h, inter), w_up=(h, inter), w_down=(inter, h),
                 ln_attn=(h,), ln_mlp=(h,))
    return {"embed": (v, h), "lm_head": (h, v), "final_ln": (h,),
            **{f"layers.{k}": (n, *s) for k, s in layer.items()},
            "cos": (max_len, d), "sin": (max_len, d)}


def load_params(path, config: ModelConfig, max_len: int,
                device: torch.device | str = "cuda") -> LlamaParams:
    """Params from a JAX `.npz` checkpoint: its `n` and `treedef` must be
    those of `NPZ_LEAVES`, and every weight the shape `config` gives it
    (ValueError otherwise); weights are cast to `config.dtype`. RoPE caches
    saved for another `max_len` are computed anew, as the JAX loader does."""
    data = np.load(path, allow_pickle=False)
    n, treedef = int(data["n"]), str(data["treedef"])
    if n != len(NPZ_LEAVES):
        raise ValueError(f"{path}: {n} leaves, expected {len(NPZ_LEAVES)}")
    if treedef not in NPZ_TREEDEFS:
        raise ValueError(f"{path}: saved structure {treedef} is not a "
                         f"LlamaParams of {NPZ_TREEDEFS}")
    shapes = _npz_shapes(config, max_len)
    leaves = {}
    for i, name in enumerate(NPZ_LEAVES):
        a = data[f"leaf_{i}"]
        if name in ("cos", "sin"):
            leaves[name] = (torch.from_numpy(a).to(device, torch.float32)
                            if a.shape == shapes[name] else None)
            continue
        if a.shape != shapes[name]:
            raise ValueError(f"{path}: {name} has shape {a.shape}, the "
                             f"config gives {shapes[name]}")
        leaves[name] = torch.from_numpy(a).to(device).to(config.dtype)
    if leaves["cos"] is None or leaves["sin"] is None:
        leaves["cos"], leaves["sin"] = rope_cos_sin(config, max_len,
                                                    device=device)
    layers = LayerParams(**{k: leaves[f"layers.{k}"] for k in NPZ_LAYER_LEAVES})
    return LlamaParams(embed=leaves["embed"], lm_head=leaves["lm_head"],
                       final_ln=leaves["final_ln"], layers=layers,
                       cos=leaves["cos"], sin=leaves["sin"])


def leaves(params: LlamaParams) -> list[torch.Tensor]:
    """The leaves of unquantized, unfused params in the JAX pytree's order
    (`NPZ_LEAVES`), the RoPE tables last."""
    out = []
    for name in NPZ_LEAVES:
        obj = params
        for part in name.split("."):
            obj = getattr(obj, part)
        out.append(obj)
    return out


def save_params(params: LlamaParams, path) -> None:
    """Write unquantized, unfused params in the JAX `.npz` layout: `n`, the
    `treedef` string the JAX package prints for `LlamaParams` today (with
    the fused slots), and `leaf_i` in `NPZ_LEAVES` order, each as a numpy
    array of its own dtype (bf16 leaves as float32, which numpy can hold)."""
    layers = params.layers
    if layers.wqkv is not None or layers.w_gateup is not None or any(
            isinstance(w, (QuantWeight, Quant4Weight))
            for w in (params.lm_head, *(getattr(layers, k)
                                        for k in NPZ_LAYER_LEAVES))):
        raise ValueError("save_params writes unquantized, unfused params")

    def numpy(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.contiguous().numpy()

    np.savez(path, n=len(NPZ_LEAVES), treedef=NPZ_TREEDEFS[1],
             **{f"leaf_{i}": numpy(t) for i, t in enumerate(leaves(params))})

"""Load Llama-family weights from a HuggingFace state dict or a local HF
checkpoint directory (port of `magicpig_tpu/models/loader.py`).

HF stores each linear weight as [out, in]; the port, like the JAX package,
keeps [in, out] stacked over layers and applies `x @ w`, so the linear
weights are transposed. An untied `lm_head.weight` is kept as its own
weight; a tied (or missing) one is `embed.T`. Quantized configurations
(`ModelConfig.weight_quant`) quantize the loaded weights one layer at a
time and, with `fuse_small_linears`, fuse q/k/v and gate|up.

`load_checkpoint` reads the `*.safetensors` files of a directory with its
own reader (`SafetensorsFiles`: the format is an 8-byte little-endian
header length, a JSON header of names, dtypes, shapes and byte offsets,
then the raw data), so the port needs no `safetensors` package. Each file
is memory-mapped and each tensor moved to the device on its own, so a
checkpoint never sits whole in host memory. BF16, F16 and F32 tensors are
read (the JAX package reads through numpy, which has no bfloat16, so it
cannot read the bf16 files HF Llama and Mistral checkpoints ship).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import math
import mmap
import os
from collections.abc import Mapping

import numpy as np
import torch

from magicpig_tpu_torch.config import ModelConfig
from magicpig_tpu_torch.models.llama import (
    LayerParams,
    LlamaParams,
    fuse_params,
    quantize_params,
)
from magicpig_tpu_torch.ops.rope import rope_cos_sin


def params_from_state_dict(config: ModelConfig, sd: dict, max_len: int,
                           dtype: torch.dtype | None = None,
                           device: torch.device | str = "cuda") -> LlamaParams:
    """Params from an HF-style state dict of torch tensors or numpy arrays,
    each weight cast to `dtype` (default `config.dtype`) on `device` one
    tensor at a time; RoPE caches for `max_len` positions."""
    dt = dtype or config.dtype
    n = config.num_hidden_layers

    def get(name):
        x = sd[name]
        x = torch.from_numpy(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
        return x.detach().to(device=device, dtype=torch.float32).to(dt)

    def stack(fmt, transpose=True):
        ws = torch.stack([get(fmt.format(i)) for i in range(n)])
        # HF stores [out, in]; the port uses [in, out].
        return ws.transpose(1, 2).contiguous() if transpose else ws

    layers = LayerParams(
        wq=stack("model.layers.{}.self_attn.q_proj.weight"),
        wk=stack("model.layers.{}.self_attn.k_proj.weight"),
        wv=stack("model.layers.{}.self_attn.v_proj.weight"),
        wo=stack("model.layers.{}.self_attn.o_proj.weight"),
        w_gate=stack("model.layers.{}.mlp.gate_proj.weight"),
        w_up=stack("model.layers.{}.mlp.up_proj.weight"),
        w_down=stack("model.layers.{}.mlp.down_proj.weight"),
        ln_attn=stack("model.layers.{}.input_layernorm.weight", transpose=False),
        ln_mlp=stack("model.layers.{}.post_attention_layernorm.weight",
                     transpose=False),
    )
    embed = get("model.embed_tokens.weight")
    if config.tie_word_embeddings or "lm_head.weight" not in sd:
        lm_head = embed.T
    else:
        lm_head = get("lm_head.weight").T.contiguous()
    cos, sin = rope_cos_sin(config, max_len, device=device)
    params = LlamaParams(embed=embed, lm_head=lm_head,
                         final_ln=get("model.norm.weight"), layers=layers,
                         cos=cos, sin=sin)
    if config.weight_quant in ("int8", "int4"):
        params = quantize_params(
            params, bits=4 if config.weight_quant == "int4" else 8)
        if config.fuse_small_linears:
            params = fuse_params(params)
    return params


SAFETENSORS_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
                      "F32": torch.float32}


def safetensors_header(path: str | os.PathLike):
    """(the data's first byte in the file, {name: (dtype, shape, begin,
    end)}) of a .safetensors file, begin and end relative to that byte.
    A dtype other than BF16, F16 or F32, or a size that does not match its
    shape, raises ValueError."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    tensors = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} is {info['dtype']}; only "
                             f"{sorted(SAFETENSORS_DTYPES)} are read")
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        if end - begin != math.prod(shape) * dtype.itemsize:
            raise ValueError(f"{path}: {name} holds {end - begin} bytes, not "
                             f"{shape} of {info['dtype']}")
        tensors[name] = (dtype, shape, begin, end)
    return 8 + n, tensors


class SafetensorsFiles(Mapping):
    """The tensors of some .safetensors files as a read-only mapping: each
    file memory-mapped (copy on write: nothing is read until a tensor is),
    and each tensor, when it is looked up, copied from the mapping to
    `device` on its own. `close()` (or leaving a `with` block) unmaps the
    files."""

    def __init__(self, files, device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        self._where: dict[str, tuple] = {}
        self._maps: list[mmap.mmap] = []
        try:
            for path in files:
                start, tensors = safetensors_header(path)
                with open(path, "rb") as f:
                    mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
                self._maps.append(mm)
                for name, (dtype, shape, begin, _) in tensors.items():
                    self._where[name] = (mm, dtype, shape, start + begin)
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        for mm in self._maps:
            mm.close()
        self._maps.clear()
        self._where.clear()

    def __enter__(self) -> "SafetensorsFiles":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __getitem__(self, name: str) -> torch.Tensor:
        mm, dtype, shape, offset = self._where[name]
        if math.prod(shape) == 0:
            return torch.empty(shape, dtype=dtype, device=self.device)
        view = torch.frombuffer(mm, dtype=dtype, count=math.prod(shape),
                                offset=offset).reshape(shape)
        if self.device.type == "cpu":
            return view.clone()
        return view.to(self.device)

    def __contains__(self, name) -> bool:
        return name in self._where

    def __iter__(self):
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)


def load_checkpoint(path: str, max_len: int, dtype: torch.dtype | None = None,
                    weight_quant: str = "none",
                    device: torch.device | str = "cuda"):
    """(config, params) of a local HF checkpoint directory: its
    config.json (`ModelConfig.from_hf_config`, named after the directory,
    with `weight_quant` replaced when it is not "none") and every
    *.safetensors file in it, in sorted order, on `device`. No such file
    raises FileNotFoundError."""
    config = ModelConfig.from_hf_config(
        os.path.join(path, "config.json"), name=os.path.basename(path))
    if weight_quant != "none":
        config = dataclasses.replace(config, weight_quant=weight_quant)
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no *.safetensors under {path}")
    with SafetensorsFiles(files, device) as sd:
        return config, params_from_state_dict(config, sd, max_len, dtype,
                                               device)

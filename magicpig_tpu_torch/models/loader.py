"""Load Llama-family weights from a HuggingFace state dict (port of
`magicpig_tpu/models/loader.py::params_from_state_dict`).

HF stores each linear weight as [out, in]; the port, like the JAX package,
keeps [in, out] stacked over layers and applies `x @ w`, so the linear
weights are transposed. An untied `lm_head.weight` is kept as its own
weight; a tied (or missing) one is `embed.T`. Quantized configurations
(`ModelConfig.weight_quant`) quantize the loaded weights one layer at a
time and, with `fuse_small_linears`, fuse q/k/v and gate|up.
"""

from __future__ import annotations

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

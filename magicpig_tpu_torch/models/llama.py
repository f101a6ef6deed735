"""Llama-family model, bf16 path (port of `magicpig_tpu/models/llama.py`).

Weights keep the JAX package's layout: stacked per-layer tensors
[num_layers, in, out], applied as `x @ w`. Large plain products stay
`torch.matmul`, as the JAX package left them to XLA.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from magicpig_tpu_torch.config import ModelConfig
from magicpig_tpu_torch.ops.norms import rms_norm
from magicpig_tpu_torch.ops.rope import apply_rope, rope_cos_sin


@dataclasses.dataclass
class LayerParams:
    """Stacked transformer-layer weights; leading dim = num_layers."""

    wq: torch.Tensor      # [N, hidden, Hq*d]
    wk: torch.Tensor      # [N, hidden, Hkv*d]
    wv: torch.Tensor      # [N, hidden, Hkv*d]
    wo: torch.Tensor      # [N, Hq*d, hidden]
    w_gate: torch.Tensor  # [N, hidden, inter]
    w_up: torch.Tensor    # [N, hidden, inter]
    w_down: torch.Tensor  # [N, inter, hidden]
    ln_attn: torch.Tensor  # [N, hidden]
    ln_mlp: torch.Tensor   # [N, hidden]

    def layer(self, i: int) -> "LayerParams":
        return LayerParams(**{f.name: getattr(self, f.name)[i]
                              for f in dataclasses.fields(self)})

    def to(self, device: torch.device | str) -> "LayerParams":
        return LayerParams(**{f.name: getattr(self, f.name).to(device)
                              for f in dataclasses.fields(self)})


@dataclasses.dataclass
class LlamaParams:
    embed: torch.Tensor      # [vocab, hidden]
    lm_head: torch.Tensor    # [hidden, vocab] (a view of embed when tied)
    final_ln: torch.Tensor   # [hidden]
    layers: LayerParams
    cos: torch.Tensor        # [max_len, head_dim] RoPE cache, f32
    sin: torch.Tensor

    def to(self, device: torch.device | str) -> "LlamaParams":
        """A copy on `device` (a tied lm_head becomes its own copy)."""
        return LlamaParams(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})


def init_params(config: ModelConfig, max_len: int,
                generator: torch.Generator,
                device: torch.device | str = "cuda") -> LlamaParams:
    """Random weights (N(0, 1/fan_in)), drawn in the model dtype on `device`
    from `generator` (which must live on that device): a full-width model
    never passes through the host or through float32."""
    n = config.num_hidden_layers
    h = config.hidden_size
    hq = config.num_attention_heads * config.head_dim
    hkv = config.num_key_value_heads * config.head_dim
    inter = config.intermediate_size
    dt = config.dtype

    def w(shape, fan_in):
        x = torch.randn(shape, generator=generator, device=device, dtype=dt)
        return x.mul_(fan_in ** -0.5)   # in place: no second copy

    layers = LayerParams(
        wq=w((n, h, hq), h),
        wk=w((n, h, hkv), h),
        wv=w((n, h, hkv), h),
        wo=w((n, hq, h), hq),
        w_gate=w((n, h, inter), h),
        w_up=w((n, h, inter), h),
        w_down=w((n, inter, h), inter),
        ln_attn=torch.ones((n, h), dtype=dt, device=device),
        ln_mlp=torch.ones((n, h), dtype=dt, device=device),
    )
    embed = w((config.vocab_size, h), h)
    lm_head = embed.T if config.tie_word_embeddings else w((h, config.vocab_size), h)
    cos, sin = rope_cos_sin(config, max_len, device=device)
    return LlamaParams(embed=embed, lm_head=lm_head,
                       final_ln=torch.ones((h,), dtype=dt, device=device),
                       layers=layers, cos=cos, sin=sin)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w)


def qkv_proj(lp: LayerParams, config: ModelConfig, hidden: torch.Tensor,
             positions: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """RMSNorm + QKV projection + RoPE for one layer.

    hidden: [B, S, h]; positions: [B, S].
    Returns q [B, S, Hq, d], k [B, S, Hkv, d], v [B, S, Hkv, d].
    """
    b, s, _ = hidden.shape
    d = config.head_dim
    x = rms_norm(hidden, lp.ln_attn, config.rms_norm_eps)
    q = linear(x, lp.wq).reshape(b, s, config.num_attention_heads, d)
    k = linear(x, lp.wk).reshape(b, s, config.num_key_value_heads, d)
    v = linear(x, lp.wv).reshape(b, s, config.num_key_value_heads, d)
    return apply_rope(q, cos, sin, positions), apply_rope(k, cos, sin, positions), v


def post_attention(lp: LayerParams, config: ModelConfig,
                   attn_out: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """o_proj + residual + MLP block. attn_out: [B, S, Hq*d]; residual:
    [B, S, h]."""
    hidden = residual + linear(attn_out.to(residual.dtype), lp.wo)
    x = rms_norm(hidden, lp.ln_mlp, config.rms_norm_eps)
    g, u = linear(x, lp.w_gate), linear(x, lp.w_up)
    gate = F.silu(g.float()).to(x.dtype)
    return hidden + linear(gate * u.to(x.dtype), lp.w_down)


def unembed(params: LlamaParams, config: ModelConfig,
            hidden: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head. hidden: [B, h] -> f32 logits [B, V]."""
    x = rms_norm(hidden, params.final_ln, config.rms_norm_eps)
    return linear(x, params.lm_head).float()

"""Rotary position embeddings (Llama NEOX-style rotate-half) with llama3
frequency scaling (port of `magicpig_tpu/ops/rope.py`)."""

from __future__ import annotations

import math

import torch

from magicpig_tpu_torch.config import ModelConfig, RopeScaling


def _scaled_inv_freq(inv_freq: torch.Tensor,
                     scaling: RopeScaling) -> torch.Tensor:
    """HF `_compute_llama3_parameters`: piecewise frequency rescale."""
    low_wavelen = scaling.original_max_position_embeddings / scaling.low_freq_factor
    high_wavelen = scaling.original_max_position_embeddings / scaling.high_freq_factor
    wavelen = 2.0 * math.pi / inv_freq
    scaled = inv_freq / scaling.factor
    smooth = (scaling.original_max_position_embeddings / wavelen
              - scaling.low_freq_factor) / (
        scaling.high_freq_factor - scaling.low_freq_factor)
    mid = (1.0 - smooth) * scaled + smooth * inv_freq
    out = torch.where(wavelen > low_wavelen, scaled, inv_freq)
    return torch.where((wavelen <= low_wavelen) & (wavelen >= high_wavelen),
                       mid, out)


def rope_cos_sin(config: ModelConfig, max_len: int,
                 device: torch.device | str = "cuda"):
    """float32 (cos, sin) caches of shape [max_len, head_dim]."""
    d = config.head_dim
    exponent = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    inv_freq = 1.0 / (config.rope_theta ** exponent)
    if (config.rope_scaling is not None
            and config.rope_scaling.rope_type == "llama3"):
        inv_freq = _scaled_inv_freq(inv_freq, config.rope_scaling)
    pos = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(pos, inv_freq)                # [max_len, d/2]
    emb = torch.cat([freqs, freqs], dim=-1)           # [max_len, d]
    return torch.cos(emb), torch.sin(emb)


def rope_rows(cos: torch.Tensor, sin: torch.Tensor, positions: torch.Tensor):
    """The cos / sin rows [..., S, 1, d] at `positions` [..., S]. Positions
    past the table read its last row, as the JAX gather clamps: an idle
    slot's position keeps growing with every batched decode step."""
    positions = positions.clamp(max=cos.shape[0] - 1)
    return cos[positions].unsqueeze(-2), sin[positions].unsqueeze(-2)


def rotate(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE of x [..., S, H, d] by the rows of `rope_rows`."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    rotated = torch.cat([-x2, x1], dim=-1)
    return (x.float() * c + rotated.float() * s).to(x.dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """x: [..., S, H, d]; positions: [..., S] int; cos/sin: [max_len, d]."""
    return rotate(x, *rope_rows(cos, sin, positions))

"""RMSNorm (port of `magicpig_tpu/ops/norms.py`)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS layer norm in float32, cast back to x.dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)

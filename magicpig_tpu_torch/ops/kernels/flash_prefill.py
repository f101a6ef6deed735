"""Causal flash prefill: wrapper of the hand-written kernel
`csrc/flash_prefill.cu`, with its plain version `ops.attention.flash_prefill`.

Replaces the TPU kernel `magicpig_tpu/ops/pallas/prefill.py::
flash_prefill_pallas` (pallas_call at prefill.py:249). On the H100 the work
is bound by tensor-core operations (~275 GFLOP per layer for an 8K prompt at
Llama-3.2-1B width, twice that at Llama-3.1-8B's head dim 128), so the
kernel runs its products on warpgroup MMAs (wgmma) fed by TMA copies
through a ring of shared memory, with the score and output tiles in
registers; see the source for the design. Head dims 64 and 128 are
instances of one template, counted apart ("flash_prefill",
"flash_prefill_d128": `launch_name`).
"""

from __future__ import annotations

import math

import torch

from magicpig_tpu_torch.ops import attention
from magicpig_tpu_torch.ops.kernels import _lib

HEAD_DIMS = (64, 128)  # the kernel's head dims


def launch_name(head_dim: int) -> str:
    """The launch counter of the form for `head_dim`."""
    return "flash_prefill" + ("" if head_dim == 64 else f"_d{head_dim}")


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  length: torch.Tensor, q_offset: torch.Tensor | None = None,
                  window: int | None = None, return_lse: bool = False):
    """Causal attention of a query span against the KV prefix.

    q: [B, Sq, Hq, d] at absolute positions q_offset[b] + i; k, v:
    [B, Skv, Hkv, d]; length: [B] int32 valid keys; q_offset: [B] int32 or
    None; window: query t sees keys in (t - window, t], or None. Returns
    out [B, Sq, Hq, d] in q.dtype, plus lse [B, Sq, Hq] f32 when return_lse.
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if q.device.type == "cpu":
        return attention.flash_prefill(q, k, v, length, q_offset=q_offset,
                                       window=window, return_lse=return_lse)
    b, sq, hq, d = q.shape
    name = launch_name(d)
    _lib.require(q.device.type == "cuda", f"{name}: unsupported device {q.device}")
    skv, hkv = k.shape[1], k.shape[2]
    if q_offset is None:
        q_offset = torch.zeros((b,), dtype=torch.int32, device=q.device)
    _lib.require_cuda(name, q, k, v, length, q_offset)
    _lib.require(q.dtype == k.dtype == v.dtype == torch.bfloat16,
                 f"{name}: q, k, v must be bfloat16")
    _lib.require(d in HEAD_DIMS, f"{name}: head_dim {d} not in {HEAD_DIMS}")
    _lib.require(k.shape == v.shape == (b, skv, hkv, d),
                 f"{name}: k/v shape {tuple(k.shape)}")
    _lib.require(hkv > 0 and hq % hkv == 0,
                 f"{name}: group size {hq}/{hkv} unsupported")
    _lib.require(sq > 0, f"{name}: empty query span")
    _lib.require(length.dtype == q_offset.dtype == torch.int32
                 and length.shape == q_offset.shape == (b,),
                 f"{name}: length and q_offset must be int32 [B]")
    _lib.require(window is None or window > 0, f"{name}: window must be > 0")
    out = torch.empty_like(q)
    lse = (torch.empty((b, sq, hq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    _lib.launch(name, "mp_flash_prefill", q.device, q, k, v, length,
                q_offset, out, lse, b, sq, skv, hq, hkv, d, window or 0,
                1.0 / math.sqrt(d))
    return (out, lse) if return_lse else out

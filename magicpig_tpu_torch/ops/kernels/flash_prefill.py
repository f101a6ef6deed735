"""Causal flash prefill: wrapper of the hand-written kernel
`csrc/flash_prefill.cu`, with its plain version `ops.attention.flash_prefill`.

Replaces the TPU kernel `magicpig_tpu/ops/pallas/prefill.py::
flash_prefill_pallas` (pallas_call at prefill.py:249). On the H100 the work
is bound by tensor-core operations (~275 GFLOP per layer for an 8K prompt at
Llama-3.2-1B width, twice that at Llama-3.1-8B's head dim 128), so the
kernel runs its products on warpgroup MMAs (wgmma) fed by TMA copies
through a ring of shared memory, with the score and output tiles in
registers; see the source for the design. Head dims 16, 32, 64 and 128
are instances of one template, counted apart ("flash_prefill",
"flash_prefill_d16", "_d32", "_d128": `launch_name`); any group size.

Training differentiates through `FlashPrefillTrain`, the port's form of
JAX's custom VJP `_flash_prefill_train` (`magicpig_tpu/ops/attention.py`):
on the card its forward is this kernel with its LSE and its backward the
hand-written `csrc/flash_prefill_bwd.cu` (`flash_prefill_bwd`: wgmma on
TMA tiles, as the forward; head dims 16, 32, 64 and 128, any group size,
counted as "flash_prefill_bwd", "_d16", "_d32", "_d128":
`bwd_launch_name`), both on bf16 copies of q, k, v and dO with f32 sums,
as the TPU ran the JAX package's f32 products at bf16 precision; on the CPU
both directions are the plain versions in `ops.attention`.
"""

from __future__ import annotations

import math

import torch

from magicpig_tpu_torch.ops import attention
from magicpig_tpu_torch.ops.kernels import _lib


def launch_name(head_dim: int) -> str:
    """The launch counter of the form for `head_dim`."""
    return "flash_prefill" + ("" if head_dim == 64 else f"_d{head_dim}")


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  length: torch.Tensor, q_offset: torch.Tensor | None = None,
                  window: int | None = None, return_lse: bool = False,
                  sm_scale: float | None = None, differentiable: bool = False,
                  block_k: int = 1024):
    """Causal attention of a query span against the KV prefix.

    q: [B, Sq, Hq, d] at absolute positions q_offset[b] + i; k, v:
    [B, Skv, Hkv, d]; length: [B] int32 valid keys; q_offset: [B] int32 or
    None; window: query t sees keys in (t - window, t], or None; sm_scale:
    None for 1 / sqrt(d). Returns out [B, Sq, Hq, d] in q.dtype, plus lse
    [B, Sq, Hq] f32 when return_lse. CPU tensors take the plain version;
    CUDA tensors launch the kernel. With `differentiable` (and not
    return_lse), as JAX's `flash_prefill` routes it: `flash_prefill_train`
    (skv a multiple of block_k, or ValueError).
    """
    if differentiable and not return_lse:
        return flash_prefill_train(q, k, v, 0 if q_offset is None else q_offset,
                                   length, block_k=block_k, sm_scale=sm_scale,
                                   window=window)
    if q.device.type == "cpu":
        return attention.flash_prefill(q, k, v, length, q_offset=q_offset,
                                       window=window, return_lse=return_lse,
                                       sm_scale=sm_scale)
    b, sq, hq, d = q.shape
    name = launch_name(d)
    _lib.require(q.device.type == "cuda", f"{name}: unsupported device {q.device}")
    skv, hkv = k.shape[1], k.shape[2]
    if q_offset is None:
        q_offset = torch.zeros((b,), dtype=torch.int32, device=q.device)
    _lib.require_cuda(name, q, k, v, length, q_offset)
    _lib.require(q.dtype == k.dtype == v.dtype == torch.bfloat16,
                 f"{name}: q, k, v must be bfloat16")
    _lib.require(k.shape == v.shape == (b, skv, hkv, d),
                 f"{name}: k/v shape {tuple(k.shape)}")
    _lib.check_group(name, hq, hkv, d)
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
                1.0 / math.sqrt(d) if sm_scale is None else sm_scale)
    return (out, lse) if return_lse else out


def bwd_launch_name(head_dim: int) -> str:
    """The backward kernel's launch counter for `head_dim`."""
    return "flash_prefill_bwd" + ("" if head_dim == 64 else f"_d{head_dim}")


# The backward kernel pads the query span to tiles of this many rows in its
# [2, B, Hq, Sq padded] f32 scratch (lse in log2 units, then delta).
BWD_PAD = 128


def _int32_batch(x, b: int, device: torch.device) -> torch.Tensor:
    """An int, or a [B] (or 0-d) tensor, as a contiguous int32 [B]."""
    return attention.per_batch(x, b, device).to(torch.int32).contiguous()


def flash_prefill_bwd_plain(q, k, v, out, lse, do, q_offset, kv_len,
                            window: int | None = None,
                            sm_scale: float | None = None,
                            block_k: int | None = None):
    """The plain version of `flash_prefill_bwd` on any device: f32 (dq, dk,
    dv), `block_k` keys a step (None: all)."""
    grads = attention.flash_prefill_train_backward(
        q, k, v, out, lse, do, q_offset, kv_len, block_k or k.shape[1],
        sm_scale=sm_scale, window=window)
    return tuple(g.float() for g in grads)


def flash_prefill_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                      q_offset, kv_len, window: int | None = None,
                      sm_scale: float | None = None,
                      block_k: int | None = None):
    """(dq, dk, dv) in f32 of the training attention's output `out` with
    its lse [B, Sq, Hq] f32, for dL/d out `do`. q, out, do: [B, Sq, Hq,
    d]; k, v: [B, Skv, Hkv, d]; q_offset, kv_len: int or [B]. CUDA tensors
    launch the kernel (bf16 inputs, a head dim of `_lib.HEAD_DIMS`, any
    group size; ValueError otherwise, before any launch); CPU tensors take
    the plain version (`flash_prefill_bwd_plain`)."""
    if q.device.type == "cpu":
        return flash_prefill_bwd_plain(q, k, v, out, lse, do, q_offset,
                                       kv_len, window, sm_scale, block_k)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dev = q.device
    name = bwd_launch_name(d)
    _lib.require(dev.type == "cuda", f"{name}: unsupported device {dev}")
    _lib.check_group(name, hq, hkv, d)
    _lib.require(k.shape == v.shape == (b, skv, hkv, d),
                 f"{name}: k/v shape {tuple(k.shape)}")
    _lib.require(out.shape == do.shape == q.shape,
                 f"{name}: out/do shape {tuple(out.shape)}")
    _lib.require(lse.shape == (b, sq, hq) and lse.dtype == torch.float32,
                 f"{name}: lse must be float32 [B, Sq, Hq]")
    _lib.require(all(x.dtype == torch.bfloat16 for x in (q, k, v, out, do)),
                 f"{name}: q, k, v, out, do must be bfloat16")
    _lib.require(sq > 0 and skv > 0, f"{name}: empty query or key span")
    _lib.require(window is None or window > 0, f"{name}: window must be > 0")
    off, length = _int32_batch(q_offset, b, dev), _int32_batch(kv_len, b, dev)
    _lib.require_cuda(name, q, k, v, out, do, lse, off, length)
    scratch = torch.empty((2, b, hq, -(-sq // BWD_PAD) * BWD_PAD),
                          dtype=torch.float32, device=dev)
    dq = torch.empty(q.shape, dtype=torch.float32, device=dev)
    dk = torch.empty(k.shape, dtype=torch.float32, device=dev)
    dv = torch.empty(k.shape, dtype=torch.float32, device=dev)
    _lib.launch(name, "mp_flash_prefill_bwd", dev, q, k, v, out, do, lse,
                length, off, scratch, dq, dk, dv, b, sq, skv, hq, hkv, d,
                window or 0, 1.0 / math.sqrt(d) if sm_scale is None
                else sm_scale)
    return dq, dk, dv


class FlashPrefillTrain(torch.autograd.Function):
    """The training attention with its FlashAttention-2 gradient (JAX's
    custom VJP `_flash_prefill_train`). apply(q, k, v, q_offset, kv_len,
    block_k, sm_scale, window): q [B, Sq, Hq, d], k, v [B, Skv, Hkv, d];
    q_offset, kv_len int or [B]; skv must be a multiple of block_k
    (ValueError, as JAX's backward raises; here before the forward runs).
    On the card: the flash_prefill kernel with its LSE forward and the
    flash_prefill_bwd kernel backward, on bf16 copies of q, k, v and dO,
    `out` in q's dtype and each gradient in its input's; on the CPU the
    plain versions in the inputs' own dtype. block_k sets the plain
    versions' step; the kernels' tiles are their own."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, kv_len, block_k, sm_scale, window):
        attention.check_train_blocks(k.shape[1], block_k)
        ctx.args = (block_k, sm_scale, window)
        ctx.dtypes = (q.dtype, k.dtype, v.dtype)
        if q.device.type == "cpu":
            out, lse = attention.flash_prefill_train_forward(
                q, k, v, q_offset, kv_len, block_k, sm_scale, window)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.positions = (q_offset, kv_len)
            return out
        b = q.shape[0]
        off = _int32_batch(q_offset, b, q.device)
        length = _int32_batch(kv_len, b, q.device)
        qb, kb, vb = (x.to(torch.bfloat16).contiguous() for x in (q, k, v))
        out, lse = flash_prefill(qb, kb, vb, length, q_offset=off,
                                 window=window, return_lse=True,
                                 sm_scale=sm_scale)
        ctx.save_for_backward(qb, kb, vb, out, lse)
        ctx.positions = (off, length)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        block_k, sm_scale, window = ctx.args
        if do.device.type != "cpu":
            do = do.to(torch.bfloat16).contiguous()
        grads = flash_prefill_bwd(*ctx.saved_tensors, do, *ctx.positions,
                                  window=window, sm_scale=sm_scale,
                                  block_k=block_k)
        dq, dk, dv = (g.to(dt) for g, dt in zip(grads, ctx.dtypes))
        return dq, dk, dv, None, None, None, None, None


def flash_prefill_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_offset, kv_len, block_k: int = 1024,
                        sm_scale: float | None = None,
                        window: int | None = None) -> torch.Tensor:
    """`FlashPrefillTrain.apply` with JAX's keyword defaults."""
    return FlashPrefillTrain.apply(q, k, v, q_offset, kv_len, block_k,
                                   sm_scale, window)

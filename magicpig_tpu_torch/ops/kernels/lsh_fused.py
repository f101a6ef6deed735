"""Fused LSH-sampled decode: wrapper of the hand-written kernel
`csrc/lsh_fused.cu`, with its plain version (`ops.bitcodes.sampled_mask`
then `ops.attention.lsh_masked_decode`).

Replaces the TPU kernel `magicpig_tpu/ops/pallas/lsh_fused.py::
lsh_fused_attention2` (pallas_call at lsh_fused.py:286), reached through
`magicpig_tpu/ops/pallas/lsh_decode.py::lsh_fused_decode`: bf16 K/V, or
int8 K/V with per-token f32 scales (int4-grid K too), each with the exact,
polynomial or no debias. The forms are counted apart: "lsh_fused_decode",
with "_int8" for int8 K/V and "_poly" or "_none" for those debias forms
(`launch_name`). On the H100 it is bound by device memory: every
signature word must be read (188 bytes per token and kv head at K=10,
L=150), but K, V and the key norm only for the tokens some head of the
group samples, and the kernel reads only those.
"""

from __future__ import annotations

import ctypes
import math

import torch

from magicpig_tpu_torch.ops import attention, bitcodes
from magicpig_tpu_torch.ops.debias import DEBIAS_FORMS, log_weight_poly
from magicpig_tpu_torch.ops.kernels import _lib
from magicpig_tpu_torch.ops.kernels.flash_decode import (
    SPLIT_TOKENS,
    check_decode_inputs,
)

MAX_QCODE_BYTES = 12 * 1024   # dynamic shared memory for the query codes
MAX_K = 16                    # bits per table (kMaxK in lsh_fused.cu)


def launch_name(quant: bool, debias: str) -> str:
    """The launch counter of one form: "lsh_fused_decode", "_int8" for int8
    K/V, then "_poly" or "_none" for those debias forms."""
    return ("lsh_fused_decode" + ("_int8" if quant else "")
            + ("" if debias == "exact" else f"_{debias}"))


def lsh_fused_decode_plain(q, k_centered, v, k_norm, planes, q_bits, length,
                           K: int, L: int, k_scale=None, v_scale=None,
                           debias: str = "exact"):
    """Plain version: the collision mask, then the masked debiased decode."""
    mask = bitcodes.sampled_mask(q_bits, planes, length)
    out, lse = attention.lsh_masked_decode(q, k_centered, v, k_norm, mask,
                                           length, K, L, k_scale, v_scale,
                                           debias)
    return out, lse, mask.sum(dim=-1).to(torch.float32)


def lsh_fused_decode(q: torch.Tensor, k_centered: torch.Tensor,
                     v: torch.Tensor, k_norm: torch.Tensor,
                     planes: torch.Tensor, q_bits: torch.Tensor,
                     length: torch.Tensor, K: int, L: int,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None,
                     debias: str = "exact"):
    """LSH-sampled decode partial over the offload region.

    q: [B, Hq, d]; k_centered, v: [B, Hkv, S, d], bf16, or int8 with f32
    scales k_scale, v_scale [B, Hkv, S]; k_norm: [B, Hkv, S] f32 (norms of
    the dequantized keys for int8); planes: [B, Hkv, L, K, S/32] int32
    (`ops.bitcodes` flat layout); q_bits: [B, Hq, L, K] int32 0/1; length:
    [B] int32; debias: "exact", "poly" or "none" (`ops/debias.py`).
    Returns (out [B, Hq, d] f32, lse [B, Hq] f32, sampled count [B, Hq]
    f32). CPU tensors take the plain version.
    """
    if q.device.type == "cpu":
        return lsh_fused_decode_plain(q, k_centered, v, k_norm, planes,
                                      q_bits, length, K, L, k_scale, v_scale,
                                      debias)
    _lib.require(debias in DEBIAS_FORMS, f"unknown debias form {debias!r}")
    name = launch_name(k_scale is not None, debias)
    check_decode_inputs(name, q, k_centered, v, length, k_scale, v_scale)
    b, hq, d = q.shape
    hkv, s = k_centered.shape[1], k_centered.shape[2]
    _lib.require_cuda(name, q, k_norm, planes, q_bits)
    _lib.require(k_norm.dtype == torch.float32 and k_norm.shape == (b, hkv, s),
                 f"{name}: k_norm must be f32 [B, Hkv, S]")
    _lib.require(planes.dtype == torch.int32
                 and planes.shape == (b, hkv, L, K, s // 32) and s % 32 == 0,
                 f"{name}: planes must be int32 [B, Hkv, L, K, S/32]")
    _lib.require(q_bits.dtype == torch.int32 and q_bits.shape == (b, hq, L, K),
                 f"{name}: q_bits must be int32 [B, Hq, L, K]")
    _lib.require(1 <= K <= MAX_K and L >= 1
                 and (hq // hkv) * L * 4 <= MAX_QCODE_BYTES,
                 f"{name}: K={K}, L={L} unsupported")
    nsplit = -(-s // SPLIT_TOKENS)
    f32 = dict(dtype=torch.float32, device=q.device)
    part_o = torch.empty((nsplit, b * hq, d), **f32)
    part_lse = torch.empty((nsplit, b * hq), **f32)
    part_cnt = torch.empty((nsplit, b * hq), **f32)
    out = torch.empty((b, hq, d), **f32)
    lse = torch.empty((b, hq), **f32)
    cnt = torch.empty((b, hq), **f32)
    coef = None
    if debias == "poly":   # copied by value into the launch's arguments
        poly = log_weight_poly(K, L)
        coef = (ctypes.c_float * len(poly))(*poly)
    _lib.launch(name, "mp_lsh_fused_decode", q.device, q, k_centered, v,
                k_scale, v_scale, k_norm, planes, q_bits, length, part_o,
                part_lse, part_cnt, out, lse, cnt, b, s, hq, hkv, d, K, L,
                1.0 / math.sqrt(d), DEBIAS_FORMS.index(debias),
                None if coef is None else ctypes.addressof(coef))
    return out, lse, cnt

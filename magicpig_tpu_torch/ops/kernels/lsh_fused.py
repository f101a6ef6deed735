"""Fused LSH-sampled decode: wrapper of the hand-written kernel
`csrc/lsh_fused.cu`, with its plain version (`ops.bitcodes.sampled_mask`
then `ops.attention.lsh_masked_decode`), and `lsh_decode`, which routes the
masked decode between it and the two-stage kernels as the JAX package
routes it.

Replaces the TPU kernel `magicpig_tpu/ops/pallas/lsh_fused.py::
lsh_fused_attention2` (pallas_call at lsh_fused.py:286), reached through
`magicpig_tpu/ops/pallas/lsh_decode.py::lsh_fused_decode`: bf16 K/V, or
int8 K/V with per-token f32 scales (int4-grid K too), each with the exact,
polynomial or no debias, at head dims 16, 32, 64 and 128 and any group
size. The forms are counted apart: "lsh_fused_decode", with "_int8" for
int8 K/V, "_poly" or "_none" for those debias forms, "_d<d>" at a head dim
other than 64 and "_g<G>" at a group size of the kernel's general tile
(`launch_name`). On the H100 it is bound by device memory: every
signature word must be read (188 bytes per token and kv head at K=10,
L=150), but K, V and the key norm only for the tokens some head of the
group samples, and the kernel reads only those.
"""

from __future__ import annotations

import torch

from magicpig_tpu_torch.ops import attention, bitcodes
from magicpig_tpu_torch.ops.kernels.collision_words import (
    check_scan_inputs,
    collision_words,
)
from magicpig_tpu_torch.ops.kernels.flash_decode import HEAD_DIM
from magicpig_tpu_torch.ops.kernels.lsh_masked import (
    check_attend_inputs,
    form_name,
    group_size,
    launch_attend,
    lsh_masked_attention,
)


def launch_name(quant: bool, debias: str, head_dim: int = HEAD_DIM,
                group: int = 1) -> str:
    """The launch counter of one form: "lsh_fused_decode", "_int8" for int8
    K/V, then "_poly" or "_none" for those debias forms, "_d128" at head
    dim 128, "_g6" at group size 6, ... (`form_name`)."""
    return form_name("lsh_fused_decode", quant, debias, head_dim, group)


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
    """LSH-sampled decode partial over the offload region, scan included
    (any L).

    q: [B, Hq, d]; k_centered, v: [B, Hkv, S, d], bf16, or int8 with f32
    scales k_scale, v_scale [B, Hkv, S] (d 16, 32, 64 or 128 on the card,
    Hq any multiple of Hkv); k_norm:
    [B, Hkv, S] f32 (norms of
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
    quant = k_scale is not None
    name = launch_name(quant, debias, q.shape[-1], group_size(q, k_centered))
    check_attend_inputs(name, q, k_centered, v, k_norm, length, k_scale,
                        v_scale, debias)
    check_scan_inputs(name, planes, q_bits, k_centered.shape[1],
                      k_centered.shape[2], K, L)
    return launch_attend(name, "mp_lsh_fused_decode", q, k_centered, v,
                         k_scale, v_scale, k_norm, (planes, q_bits), length,
                         K, L, debias)


def lsh_decode(q: torch.Tensor, k_centered: torch.Tensor, v: torch.Tensor,
               k_norm: torch.Tensor, planes: torch.Tensor,
               q_bits: torch.Tensor, length: torch.Tensor, K: int, L: int,
               k_scale: torch.Tensor | None = None,
               v_scale: torch.Tensor | None = None, debias: str = "exact"):
    """The masked LSH partial, routed as the JAX package's
    `lsh_decode.py::lsh_fused_decode` routes it: even L through the fused
    kernel; odd L (and L = 1) in two stages, the collision words
    (`collision_words`), then the masked attend (`lsh_masked_attention`,
    which ignores the bits at or past the length; the scan reads none of
    them). The fused kernel itself takes any L; which route odd L should
    keep is for a measurement to decide. Arguments and result as
    `lsh_fused_decode`."""
    if L >= 2 and L % 2 == 0:
        return lsh_fused_decode(q, k_centered, v, k_norm, planes, q_bits,
                                length, K, L, k_scale, v_scale, debias)
    return lsh_masked_attention(q, k_centered, v, k_norm,
                                collision_words(q_bits, planes, length), length,
                                K, L, k_scale, v_scale, debias)

"""Two-stage LSH-sampled decode, stage 2: wrapper of the hand-written kernel
`csrc/lsh_masked.cu`, with its plain version (`ops.bitcodes.unpack_words`
then `ops.attention.lsh_masked_decode`), and the launch steps it shares
with the fused kernel's wrapper (`lsh_fused.py`).

Replaces the TPU kernel `magicpig_tpu/ops/pallas/lsh_decode.py::
lsh_masked_attention` (pallas_call at lsh_decode.py:271), the attend of the
two-stage route that `lsh_fused.lsh_decode` takes for odd L: bf16 K/V, or
int8 K/V with per-token f32 scales, each with the exact, poly or no
debias, at head dims 16, 32, 64 and 128 and any group size, counted as
"lsh_masked_attention", "_int8" for int8 K/V, then "_poly" or "_none", then
"_d<d>" at a head dim other than 64 and "_g<G>" at a group size of the
kernel's general tile (`flash_decode.head_suffix`). The
TPU kernel reads a [B, Hq, S] int8 mask; this one reads the packed
collision words [B, Hq, S/32] int32 that stage 1 writes
(`collision_words.py`), 8x fewer bytes. On the H100 it is bound by device
memory: the words, and K, V and the key norm of the rows some head of the
group sampled, which alone it gathers; the splits merge in the same launch
(merge tickets per device, as flash decode's).
"""

from __future__ import annotations

import ctypes
import math

import torch

from magicpig_tpu_torch.ops import attention, bitcodes
from magicpig_tpu_torch.ops.debias import DEBIAS_FORMS, log_weight_poly
from magicpig_tpu_torch.ops.kernels import _lib
from magicpig_tpu_torch.ops.kernels.flash_decode import (
    HEAD_DIM,
    check_decode_inputs,
    head_suffix,
    tickets_for,
)

# Tokens a block of both LSH kernels, by the bytes of a gathered K row (d
# times the K/V type's size): a power of two from 32 to 2048.
# `chip_smoke.py` phase 2 times 512, 1024 and 2048 (`PERF.md`): 512 is
# fastest for rows of 64 and 128 bytes (int8 and bf16 at d = 64, int8 at
# d = 128), 1024 for bf16 at d = 128 (256-byte rows: a block takes ~100 KB
# of shared memory, two a SM, and 1024-token splits make one wave). The
# narrower rows of head dims 16 and 32 (16 to 64 bytes) take 512 too.
LSH_SPLIT = {16: 512, 32: 512, 64: 512, 128: 512, 256: 1024}


def form_name(base: str, quant: bool, debias: str,
              head_dim: int = HEAD_DIM, group: int = 1) -> str:
    """The launch counter of one form of an LSH kernel: `base`, "_int8"
    for int8 K/V, then "_poly" or "_none" for those debias forms, then
    `head_suffix` ("_d128" at head dim 128, "_g6" at group size 6, ...)."""
    return (base + ("_int8" if quant else "")
            + ("" if debias == "exact" else f"_{debias}")
            + head_suffix(head_dim, group))


def launch_name(quant: bool, debias: str, head_dim: int = HEAD_DIM,
                group: int = 1) -> str:
    return form_name("lsh_masked_attention", quant, debias, head_dim, group)


def group_size(q: torch.Tensor, k: torch.Tensor) -> int:
    """Query heads a kv head (0 where the shapes do not say: the checks
    then raise)."""
    hkv = k.shape[1] if k.dim() == 4 else 0
    return q.shape[1] // hkv if hkv else 0


def check_attend_inputs(name: str, q, k_centered, v, k_norm, length,
                        k_scale, v_scale, debias: str) -> None:
    """The checks both LSH kernels make of what they attend over: decode
    inputs (`check_decode_inputs`), the key norms f32 [B, Hkv, S] on the
    card, S whole words, a known debias form."""
    _lib.require(debias in DEBIAS_FORMS, f"unknown debias form {debias!r}")
    check_decode_inputs(name, q, k_centered, v, length, k_scale, v_scale)
    b, hkv, s = k_centered.shape[:3]
    _lib.require_cuda(name, q, k_norm)
    _lib.require(k_norm.dtype == torch.float32 and k_norm.shape == (b, hkv, s)
                 and s % bitcodes.WORD == 0,
                 f"{name}: k_norm must be f32 [B, Hkv, S], S a multiple of 32")


def launch_attend(name: str, entry: str, q, k_centered, v, k_scale, v_scale,
                  k_norm, selection: tuple, length, K: int, L: int,
                  debias: str, split: int | None = None):
    """Allocate the split partials and outputs, and launch `entry` with
    `selection` (the scan's planes and q_bits, or the words) between the
    norms and the length, `split` tokens a block (`LSH_SPLIT` of the K
    row's bytes by default). Returns (out, lse, count)."""
    b, hq, d = q.shape
    split = split or LSH_SPLIT[d * k_centered.element_size()]
    hkv, s = k_centered.shape[1], k_centered.shape[2]
    nsplit = -(-s // split)
    tickets, _ = tickets_for(q.device, b, hq, hkv, d, _lib.HEAD_TILE)
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
    _lib.launch(name, entry, q.device, q, k_centered, v, k_scale, v_scale,
                k_norm, *selection, length, part_o, part_lse, part_cnt,
                tickets, out, lse, cnt, b, s, hq, hkv, d, K, L, split,
                1.0 / math.sqrt(d), DEBIAS_FORMS.index(debias),
                None if coef is None else ctypes.addressof(coef))
    return out, lse, cnt


def lsh_masked_attention_plain(q, k_centered, v, k_norm, words, length,
                               K: int, L: int, k_scale=None, v_scale=None,
                               debias: str = "exact"):
    """Plain version: the words unpacked to a mask of the valid tokens, then
    the masked debiased decode; the count is the mask's."""
    s = k_centered.shape[2]
    words = words & bitcodes.valid_words(length, s // bitcodes.WORD)[:, None]
    mask = bitcodes.unpack_words(words, s)
    out, lse = attention.lsh_masked_decode(q, k_centered, v, k_norm, mask,
                                           length, K, L, k_scale, v_scale,
                                           debias)
    return out, lse, mask.sum(dim=-1).to(torch.float32)


def lsh_masked_attention(q: torch.Tensor, k_centered: torch.Tensor,
                         v: torch.Tensor, k_norm: torch.Tensor,
                         words: torch.Tensor, length: torch.Tensor, K: int,
                         L: int, k_scale: torch.Tensor | None = None,
                         v_scale: torch.Tensor | None = None,
                         debias: str = "exact"):
    """LSH-sampled decode partial over the offload region from precomputed
    collision words.

    q: [B, Hq, d]; k_centered, v: [B, Hkv, S, d], bf16, or int8 with f32
    scales k_scale, v_scale [B, Hkv, S]; k_norm: [B, Hkv, S] f32; words:
    [B, Hq, S/32] int32, bit j of word w set iff token 32w + j is sampled
    for that head (bits at or past `length` are ignored); d 16, 32, 64 or
    128 on the card; length: [B] int32;
    debias: "exact", "poly" or "none" (`ops/debias.py`). Returns (out
    [B, Hq, d] f32, lse [B, Hq] f32, sampled count [B, Hq] f32). CPU tensors
    take the plain version.
    """
    if q.device.type == "cpu":
        return lsh_masked_attention_plain(q, k_centered, v, k_norm, words,
                                          length, K, L, k_scale, v_scale,
                                          debias)
    name = launch_name(k_scale is not None, debias, q.shape[-1],
                       group_size(q, k_centered))
    check_attend_inputs(name, q, k_centered, v, k_norm, length, k_scale,
                        v_scale, debias)
    b, hq = q.shape[:2]
    s = k_centered.shape[2]
    _lib.require_cuda(name, q, words)
    _lib.require(words.dtype == torch.int32
                 and words.shape == (b, hq, s // bitcodes.WORD),
                 f"{name}: words must be int32 [B, Hq, S/32]")
    _lib.require(K >= 1 and L >= 1, f"{name}: K={K}, L={L} unsupported")
    return launch_attend(name, "mp_lsh_masked_attention", q, k_centered, v,
                         k_scale, v_scale, k_norm, (words,), length, K, L,
                         debias)

"""Attention over the selected blocks with their scores recomputed from K
(the block_topk rescore pipeline): wrapper of the hand-written kernel
`csrc/rescore_attend.cu`, with its plain version `rescore_attend_plain`.

Replaces the TPU kernel `magicpig_tpu/ops/pallas/rescore_attend.py::
rescore_attend` (pallas_call at rescore_attend.py:217). The ranking pass
(`block_rank`) stores only block maxes; this kernel scores the selected
blocks again with the scorer's own per-token function, so the two agree
bit for bit, and attends over them. K is bf16, int8, or packed int4
(`ops/pack4.py`, counted apart as "rescore_attend_int4", at head dims 64
and 128) with int8 V, at head dims 16, 32, 64 and 128 and any group size
(counted apart with "_d<d>" and "_g<G>", `block_score.launch_name`). On the
H100 it is bound by reading the selected blocks' K and V rows and scales
once; one CUDA block takes a chunk of `chunk` tokens of one selected block
of one (request, kv head) (the general tile: a share of all its selected
blocks for up to 16 query heads), and the chunks merge by LSE in the same
launch (`csrc/chunk_attend.cuh`, shared with `block_attend`).
"""

from __future__ import annotations

import math

import torch

from magicpig_tpu_torch.ops.baselines import gather_blocks
from magicpig_tpu_torch.ops.kernels import _lib
from magicpig_tpu_torch.ops.kernels.block_attend import (
    attend_selected_plain,
    check_selection,
    launch_plan,
)
from magicpig_tpu_torch.ops.kernels.block_score import (
    INT4_HEAD_DIMS,
    KEY_INT4,
    key_kind,
    launch_name,
    token_scores,
)


def rescore_attend_plain(q, blk_ids, k, k_scale, v, v_scale, length,
                         block_size: int):
    """Plain version of `rescore_attend`."""
    b, hkv = k.shape[:2]
    pos = (blk_ids.long().unsqueeze(-1) * block_size
           + torch.arange(block_size, device=k.device)).reshape(b, hkv, -1)
    k_sel = gather_blocks(k, blk_ids, block_size)
    ks_sel = (None if k_scale is None
              else gather_blocks(k_scale, blk_ids, block_size))
    vs_sel = (None if v_scale is None
              else gather_blocks(v_scale, blk_ids, block_size))
    scores = token_scores(q, k_sel, ks_sel, pos, length)
    return attend_selected_plain(scores, gather_blocks(v, blk_ids, block_size),
                                 vs_sel)


def rescore_attend(q: torch.Tensor, blk_ids: torch.Tensor, k: torch.Tensor,
                   k_scale: torch.Tensor | None, v: torch.Tensor,
                   v_scale: torch.Tensor | None, length: torch.Tensor,
                   block_size: int):
    """Attention over the selected blocks, scores recomputed from K.

    q: [B, Hq, d] (raw; scaled as in `block_rank`); blk_ids: [B, Hkv, NB']
    int32; k, v: [B, Hkv, S, d] int8 with k_scale, v_scale [B, Hkv, S] f32,
    or k packed int4 [B, Hkv, S, d/2] with int8 v and both scales, or both
    bf16 with no scales; length: [B] int32 valid tokens. Returns (out
    [B, Hq, d] f32, lse [B, Hq] f32); a row whose selected tokens are all
    past its length gives (0, -inf). CPU tensors take the plain version.
    """
    if q.device.type == "cpu":
        return rescore_attend_plain(q, blk_ids, k, k_scale, v, v_scale,
                                    length, block_size)
    return launch_rescore_attend(q, blk_ids, k, k_scale, v, v_scale, length,
                                 block_size, None)


def launch_rescore_attend(q, blk_ids, k, k_scale, v, v_scale, length,
                          block_size: int, chunk: int | None):
    """One launch of the kernel at `chunk` tokens a CUDA block (None:
    `launch_plan`'s choice), inputs checked: the wrapper's, and the card
    tests' and `chip_smoke.py`'s at each chunk."""
    _lib.require(q.device.type == "cuda",
                 f"rescore_attend: unsupported device {q.device}")
    b, hq, d = q.shape
    kind = key_kind("rescore_attend", q, k, k_scale)
    hkv = k.shape[1]
    name = launch_name("rescore_attend", kind == KEY_INT4, d, hq // hkv)
    _lib.require(v.dim() == 4 and v.shape[:3] == k.shape[:3]
                 and v.shape[3] == d, f"{name}: v shape {tuple(v.shape)}")
    _lib.require(k.dtype == v.dtype, f"{name}: k and v must share a type")
    _lib.require_cuda(name, q, k, length, *([k_scale] if kind else []))
    _lib.require(q.dtype == torch.bfloat16, f"{name}: q must be bfloat16")
    _lib.require(length.dtype == torch.int32 and length.shape == (b,),
                 f"{name}: length must be int32 [B]")
    check_selection(name, blk_ids, v, v_scale, hq, block_size)
    _lib.require(kind != KEY_INT4 or d in INT4_HEAD_DIMS,
                 f"{name}: packed int4 K at head dims {INT4_HEAD_DIMS} only")
    s = k.shape[2]
    nsel = blk_ids.shape[2]
    quant = k_scale is not None
    chunk, (part_o, part_lse, tickets, out, lse) = launch_plan(
        b, hq, hkv, d, nsel, block_size, chunk,
        (k.shape[3] * k.element_size(), d * v.element_size(), quant, quant),
        q.device)
    _lib.launch(name, "mp_rescore_attend",
                q.device, q, blk_ids, k, k_scale, v, v_scale, length, part_o,
                part_lse, tickets, out, lse, b, s, hq, hkv, d, nsel,
                block_size, chunk, kind, 1.0 / math.sqrt(d))
    return out, lse

"""Attention over the selected blocks from stored scores (the block_topk
store pipeline): wrapper of the hand-written kernel `csrc/block_attend.cu`,
with its plain version `block_attend_plain`.

Replaces the TPU kernel `magicpig_tpu/ops/pallas/block_attend.py::
block_attend` (pallas_call at block_attend.py:224). On the H100 it is bound
by reading the selected blocks' scores and V rows once; one block of the
kernel attends one selected block of one (request, kv head), and the LSE
merge of `csrc/flash_decode.cu` combines the partials.

The V scale (int8 V) multiplies the probabilities, not V. The plain version
rounds those products to bf16 before the sum over V when V is bf16 or int8,
as the TPU kernel does; the CUDA kernel keeps them in f32.
"""

from __future__ import annotations

import torch

from magicpig_tpu_torch.ops import attention
from magicpig_tpu_torch.ops.baselines import gather_blocks
from magicpig_tpu_torch.ops.kernels import _lib

HEAD_DIM = 64
MAX_BLOCK_SCORES = 8192   # G * block_size (kMaxBlockScores in block_common.cuh)


def attend_selected_plain(scores: torch.Tensor, v: torch.Tensor,
                          v_scale: torch.Tensor | None):
    """Softmax over scores [B, Hkv, G, N] f32 (-inf masked) and the weighted
    sum of v [B, Hkv, N, d] (row scales v_scale [B, Hkv, N] or None).
    Returns (out [B, Hq, d] f32, lse [B, Hq] f32); a head with no finite
    score gives (0, -inf)."""
    b, hkv, g, _ = scores.shape
    m = scores.amax(dim=-1)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(scores - m_safe.unsqueeze(-1))
    l = p.sum(dim=-1)
    if v_scale is not None:
        p = p * v_scale.unsqueeze(2)
    if v.dtype != torch.float32:
        p = p.to(torch.bfloat16).float()
    out, lse = attention._finish(m_safe, l, torch.matmul(p, v.float()))
    return out.reshape(b, hkv * g, -1), lse.reshape(b, hkv * g)


def block_attend_plain(scores: torch.Tensor, blk_ids: torch.Tensor,
                       v: torch.Tensor, v_scale: torch.Tensor | None,
                       block_size: int):
    """Plain version of `block_attend`."""
    s_sel = gather_blocks(scores.transpose(2, 3), blk_ids,
                          block_size).transpose(2, 3)
    vs_sel = (None if v_scale is None
              else gather_blocks(v_scale, blk_ids, block_size))
    return attend_selected_plain(s_sel, gather_blocks(v, blk_ids, block_size),
                                 vs_sel)


def check_selection(name: str, blk_ids: torch.Tensor, v: torch.Tensor,
                    v_scale: torch.Tensor | None, hq: int,
                    block_size: int) -> None:
    """Checks shared by the two attend kernels."""
    b, hkv, s, d = v.shape
    int8 = v.dtype == torch.int8
    _lib.require_cuda(name, blk_ids, v, *([v_scale] if int8 else []))
    _lib.require(v.dtype in (torch.int8, torch.bfloat16),
                 f"{name}: v must be int8 or bfloat16")
    _lib.require((v_scale is not None) == int8,
                 f"{name}: v_scale goes with int8 V, and only with it")
    _lib.require(not int8 or (v_scale.dtype == torch.float32
                              and v_scale.shape == (b, hkv, s)),
                 f"{name}: v_scale must be f32 [B, Hkv, S]")
    _lib.require(d == HEAD_DIM, f"{name}: head_dim {d} != {HEAD_DIM}")
    _lib.require(hq % hkv == 0 and hq // hkv in (1, 2, 4, 8),
                 f"{name}: group size {hq}/{hkv} unsupported")
    _lib.require(block_size > 0 and block_size % 64 == 0 and s > 0
                 and s % block_size == 0
                 and (hq // hkv) * block_size <= MAX_BLOCK_SCORES,
                 f"{name}: block size {block_size} unsupported for S={s}")
    _lib.require(blk_ids.dtype == torch.int32 and blk_ids.dim() == 3
                 and blk_ids.shape[:2] == (b, hkv) and blk_ids.shape[2] > 0,
                 f"{name}: blk_ids must be int32 [B, Hkv, NB']")


def merge_buffers(nsel: int, b: int, hq: int, device: torch.device):
    """Per-selected-block partials and the merged output of an attend."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((nsel, b * hq, HEAD_DIM), **f32),
            torch.empty((nsel, b * hq), **f32),
            torch.empty((b, hq, HEAD_DIM), **f32),
            torch.empty((b, hq), **f32))


def block_attend(scores: torch.Tensor, blk_ids: torch.Tensor, v: torch.Tensor,
                 v_scale: torch.Tensor | None, block_size: int):
    """Attention over the selected blocks from stored scores.

    scores: [B, Hkv, G, S] f32, scaled and -inf masked (`exact_scores_ranked`);
    blk_ids: [B, Hkv, NB'] int32 block indices; v: [B, Hkv, S, d] bf16, or
    int8 with v_scale [B, Hkv, S] f32. Returns (out [B, Hq, d] f32, lse
    [B, Hq] f32). CPU tensors take the plain version.
    """
    if scores.device.type == "cpu":
        return block_attend_plain(scores, blk_ids, v, v_scale, block_size)
    name = "block_attend"
    _lib.require(scores.device.type == "cuda",
                 f"{name}: unsupported device {scores.device}")
    b, hkv, g, s = scores.shape
    _lib.require(v.dim() == 4 and v.shape[:3] == (b, hkv, s),
                 f"{name}: v shape {tuple(v.shape)}")
    _lib.require_cuda(name, scores, v)
    _lib.require(scores.dtype == torch.float32, f"{name}: scores must be f32")
    check_selection(name, blk_ids, v, v_scale, hkv * g, block_size)
    nsel = blk_ids.shape[2]
    part_o, part_lse, out, lse = merge_buffers(nsel, b, hkv * g, v.device)
    _lib.launch(name, "mp_block_attend", v.device, scores, blk_ids, v,
                v_scale, part_o, part_lse, out, lse, b, s, hkv * g, hkv,
                v.shape[3], nsel, block_size, int(v.dtype == torch.int8))
    return out, lse

"""Attention over the selected blocks from stored scores (the block_topk
store pipeline): wrapper of the hand-written kernel `csrc/block_attend.cu`,
with its plain version `block_attend_plain`.

Replaces the TPU kernel `magicpig_tpu/ops/pallas/block_attend.py::
block_attend` (pallas_call at block_attend.py:224). On the H100 it is bound
by reading the selected blocks' scores and V rows once. The kernel shares
the rescore's attend (`csrc/chunk_attend.cuh`): one CUDA block a chunk of
`chunk` tokens of one selected block of one (request, kv head), its rows
brought by bulk copies, P.V on tensor cores, the chunks merged by LSE in
the same launch; with the same chunk the two pipelines agree bit for bit.
Group sizes without an exact instance take the general tile: a CUDA block
attends up to 16 query heads of a kv head over `tile_plan`'s share of the
selected blocks, through a bulk-copy ring with an online softmax.

The V scale (int8 V) multiplies the probabilities, not V. The plain version
rounds those products to bf16 before the sum over V when V is bf16 or int8,
as the TPU kernel does, and so does the kernel (its P.V operand).
"""

from __future__ import annotations

import torch

from magicpig_tpu_torch.ops import attention
from magicpig_tpu_torch.ops.baselines import gather_blocks
from magicpig_tpu_torch.ops.kernels import _lib
from magicpig_tpu_torch.ops.kernels.block_score import launch_name
from magicpig_tpu_torch.ops.kernels.flash_decode import tickets_for

MIN_CHUNK = 128           # tokens a CUDA block of the attends at least ...
MAX_CHUNK = 512           # ... and at most (kMaxChunk in chunk_attend.cuh)
MERGE_BYTES = 32 * 1024   # the merge's batch of partials at d <= 64
#                           (kMergeBytes; d / 64 times that at head dim d)
CHUNK_HEADER = 128        # mbarrier, flag, m, l, alpha (kChunkHeader)
SMEM_MAX = 227 * 1024     # a CUDA block's shared memory (kChunkSmemMax)
ATTEND_STAGE = 64         # tokens a unit of the general tile (kAttTile)
FILL_STAGES = 4           # units a fill of its ring holds (kAttFill / kAttTile)


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
    _lib.check_group(name, hq, hkv, d)
    _lib.require(block_size > 0 and block_size % 64 == 0 and s > 0
                 and s % block_size == 0,
                 f"{name}: block size {block_size} unsupported for S={s}")
    _lib.require(blk_ids.dtype == torch.int32 and blk_ids.dim() == 3
                 and blk_ids.shape[:2] == (b, hkv) and blk_ids.shape[2] > 0,
                 f"{name}: blk_ids must be int32 [B, Hkv, NB']")


def chunk_bytes(chunk: int, g: int, k_row: int, v_row: int,
                k_scale: bool, v_scale: bool) -> int:
    """Shared memory of one CUDA block's chunk (`chunk_smem` in
    chunk_attend.cuh): the header, the K rows (`k_row` bytes each, 0 when
    the scores are stored), V rows, the scales, the G score rows and P."""
    return (CHUNK_HEADER + chunk * (k_row + v_row + 4 * (k_scale + v_scale))
            + g * (chunk + 4) * 4 + g * (chunk // 2 + 4) * 4)


def chunk_plan(block_size: int, chunk: int | None, nsel: int, g: int,
               d: int = 64,
               row_bytes: tuple = (0, 128, False, False)) -> tuple[int, int]:
    """(tokens a CUDA block, chunks a selected block) of the attends'
    exact instances (`g` heads a kv head): a selected block cut into
    chunks of `chunk` tokens (a power of two from 64 to 512), the last one
    shorter where the block size is not a multiple of it; a block smaller
    than the chunk is one chunk. By
    default the smallest chunk from MIN_CHUNK up whose partials (nsel of
    them a chunk of each block) the merge takes in one batch of its shared
    memory (`MERGE_BYTES` per 64 dims: as many partials a batch at d = 128
    as at 64), at G heads a kv head and head dim d, and whose rows
    (`row_bytes`: K and V row bytes, K and V scales, as `chunk_bytes`
    takes them) fit a block: bf16 K and V at d = 128 stop at 256 tokens,
    and the merge then takes more than one batch. `chip_smoke.py` phase 2
    sweeps 64 to 512 at two shapes and both head dims (`PERF.md`)."""
    if chunk is None:
        batch = MERGE_BYTES * max(d, 64) // 64 // (g * (d + 1) * 4)
        chunk = MIN_CHUNK
        while (chunk < MAX_CHUNK and nsel * -(-block_size // chunk) > batch
               and chunk_bytes(2 * chunk, g, *row_bytes) <= SMEM_MAX):
            chunk *= 2
    _lib.require(64 <= chunk <= MAX_CHUNK and chunk & (chunk - 1) == 0,
                 f"chunk {chunk} is not a power of two from 64 to {MAX_CHUNK}")
    chunk = min(chunk, block_size)
    _lib.require(chunk_bytes(chunk, g, *row_bytes) <= SMEM_MAX,
                 f"chunk {chunk}: its rows do not fit a CUDA block")
    return chunk, -(-block_size // chunk)


def tile_plan(nsel: int, block_size: int, blocks: int, num_sms: int,
              chunk: int | None = None) -> tuple[int, int]:
    """(tokens a CUDA block, CUDA blocks a (request, kv head, block of
    heads)) of the attends' general tile, which takes the selected blocks
    of each (request, kv head, block of heads) as one list of nsel *
    block_size tokens in units of ATTEND_STAGE, brought FILL_STAGES units
    of one selected block at a time. By default the list is cut into about
    num_sms // blocks pieces (`blocks`: the grid's (request, kv head, block
    of heads) triples; the ring's shared memory holds an SM), so that the
    grid is about one wave, each of whole fills; `chunk` (a multiple of 64
    tokens) sets the piece for the card tests and `chip_smoke.py`'s sweep,
    which times the serves' selected counts after an L2 eviction: there a
    fill a CUDA block beat 128 tokens, 512 and the whole list (`PERF.md`).
    A piece past the list is the whole list."""
    tokens = nsel * block_size
    if chunk is None:
        pieces = max(1, num_sms // max(1, blocks))
        stages = -(-tokens // (ATTEND_STAGE * pieces))
        chunk = -(-stages // FILL_STAGES) * FILL_STAGES * ATTEND_STAGE
    _lib.require(chunk >= ATTEND_STAGE and chunk % ATTEND_STAGE == 0,
                 f"chunk {chunk} is not a positive multiple of {ATTEND_STAGE}")
    chunk = min(chunk, tokens)
    return chunk, -(-tokens // chunk)


def merge_buffers(nparts: int, b: int, hq: int, hkv: int, d: int,
                  device: torch.device):
    """Per-chunk partials, the merge tickets and the merged output of an
    attend at head dim d."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((nparts, b * hq, d), **f32),
            torch.empty((nparts, b * hq), **f32),
            tickets_for(device, b, hq, hkv, d, _lib.HEAD_TILE)[0],
            torch.empty((b, hq, d), **f32),
            torch.empty((b, hq), **f32))


def launch_plan(b: int, hq: int, hkv: int, d: int, nsel: int,
                block_size: int, chunk: int | None, row_bytes: tuple,
                device: torch.device):
    """(chunk, merge buffers) of one attend launch: an exact instance's
    chunks of each selected block (`chunk_plan`), or the general tile's
    share of the selected blocks a CUDA block (`tile_plan`, from the SM
    count)."""
    g = hq // hkv
    if _lib.exact_group(g, d):
        chunk, nch = chunk_plan(block_size, chunk, nsel, g, d, row_bytes)
        nparts = nsel * nch
    else:
        num_sms = tickets_for(device, b, hq, hkv, d, _lib.HEAD_TILE)[1]
        blocks = b * hkv * _lib.head_blocks(g, d, _lib.HEAD_TILE)
        chunk, nparts = tile_plan(nsel, block_size, blocks, num_sms, chunk)
    return chunk, merge_buffers(nparts, b, hq, hkv, d, device)


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
    return launch_block_attend(scores, blk_ids, v, v_scale, block_size, None)


def launch_block_attend(scores: torch.Tensor, blk_ids: torch.Tensor,
                        v: torch.Tensor, v_scale: torch.Tensor | None,
                        block_size: int, chunk: int | None):
    """One launch of the kernel at `chunk` tokens a CUDA block (None:
    `launch_plan`'s choice), inputs checked: the wrapper's, and the card
    tests' and `chip_smoke.py`'s at each chunk."""
    _lib.require(scores.device.type == "cuda",
                 f"block_attend: unsupported device {scores.device}")
    b, hkv, g, s = scores.shape
    d = v.shape[-1]
    name = launch_name("block_attend", False, d, g)
    _lib.require(v.dim() == 4 and v.shape[:3] == (b, hkv, s),
                 f"{name}: v shape {tuple(v.shape)}")
    _lib.require_cuda(name, scores, v)
    _lib.require(scores.dtype == torch.float32, f"{name}: scores must be f32")
    check_selection(name, blk_ids, v, v_scale, hkv * g, block_size)
    nsel = blk_ids.shape[2]
    int8 = v.dtype == torch.int8
    chunk, (part_o, part_lse, tickets, out, lse) = launch_plan(
        b, hkv * g, hkv, d, nsel, block_size, chunk,
        (0, d * v.element_size(), False, int8), v.device)
    _lib.launch(name, "mp_block_attend", v.device, scores, blk_ids, v,
                v_scale, part_o, part_lse, tickets, out, lse, b, s, hkv * g,
                hkv, d, nsel, block_size, chunk, int(int8))
    return out, lse

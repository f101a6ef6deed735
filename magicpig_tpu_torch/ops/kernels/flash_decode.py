"""Dense flash decode with LSE export: wrapper of the hand-written kernel
`csrc/flash_decode.cu`, with its plain version `ops.attention.full_decode`.

Replaces the TPU kernel `magicpig_tpu/ops/pallas/decode.py::flash_decode`
(pallas_call at decode.py:184): bf16 K/V, or int8 K/V with per-token f32
scales, at head dims 16, 32, 64 and 128 and any group size, over each
request's rows [start, length) (`start` optional: a sliding window's lower
bound, which the JAX package applies as a mask), counted apart as
"flash_decode", "flash_decode_int8", with "_d16", "_d32" or "_d128" at
those head dims and "_g<G>" at the group sizes of the kernel's general tile
beyond those it has always taken (`launch_name`). On the H100 it is bound by
reading K and V once; the kernel streams K/V tiles with bulk copies, splits
the sequence so that a small batch fills the card (`split_tokens`), and
merges the splits by LSE in the same launch; see the source for the design.
"""

from __future__ import annotations

import math

import torch

from magicpig_tpu_torch.ops import attention
from magicpig_tpu_torch.ops.kernels import _lib

HEAD_DIM = 64          # the d = 64 forms' counters carry no suffix
DECODE_TILE = 64       # tokens per copy of flash_decode (kTile)
MIN_SPLIT = 256        # fewest tokens per flash_decode split
MAX_SPLIT = 1024       # most tokens per flash_decode split
MAX_SPLIT_TILE = 2048  # most per split of the general tile above 4 heads

# Per device: the merge tickets (int32, 0 between calls; the kernel resets
# each one it uses) and the SM count. A CUDA graph captured over a wrapper
# keeps the address of the tickets it was given, so tickets outgrown by a
# later call stay allocated (`_outgrown`) for as long as the process runs;
# each growth at least doubles them, so there are few.
_tickets: dict[torch.device, torch.Tensor] = {}
_outgrown: list[torch.Tensor] = []
_num_sms: dict[torch.device, int] = {}


def split_tokens(capacity: int, batch: int, hkv: int, num_sms: int,
                 heads: int = 0) -> int:
    """Tokens per flash_decode split: the capacity of every (request, kv
    head) cut into about one block per SM, in whole 64-token tiles, within
    [MIN_SPLIT, MAX_SPLIT]. A short cache takes one split, which writes its
    output without a merge. `heads`: the query heads a block of the general
    tile serves (0: an exact instance). A tile block's set-up and the last
    block's merge grow with its heads, so its fewest tokens are MIN_SPLIT
    for every 4 heads, and above 4 heads its most MAX_SPLIT_TILE.
    `chip_smoke.py` phase 2 times 512, 1024 and 2048 at B=2 over 16384 +
    11000 tokens, bf16 and int8, at d = 64 and 128, and the general tile's
    served forms (`PERF.md`)."""
    per_split = -(-capacity * batch * hkv // max(1, num_sms))
    tiles = -(-per_split // DECODE_TILE)
    fewest = MIN_SPLIT * max(1, -(-heads // 4))
    most = MAX_SPLIT_TILE if heads > 4 else MAX_SPLIT
    return min(most, max(fewest, tiles * DECODE_TILE))


def tile_heads(group: int, head_dim: int) -> int:
    """Query heads a block of the general tile serves for `group` heads a
    kv head (0 for an exact instance)."""
    return 0 if _lib.exact_group(group, head_dim) else min(group, _lib.HEAD_TILE)


def device_state(device: torch.device,
                 pairs: int) -> tuple[torch.Tensor, int]:
    """The device's tickets (at least `pairs`) and SM count."""
    if device not in _num_sms:
        props = torch.cuda.get_device_properties(device)
        _num_sms[device] = props.multi_processor_count
    tickets = _tickets.get(device)
    if tickets is None or tickets.numel() < pairs:
        if tickets is not None:
            _outgrown.append(tickets)
            pairs = max(pairs, 2 * tickets.numel())
        tickets = torch.zeros((pairs,), dtype=torch.int32, device=device)
        _tickets[device] = tickets
    return tickets, _num_sms[device]


def head_suffix(head_dim: int, group: int) -> str:
    """The counters' head part of every decode-side kernel: "_d<d>" unless
    d = 64, then `_lib.group_suffix`."""
    return (("" if head_dim == HEAD_DIM else f"_d{head_dim}")
            + _lib.group_suffix(group, head_dim))


def launch_name(quant: bool, head_dim: int, group: int = 1) -> str:
    """The launch counter of one form: "flash_decode", "_int8" for int8
    K/V, then `head_suffix` ("_d128" at head dim 128, "_g6" at group size
    6, ...)."""
    return ("flash_decode" + ("_int8" if quant else "")
            + head_suffix(head_dim, group))


def tickets_for(device: torch.device, b: int, hq: int, hkv: int,
                head_dim: int, tile: int) -> tuple[torch.Tensor, int]:
    """`device_state` with a ticket for each (request, kv head, block of
    its query heads): the general tile's blocks take one each, `tile`
    (`_lib.HEAD_TILE` or `_lib.GROUP_TILE`) the kernel family's heads a
    block."""
    return device_state(device,
                        b * hkv * _lib.head_blocks(hq // hkv, head_dim, tile))


def check_decode_inputs(name: str, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, length: torch.Tensor,
                        k_scale: torch.Tensor | None = None,
                        v_scale: torch.Tensor | None = None) -> None:
    """Shape and type checks shared by the split-sequence decode kernels:
    bf16 q; bf16 k, v, or int8 k, v with f32 scales [B, Hkv, S]; a head dim
    of `_lib.HEAD_DIMS` and query heads a multiple of the kv heads
    (`_lib.check_group`)."""
    _lib.require(q.device.type == "cuda", f"{name}: unsupported device {q.device}")
    _lib.require_cuda(name, q, k, v, length)
    b, hq, d = q.shape
    hkv = k.shape[1]
    if k_scale is None and v_scale is None:
        _lib.require(q.dtype == k.dtype == v.dtype == torch.bfloat16,
                     f"{name}: q, k, v must be bfloat16")
    else:
        _lib.require(k_scale is not None and v_scale is not None,
                     f"{name}: int8 K/V needs both scales")
        _lib.require_cuda(name, q, k_scale, v_scale)
        _lib.require(q.dtype == torch.bfloat16
                     and k.dtype == v.dtype == torch.int8,
                     f"{name}: q must be bfloat16 and k, v int8")
        for sc in (k_scale, v_scale):
            _lib.require(sc.dtype == torch.float32 and sc.shape == k.shape[:3],
                         f"{name}: scales must be f32 [B, Hkv, S]")
    _lib.require(k.dim() == 4 and k.shape == v.shape
                 and k.shape[0] == b and k.shape[3] == d,
                 f"{name}: k/v shape {tuple(k.shape)}")
    _lib.check_group(name, hq, hkv, d)
    _lib.require(length.dtype == torch.int32 and length.shape == (b,),
                 f"{name}: length must be int32 [B]")


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 length: torch.Tensor, k_scale: torch.Tensor | None = None,
                 v_scale: torch.Tensor | None = None,
                 start: torch.Tensor | None = None):
    """Single-query attention over a cache range.

    q: [B, Hq, d]; k, v: [B, Hkv, S, d], bf16, or int8 with f32 scales
    k_scale, v_scale [B, Hkv, S] (d 16, 32, 64 or 128 on the card, Hq any
    multiple of Hkv); length: [B]
    int32 valid tokens; start: [B] int32 first valid token, or None for 0
    (the kernel reads no tile that lies wholly before it).
    Returns (out [B, Hq, d] f32, lse [B, Hq] f32); a request with no valid
    token gives out 0 and lse -inf. CPU tensors take the plain version.
    """
    if q.device.type == "cpu":
        return attention.full_decode(q, k, v, length, k_scale, v_scale, start)
    b, hq, d = q.shape
    quant = k_scale is not None
    hkv = k.shape[1] if k.dim() == 4 else 0
    name = launch_name(quant, d, hq // hkv if hkv else 0)
    check_decode_inputs(name, q, k, v, length, k_scale, v_scale)
    if start is not None:
        _lib.require_cuda(name, q, start)
        _lib.require(start.dtype == torch.int32 and start.shape == (b,),
                     f"{name}: start must be int32 [B]")
    s = k.shape[2]
    tickets, num_sms = tickets_for(q.device, b, hq, hkv, d, _lib.HEAD_TILE)
    chunk = split_tokens(s, b, hkv, num_sms, tile_heads(hq // hkv, d))
    nsplit = -(-s // chunk)
    f32 = dict(dtype=torch.float32, device=q.device)
    part_o = torch.empty((nsplit, b * hq, d), **f32)
    part_lse = torch.empty((nsplit, b * hq), **f32)
    out = torch.empty((b, hq, d), **f32)
    lse = torch.empty((b, hq), **f32)
    _lib.launch(name, "mp_flash_decode", q.device, q, k, v, k_scale, v_scale,
                length, start, part_o, part_lse, tickets, out, lse, b, s, hq,
                hkv, d, chunk, 1.0 / math.sqrt(d))
    return out, lse

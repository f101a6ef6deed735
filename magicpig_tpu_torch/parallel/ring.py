"""Sequence-parallel causal prefill over a ring of ranks (port of
`magicpig_tpu/parallel/ring.py`).

The prompt's tokens are split over a mesh axis of N ranks. Each rank
holds its queries and, in turn, every rank's K/V: at step t it attends its
queries to the K/V shard that started on rank (r - t) mod N, then passes
that shard one hop on (rank r sends to r + 1 and receives from r - 1).
Each partial is the flash-prefill kernel with its log-sum-exp at the
query offset of the two chunks (`ops/kernels/flash_prefill.py`; the plain
version on the CPU); partials merge by log-sum-exp; a source chunk wholly
in the queries' future is skipped.

Layouts, as in the JAX package:
  * "contiguous": rank r holds tokens [r S/N, (r + 1) S/N); rank r has
    work on r + 1 of the N steps;
  * "zigzag": the sequence is cut into 2N chunks and rank r holds chunks r
    and 2N - 1 - r, an early one and a late one, so every step carries
    about the same causal work on every rank.

`shard_tokens` takes a rank's part of a global-order array and
`unshard_tokens` puts the gathered parts back in global order. Under NCCL
the K/V pass is a batched isend / irecv of the card's tensors; gloo passes
host tensors, so a CUDA shard goes through pinned host buffers there.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from magicpig_tpu_torch.ops.kernels import flash_prefill
from magicpig_tpu_torch.ops.merge import merge_partials
from magicpig_tpu_torch.parallel import sharded
from magicpig_tpu_torch.parallel.mesh import axis_index, axis_size

LAYOUTS = ("zigzag", "contiguous")


def chunk_order(n: int, layout: str) -> list[int]:
    """The global chunks in rank order: rank r holds entries [r c, (r + 1)
    c) of this list, c = 2 for zigzag (of 2N chunks), 1 for contiguous (of
    N)."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if layout == "contiguous":
        return list(range(n))
    return [x for r in range(n) for x in (r, 2 * n - 1 - r)]


def shard_tokens(x: torch.Tensor, n: int, rank: int, layout: str,
                 dim: int = 1) -> torch.Tensor:
    """Rank `rank`'s tokens of a global-order `x` along `dim`."""
    order = chunk_order(n, layout)
    per = len(order) // n
    chunks = x.chunk(len(order), dim=dim)
    return torch.cat([chunks[c] for c in order[rank * per:(rank + 1) * per]],
                     dim=dim)


def unshard_tokens(parts: list[torch.Tensor], layout: str,
                   dim: int = 1) -> torch.Tensor:
    """Global order from every rank's tokens (rank order) along `dim`."""
    n = len(parts)
    order = chunk_order(n, layout)
    chunks = [c for p in parts for c in p.chunk(len(order) // n, dim=dim)]
    by_global = [None] * len(order)
    for pos, c in enumerate(order):
        by_global[c] = chunks[pos]
    return torch.cat(by_global, dim=dim)


class _Ring:
    """The one-hop K/V pass of a group: to the next rank, from the
    previous one."""

    def __init__(self, group, n: int, rank: int):
        self.group = group
        self.to = dist.get_global_rank(group, (rank + 1) % n)
        self.frm = dist.get_global_rank(group, (rank - 1) % n)
        self.host = dist.get_backend(group) == "gloo"
        self._bufs = None

    def pass_on(self, kb: torch.Tensor, vb: torch.Tensor):
        sharded.COLLECTIVES["ring"] += 1
        staged = self.host and kb.device.type == "cuda"
        if staged:
            if self._bufs is None:
                self._bufs = [torch.empty(kb.shape, dtype=kb.dtype,
                                          pin_memory=True) for _ in range(4)]
            send_k, send_v, recv_k, recv_v = self._bufs
            send_k.copy_(kb)
            send_v.copy_(vb)
        else:
            send_k, send_v = kb.contiguous(), vb.contiguous()
            recv_k, recv_v = torch.empty_like(send_k), torch.empty_like(send_v)
        ops = [dist.P2POp(dist.isend, send_k, self.to, self.group),
               dist.P2POp(dist.isend, send_v, self.to, self.group),
               dist.P2POp(dist.irecv, recv_k, self.frm, self.group),
               dist.P2POp(dist.irecv, recv_v, self.frm, self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if staged:
            return (recv_k.to(kb.device, non_blocking=False),
                    recv_v.to(vb.device, non_blocking=False))
        return recv_k, recv_v


def _attend(qc, kc, vc, rel: int):
    """One (query chunk, key chunk) pair with the queries `rel` tokens
    after the keys' start: (out f32, lse), or None when every key lies in
    the queries' future."""
    b, cq = qc.shape[0], qc.shape[1]
    if rel + cq <= 0:
        return None
    dev = qc.device
    length = torch.full((b,), kc.shape[1], dtype=torch.int32, device=dev)
    offset = torch.full((b,), rel, dtype=torch.int32, device=dev)
    out, lse = flash_prefill(qc, kc, vc, length, offset, return_lse=True)
    return out.float(), lse


def _merge(acc, part):
    if part is None:
        return acc
    if acc is None:
        return part
    return merge_partials([acc[0], part[0]], [acc[1], part[1]])


def ring_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                 axis: str = "data", layout: str = "zigzag") -> torch.Tensor:
    """Causal self-attention with the sequence split over the mesh axis
    `axis` (N ranks). q: [B, S/N, Hq, d], k, v: [B, S/N, Hkv, d], this
    rank's tokens in `layout` order (`shard_tokens`) at the rank's heads;
    RoPE at the global positions is the caller's. Returns [B, S/N, Hq, d]
    in q.dtype, this rank's queries' outputs."""
    n, r = axis_size(mesh, axis), axis_index(mesh, axis)
    group = mesh.get_group(axis)
    zig = chunk_order(n, layout) != list(range(n))
    sl = q.shape[1]
    if zig and sl % 2:
        raise ValueError(f"zigzag shards of {sl} tokens do not split in two")
    halves = 2 if zig else 1
    c = sl // halves

    def start(rank: int, h: int) -> int:
        """Global start of half h of rank `rank`'s tokens."""
        if not zig:
            return rank * sl
        return (rank if h == 0 else 2 * n - 1 - rank) * c

    ring = _Ring(group, n, r) if n > 1 else None
    acc = [None] * halves
    kb, vb = k, v
    for t in range(n):
        src = (r - t) % n
        for qi in range(halves):
            qc = q[:, qi * c:(qi + 1) * c]
            for ki in range(halves):
                part = _attend(qc, kb[:, ki * c:(ki + 1) * c],
                               vb[:, ki * c:(ki + 1) * c],
                               start(r, qi) - start(src, ki))
                acc[qi] = _merge(acc[qi], part)
        if t + 1 < n:
            kb, vb = ring.pass_on(kb, vb)
    # A rank's queries always see their own diagonal chunk: acc is set.
    return torch.cat([a[0] for a in acc], dim=1).to(q.dtype)

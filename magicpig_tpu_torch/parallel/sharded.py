"""The collectives of a sharded engine (port of
`magicpig_tpu/parallel/sharded.py`).

GSPMD inserts the JAX package's collectives; here `Shard` calls them:

  * the row-split products (`wo`, `w_down`) sum over "model" before the
    one cast to the model dtype: W8A8's exact int32 products, W4A8's and
    the int4 kernel's float32 sums, a plain product's output in the model
    dtype, as Megatron does (`models/llama.py::linear`); W8A8 and W4A8
    quantize the activation by the amax of its whole row, a MAX over
    "model" first. At one rank a sum is the identity, so a 1 x 1 mesh
    computes the unsharded engine's numbers bit for bit;
  * the vocabulary shards of the logits gather over "model", then the
    batch shards over "data";
  * the sampled fraction of a step: each rank's is a ratio over its own
    batch and heads, so the global one weighs the data ranks' ratios by
    their offload lengths (a ratio of global sums, not a mean of ratios)
    and averages the model ranks' (their heads are symmetric).

The attention itself needs no collective: a rank's state and q, k, v are
its own (batch, kv-head) slice, so the engine calls the server functions
and kernels unchanged (the JAX package's `decode_*_layer_sharded` and
`flash_prefill_sharded` have no counterpart) and every launch runs at the
local head count. `COLLECTIVES` counts the calls by kind.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from magicpig_tpu_torch.config import ModelConfig
from magicpig_tpu_torch.parallel.mesh import axis_index, axis_size

COLLECTIVES: dict[str, int] = {"sum": 0, "max": 0, "gather": 0, "ring": 0}


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


class Shard:
    """One rank's place in a ("data", "model") mesh: its process groups,
    its slice of the batch and of the heads, the local shapes
    (`config`: the model config at the rank's head, MLP and vocabulary
    widths) and the collectives the engine calls."""

    def __init__(self, mesh, config: ModelConfig, batch_size: int,
                 seq_axis: str | None = None):
        self.n_data, self.n_model = axis_size(mesh, "data"), axis_size(mesh, "model")
        self.d, self.m = axis_index(mesh, "data"), axis_index(mesh, "model")
        self.data = mesh.get_group("data")
        self.model = mesh.get_group("model")
        self.batch = batch_size // self.n_data
        self.b0 = self.d * self.batch
        n = self.n_model
        self.config = dataclasses.replace(
            config, num_attention_heads=config.num_attention_heads // n,
            num_key_value_heads=config.num_key_value_heads // n,
            intermediate_size=config.intermediate_size // n,
            vocab_size=config.vocab_size // n)
        self.seq = None if seq_axis is None else mesh.get_group(seq_axis)
        self.n_seq = 1 if seq_axis is None else axis_size(mesh, seq_axis)
        self.seq_rank = 0 if seq_axis is None else axis_index(mesh, seq_axis)
        # A CUDA graph can hold NCCL's collectives, not gloo's.
        self.capturable = all(dist.get_backend(g) == "nccl"
                              for g in (self.data, self.model))

    # -- slots ------------------------------------------------------------------

    def owns(self, request_id: int) -> bool:
        return self.b0 <= request_id < self.b0 + self.batch

    def slot(self, request_id: int) -> int:
        """The local slot of global request `request_id` (this rank's)."""
        return request_id - self.b0

    def local_batch(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global [B, ...] tensor."""
        return x[self.b0:self.b0 + self.batch]

    # -- collectives ------------------------------------------------------------

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """`t` summed over "model" (in place; returned)."""
        COLLECTIVES["sum"] += 1
        dist.all_reduce(t, group=self.model)
        return t

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of `t` over "model" (in place)."""
        COLLECTIVES["max"] += 1
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.model)
        return t

    def _gather(self, t: torch.Tensor, group, n: int) -> list[torch.Tensor]:
        COLLECTIVES["gather"] += 1
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(), group=group)
        return parts

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """[rows, V / n_model] vocabulary shards -> [rows, V]."""
        return torch.cat(self._gather(logits, self.model, self.n_model), dim=-1)

    def gather_batch(self, x: torch.Tensor) -> torch.Tensor:
        """[B / n_data, ...] batch shards -> [B, ...]."""
        return torch.cat(self._gather(x, self.data, self.n_data), dim=0)

    def gather_seq(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Every seq rank's `x`, in seq-rank order."""
        return self._gather(x, self.seq, self.n_seq)

    def sum_seq(self, t: torch.Tensor) -> torch.Tensor:
        """`t` summed over the seq axis (in place)."""
        COLLECTIVES["sum"] += 1
        dist.all_reduce(t, group=self.seq)
        return t

    def global_frac(self, frac: torch.Tensor,
                    off_len: torch.Tensor) -> torch.Tensor:
        """The step's sampled fraction over the whole batch and every head
        from this rank's (a ratio over its batch and heads): weighted by
        the offload tokens over "data", averaged over "model"
        (`sharded.py:80-82` of the JAX package)."""
        if self.n_data > 1:
            w = torch.clamp(off_len.float().sum(), min=1.0)
            pair = torch.stack([frac.float() * w, w])
            COLLECTIVES["sum"] += 1
            dist.all_reduce(pair, group=self.data)
            frac = pair[0] / pair[1]
        frac = frac.float().reshape(1).clone()
        self.sum(frac)
        return frac[0] / self.n_model

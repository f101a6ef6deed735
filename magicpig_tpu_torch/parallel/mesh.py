"""Tensor parallelism over kv heads and data parallelism over the batch
(port of `magicpig_tpu/parallel/mesh.py`).

The mesh is a `torch.distributed` `DeviceMesh` with dims ("data",
"model"). Where the JAX package places each array with a `PartitionSpec`
and lets GSPMD insert the collectives, every rank here holds its own slice
and the engine calls the collectives itself (`parallel/sharded.py`):

  * weights, the Megatron split of the reference's distributed runtime
    (`evaluations/RULER/pred/llama_dist.py:47-77`): `wq`, `wk`, `wv`,
    `w_gate`, `w_up` split by output columns, `wo` and `w_down` by input
    rows (their products are summed over "model"), `lm_head` by vocabulary
    columns (gathered over "model"); a `QuantWeight`'s per-output scales
    follow its columns, a `Quant4Weight`'s group axis splits like the input
    rows it groups. The embedding, the norms and the RoPE tables stay whole;
  * decode state: the batch over "data", the kv heads over "model"; `pos`
    and the lengths follow the batch, `step` stays whole.

Query heads are kv-major (query head h reads kv head h // G), so a split
of Hq at Hkv-group boundaries keeps each kv head with its G query heads.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from magicpig_tpu_torch.models.llama import (
    W4_GROUP,
    LlamaParams,
    Quant4Weight,
    QuantWeight,
)
from magicpig_tpu_torch.runtime.state import DecodeState

AXES = ("data", "model")

# How each matmul weight splits over "model" (`param_pspecs`): "out" by
# output columns, "in" by input rows; the other fields stay whole.
PARAM_SPLIT = {"wq": "out", "wk": "out", "wv": "out", "wo": "in",
               "w_gate": "out", "w_up": "out", "w_down": "in",
               "lm_head": "out"}


def _mesh_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_data: int, n_model: int) -> DeviceMesh:
    """A ("data", "model") mesh over ranks 0 .. n_data * n_model - 1, rank
    r at (r // n_model, r % n_model). Every rank of the process group must
    call it; ranks past the mesh get a mesh whose `get_coordinate()` is
    None."""
    world = dist.get_world_size()
    n = n_data * n_model
    if n_data < 1 or n_model < 1 or n > world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs {n} ranks, "
                         f"the group has {world}")
    if n == world:
        return init_device_mesh(_mesh_device_type(), (n_data, n_model),
                                mesh_dim_names=AXES)
    return DeviceMesh(_mesh_device_type(),
                      torch.arange(n).reshape(n_data, n_model),
                      mesh_dim_names=AXES)


def make_multihost_mesh(n_model: int | None = None) -> DeviceMesh:
    """A mesh over every rank of the group with the "model" axis (a
    collective every layer) inside a host and "data" across hosts: n_model
    defaults to the ranks of one host (`LOCAL_WORLD_SIZE`, as `torchrun`
    sets it; the whole group when unset)."""
    world = dist.get_world_size()
    if n_model is None:
        n_model = min(int(os.environ.get("LOCAL_WORLD_SIZE", world)), world)
    if n_model < 1 or world % n_model:
        raise ValueError(f"model axis {n_model} must divide the {world} ranks")
    return make_mesh(world // n_model, n_model)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(AXES.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate on `axis` (the rank must be in the mesh)."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    return coord[AXES.index(axis)]


# -- splits ---------------------------------------------------------------------


def _part(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    """Part i of n of `t` along `dim`, in its own storage (so the whole
    tensor can be freed); `t` itself when n == 1."""
    if n == 1:
        return t
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size).clone(memory_format=torch.contiguous_format)


def split_weight(w, how: str, n: int, i: int):
    """Part i of n of a stacked or single matmul weight [..., in, out] (a
    tensor, `QuantWeight` or `Quant4Weight`), split by "out" columns or
    "in" rows."""
    if how == "out":
        if isinstance(w, (QuantWeight, Quant4Weight)):
            return type(w)(q=_part(w.q, -1, n, i), scale=_part(w.scale, -1, n, i))
        return _part(w, -1, n, i)
    if isinstance(w, Quant4Weight):          # packed rows and groups alike
        return Quant4Weight(q=_part(w.q, -2, n, i), scale=_part(w.scale, -2, n, i))
    if isinstance(w, QuantWeight):           # per-output scales stay whole
        return QuantWeight(q=_part(w.q, -2, n, i), scale=w.scale)
    return _part(w, -2, n, i)


def _rows_in(w) -> int:
    if isinstance(w, Quant4Weight):
        return w.scale.shape[-2] * W4_GROUP
    return (w.q if isinstance(w, QuantWeight) else w).shape[-2]


def _cols_out(w) -> int:
    return (w.q if isinstance(w, (QuantWeight, Quant4Weight)) else w).shape[-1]


def check_split(params: LlamaParams, n_model: int) -> None:
    """Raise ValueError where `params` do not split over n_model ranks:
    fused weights (the split covers the unfused layout), or an axis that
    does not divide (int4 rows by whole 128-input groups)."""
    lw = params.layers
    if lw.wqkv is not None or lw.w_gateup is not None:
        raise ValueError("fused small linears (wqkv / w_gateup) do not shard: "
                         "build the engine with fuse_small_linears=False")
    for name, how in PARAM_SPLIT.items():
        w = params.lm_head if name == "lm_head" else getattr(lw, name)
        size = _cols_out(w) if how == "out" else _rows_in(w)
        unit = W4_GROUP if how == "in" and isinstance(w, Quant4Weight) else 1
        if size % (n_model * unit):
            raise ValueError(f"{name}: {how} size {size} does not split over "
                             f"{n_model} model ranks"
                             + (f" in whole {W4_GROUP}-input groups"
                                if unit > 1 else ""))


def shard_params(params: LlamaParams, n_model: int, m: int) -> LlamaParams:
    """Model rank m's part of `params` (`PARAM_SPLIT`)."""
    check_split(params, n_model)
    lw = params.layers
    layers = dataclasses.replace(lw, **{
        name: split_weight(getattr(lw, name), how, n_model, m)
        for name, how in PARAM_SPLIT.items() if name != "lm_head"})
    return dataclasses.replace(
        params, layers=layers,
        lm_head=split_weight(params.lm_head, "out", n_model, m))


def shard_state(state: DecodeState, n_data: int, d: int, n_model: int,
                m: int) -> DecodeState:
    """Rank (d, m)'s part of `state`: every per-layer tensor [B, Hkv, ...]
    by batch and kv head, the [B] lengths and positions by batch, `step`
    whole."""
    def split(t: torch.Tensor, heads: bool) -> torch.Tensor:
        t = _part(t, 0, n_data, d)
        return _part(t, 1, n_model, m) if heads else t

    fields = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, list):
            fields[f.name] = [split(t, True) for t in v]
        elif f.name == "step":
            fields[f.name] = v
        else:
            fields[f.name] = split(v, False)
    return DecodeState(**fields)


def shard_engine(llm, mesh: DeviceMesh, seq_axis: str | None = None):
    """Shard an `LLM` over `mesh` in place and return it. Every rank
    builds the same engine (the same seed draws the same weights and hash
    projections on every rank, which takes the place of the reference's
    rank-0 broadcast) and calls this; each then keeps only its part of the
    weights and state. From then on every rank makes the same calls with
    the same global arguments (request ids, [B] tokens) and gets the same
    global results (`runtime/engine.py`).

    `seq_axis`: a mesh axis over which `prefill` runs the prompt's sequence
    through the ring (`parallel/ring.py`); "data", idle during a fill, is
    the natural one. The padded prompt (whole `chunk_size` chunks) must
    split into 2 x its size zigzag chunks, so the chunk size must divide
    by that. The ring runs over "data" only: "model" splits the heads.
    Raises ValueError where the engine does not split."""
    from magicpig_tpu_torch.parallel.sharded import Shard

    if mesh.mesh_dim_names != AXES:
        raise ValueError(f"the mesh dims must be {AXES}, got "
                         f"{mesh.mesh_dim_names}")
    n_data, n_model = axis_size(mesh, "data"), axis_size(mesh, "model")
    cfg = llm.config
    if cfg.num_key_value_heads % n_model:
        raise ValueError(f"{cfg.num_key_value_heads} kv heads do not split "
                         f"over {n_model} model ranks")
    if llm.batch_size % n_data:
        raise ValueError(f"batch {llm.batch_size} does not split over "
                         f"{n_data} data ranks")
    if seq_axis is not None:
        if seq_axis != "data":
            raise ValueError(f"seq_axis must be 'data' (\"model\" splits the "
                             f"heads), got {seq_axis!r}")
        if llm.config.sliding_window is not None:
            raise ValueError("the ring prefill attends the whole causal "
                             "prefix: a sliding window does not shard over "
                             "the sequence")
        n_seq = axis_size(mesh, seq_axis)
        chunk = min(llm.chunk_size, llm.max_length)
        if n_seq > 1 and chunk % (2 * n_seq):
            raise ValueError(
                f"chunk size {chunk} does not split into 2 x {n_seq} "
                f"zigzag chunks of the {seq_axis!r} axis")
    check_split(llm.params, n_model)
    d, m = axis_index(mesh, "data"), axis_index(mesh, "model")
    llm.params = shard_params(llm.params, n_model, m)
    llm.state = shard_state(llm.state, n_data, d, n_model, m)
    llm.mesh = mesh
    llm.seq_axis = seq_axis
    llm.shard = Shard(mesh, cfg, llm.batch_size, seq_axis)
    # Buffers and a captured step of the unsharded engine do not carry over.
    llm._stage_k = llm._stage_v = None
    llm._graph, llm._warmed_up = None, False
    if llm.device.type == "cuda":
        torch.cuda.empty_cache()
    return llm

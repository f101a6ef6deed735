"""Start the ranks of a multi-process run (the port's counterpart of
`jax.distributed.initialize` and of the JAX tests' virtual device mesh).

`launch(fn, world, ...)` spawns `world` processes (`torch.multiprocessing`
in "spawn" mode: a CUDA context cannot be forked), joins them in one
process group through a `file://` store in a fresh temporary directory (so
concurrent launches never race for a port), calls `fn(rank, *args)` in each
and returns the ranks' results in rank order. The backend is the caller's
choice: "gloo" on the CPU or on CUDA tensors (several ranks may share one
card), "nccl" on CUDA with one card per rank. The ranks run on the card
unless the caller asks for the CPU (`device="cpu"`), and a launch on the
card raises where there is none; CPU ranks run one torch thread each. A rank that raises or dies ends the launch: the others are
stopped and the error is raised in the caller.

`fn` must be a module-level function of a module that the child can import
without side effects, and its result a picklable host object (numpy
arrays, numbers, dicts), never a CUDA tensor.

Under `torchrun` the ranks already exist; `init_process(rank, world,
backend, store)` is what each rank here calls, and a caller with its own
launcher calls `torch.distributed.init_process_group` itself.
"""

from __future__ import annotations

import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("gloo", "nccl")


def rank_device(rank: int, device: str) -> torch.device:
    """Rank `rank`'s device: the CPU, or card rank % count (every rank of a
    one-card machine shares card 0)."""
    if device == "cpu":
        return torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA device is available")
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_process(rank: int, world: int, backend: str, store: str,
                 device: str = "cuda") -> torch.device:
    """Join the process group of `world` ranks through the file store
    `store` (a path that no earlier group used); returns the rank's
    device."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dev = rank_device(rank, device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            device_id=dev if backend == "nccl" else None)
    return dev


def _rank_main(rank, world, backend, store, device, results):
    try:
        with open(store + ".call", "rb") as f:
            fn, args = pickle.load(f)
        init_process(rank, world, backend, store, device)
        try:
            results.put((rank, True, fn(rank, *args)))
        finally:
            dist.destroy_process_group()
    except Exception:  # reported to the caller, which raises it
        results.put((rank, False, traceback.format_exc()))


def launch(fn, world: int, *args, backend: str = "gloo",
           device: str = "cuda", timeout: float = 600.0) -> list:
    """Run `fn(rank, *args)` on `world` spawned ranks; returns their
    results in rank order. `device` is "cuda" (the default) or "cpu";
    "nccl" needs as many cards as ranks."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    rank_device(0, device)              # raises on a bad or absent device
    if backend == "nccl" and (device != "cuda"
                              or torch.cuda.device_count() < world):
        raise ValueError("nccl takes one card per rank: use gloo to share "
                         "a card or to run on the CPU")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="mp_launch_")
    store = os.path.join(tmp, "store")
    # The call goes through a file: large arguments are slow to pass to a
    # spawned process through its start-up pipe.
    with open(store + ".call", "wb") as f:
        pickle.dump((fn, args), f)
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, backend, store, device, results),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    out: dict[int, object] = {}
    failure = None
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world and failure is None:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    failure = f"rank {dead[0]} exited with {procs[dead[0]].exitcode}"
                elif time.monotonic() > deadline:
                    failure = f"timed out after {timeout} s"
                continue
            if ok:
                out[rank] = value
            else:
                failure = f"rank {rank} raised:\n{value}"
        if failure is None:
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(f"launch of {world} ranks failed: {failure}")
    return [out[r] for r in range(world)]

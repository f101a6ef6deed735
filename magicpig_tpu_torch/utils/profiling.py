"""Tracing and step timing (port of `magicpig_tpu/utils/profiling.py`):
`torch.profiler` traces written as Chrome traces (chrome://tracing,
Perfetto), named regions inside them, and a step timer that reports as the
reference's bench does.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Profile the block with `torch.profiler` (host, and the card's kernels
    when CUDA is up) and write a Chrome trace `trace-<pid>-<ns>.json` under
    `log_dir`; yields the profiler, whose `key_averages()` the caller may
    read. With no `log_dir` it profiles nothing and yields None."""
    if not log_dir:
        yield None
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def annotate(name: str):
    """A named region of a trace (`torch.profiler.record_function`)."""
    return record_function(name)


class StepTimer:
    """Wall-clock step timer; reports like the reference's bench ("Decoding
    Latency ms/token" / "Decoding Throughput token/s"). With CUDA up, entry
    and exit synchronize the card, so that the window holds the device
    work of its steps and no other."""

    def __init__(self):
        self.t0 = None
        self.steps = 0
        self.elapsed = 0.0

    def __enter__(self):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.elapsed += time.perf_counter() - self.t0
        return False

    def step(self, n: int = 1):
        self.steps += n

    @property
    def ms_per_token(self) -> float:
        return 1000.0 * self.elapsed / max(self.steps, 1)

    @property
    def tokens_per_s(self) -> float:
        return self.steps / max(self.elapsed, 1e-9)

    def report(self, batch_size: int = 1) -> str:
        return (f"Decoding Latency {self.ms_per_token:.2f} ms/token | "
                f"Decoding Throughput "
                f"{self.tokens_per_s * batch_size:.2f} token/s")

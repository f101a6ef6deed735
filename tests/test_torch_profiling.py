"""`utils/profiling.py` against the JAX package's: a trace file that holds
the annotated region, no trace without a directory, and the step timer's
report string for the same elapsed time and steps."""

import json

import pytest
import torch

from magicpig_tpu.utils import profiling as jprofiling
from magicpig_tpu_torch.utils import profiling


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    log_dir = tmp_path / "traces"
    with profiling.trace(str(log_dir)) as prof:
        with profiling.annotate("serve.decode_step"):
            torch.ones(64, 64).matmul(torch.ones(64, 64))
    assert prof is not None
    (path,) = log_dir.glob("trace-*.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "serve.decode_step" for e in events)
    assert any(e.key == "serve.decode_step" for e in prof.key_averages())


@pytest.mark.parametrize("log_dir", [None, ""])
def test_trace_without_a_directory_writes_nothing(tmp_path, monkeypatch,
                                                  log_dir):
    monkeypatch.chdir(tmp_path)
    with profiling.trace(log_dir) as prof:
        torch.ones(8).sum()
    assert prof is None
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("elapsed,steps,batch", [
    (0.5, 16, 1), (1.2345, 7, 8), (0.0, 0, 2)])
def test_step_timer_reports_as_jax(elapsed, steps, batch):
    got, want = profiling.StepTimer(), jprofiling.StepTimer()
    for t in (got, want):
        t.elapsed, t.steps = elapsed, steps
    assert got.report(batch) == want.report(batch)
    assert got.ms_per_token == want.ms_per_token
    assert got.tokens_per_s == want.tokens_per_s


def test_step_timer_accumulates_windows():
    timer = profiling.StepTimer()
    for _ in range(2):
        with timer:
            torch.ones(256, 256).matmul(torch.ones(256, 256))
            timer.step(4)
    assert timer.steps == 8 and timer.elapsed > 0
    assert timer.report().startswith("Decoding Latency ")

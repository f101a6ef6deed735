"""The port's RULER harness (`magicpig_tpu_torch/evals/ruler/`) against the
JAX package's, on the CPU: the 13 task generators sample for sample, the
string-match metrics and the scorer, and `predict_task` on the trained
byte-level model `data/ruler_lm_v2.npz` in f32 under full attention, TopK
and Quest, whose greedy predictions must be JAX's string for string.

The two needle-haystack tasks (niah_multikey_2 and _3) build 64 001 needle
lines a sample whatever the length (about 2 s each); they are held at the
eval's own seed and length here, and at the other seeds and lengths by the
test marked slow.
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from magicpig_tpu.config import LSHConfig as JLSHConfig
from magicpig_tpu.evals.ruler import predict as jpredict
from magicpig_tpu.evals.ruler import score as jscore
from magicpig_tpu.evals.ruler import tasks as jtasks
from magicpig_tpu.runtime.engine import LLM as JLLM
from magicpig_tpu.utils.tokenizer import ByteTokenizer as JByteTokenizer
from magicpig_tpu_torch.config import LSHConfig
from magicpig_tpu_torch.evals import ruler
from magicpig_tpu_torch.evals.ruler import predict as tpredict
from magicpig_tpu_torch.evals.ruler import score as tscore
from magicpig_tpu_torch.models.convert import load_params
from magicpig_tpu_torch.runtime.engine import LLM
from magicpig_tpu_torch.utils.tokenizer import ByteTokenizer

ROOT = Path(__file__).resolve().parent.parent
NPZ = ROOT / "data" / "ruler_lm_v2.npz"
NEEDLE_TASKS = ("niah_multikey_2", "niah_multikey_3")
CONFIGS = [(7, 300), (7, 1152), (42, 300), (42, 1152)]   # (seed, target)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: beside the
    other test workers, torch's default of one thread a core oversubscribes
    the host and a greedy decode loop slows by an order of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same_samples(task, seed, target, n):
    got = ruler.generate_task(task, n, target, seed=seed)
    want = jtasks.generate_task(task, n, target, seed=seed)
    assert got == want, (task, seed, target)


def test_suite_and_task_specs_equal_jax():
    assert list(ruler.TASK_SUITE) == list(jtasks.TASK_SUITE)
    for name, spec in ruler.TASK_SUITE.items():
        want = jtasks.TASK_SUITE[name]
        assert (spec.args, spec.metric, spec.tokens_to_generate) == (
            want.args, want.metric, want.tokens_to_generate), name


@pytest.mark.parametrize("task", sorted(jtasks.TASK_SUITE))
def test_generators_match_jax(task):
    """Every sample's input, outputs, length and answer prefix equal JAX's,
    at two seeds and two lengths (needle haystacks: the eval's seed and
    length, one sample)."""
    if task in NEEDLE_TASKS:
        _same_samples(task, 42, 1152, 1)
        return
    for seed, target in CONFIGS:
        _same_samples(task, seed, target, 2)


@pytest.mark.slow
@pytest.mark.parametrize("task", NEEDLE_TASKS)
def test_needle_generators_match_jax_at_every_seed_and_length(task):
    for seed, target in CONFIGS:
        _same_samples(task, seed, target, 2)


def test_string_match_and_scoring_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    words = ["Alpha", "beta", "12345", "uuid-x", "gamma", ""]
    preds = [" ".join(rng.choice(words, 3)) for _ in range(40)]
    refs = [list(rng.choice(words[:5], rng.integers(1, 4))) for _ in range(40)]
    for name in ("string_match_all", "string_match_part"):
        assert getattr(tscore, name)(preds, refs) == getattr(jscore, name)(preds, refs)
    path = tmp_path / "t.jsonl"
    path.write_text("".join(json.dumps({"index": i, "pred": p, "outputs": r}) + "\n"
                            for i, (p, r) in enumerate(zip(preds, refs))))
    for metric in ("string_match_all", "string_match_part"):
        assert (tscore.score_predictions(str(path), metric)
                == jscore.score_predictions(str(path), metric))
    results = {"a": {"score": 50.0, "n": 2, "nulls": 1},
               "b": {"score": 12.5, "n": 2, "nulls": 0}}
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    got = Path(tscore.write_summary(results, str(tmp_path / "t"))).read_text()
    assert got == Path(jscore.write_summary(results, str(tmp_path / "j"))).read_text()


def _jax_model():
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        from train_ruler_lm import load_params as j_load_params
        from train_ruler_lm import model_config
    finally:
        sys.path.remove(str(ROOT / "examples"))
    return model_config(), j_load_params


def test_model_config_equals_train_ruler_lm():
    jc, _ = _jax_model()
    tc = ruler.model_config()
    for f in dataclasses.fields(tc):
        if f.name != "dtype":
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.dtype == torch.float32


MAX_LEN = 1152       # prompts of ~1000 byte tokens: cut to 1023 for niah


@pytest.mark.parametrize("estimator", ["full", "topk", "quest"])
def test_predict_task_matches_jax_on_the_trained_model(tmp_path, estimator):
    """Two samples each of niah_single_1 and vt (target 450: ~1000-token
    prompts, niah's cut from the front to 1023) through both packages'
    `predict_task` with one engine each: every prediction string equal,
    the scores equal, the per-task sparsity within 1% (JAX decodes in
    chunks of 16 steps and counts the steps past the end, the port one
    step a token)."""
    jc, j_load_params = _jax_model()
    tc = ruler.model_config()
    kw = dict(K=0) if estimator == "full" else dict(K=10, estimator=estimator)
    jl = JLLM(jc, batch_size=1, max_length=MAX_LEN, seed=0,
              lsh=JLSHConfig(L=150, **kw),
              params=j_load_params(str(NPZ), jc, MAX_LEN))
    tl = LLM(tc, batch_size=1, max_length=MAX_LEN, seed=0, device="cpu",
             lsh=LSHConfig(L=150, **kw),
             params=load_params(NPZ, tc, MAX_LEN, device="cpu"))
    for task in ("niah_single_1", "vt"):
        runs = []
        for pkg, llm, tok in ((jpredict, jl, JByteTokenizer()),
                              (tpredict, tl, ByteTokenizer())):
            out = tmp_path / f"{pkg.__name__}_{task}.jsonl"
            result = pkg.predict_task(llm, tok, task, str(out), num_samples=2,
                                      target_tokens=450, seed=42, verbose=False)
            rows = [json.loads(line) for line in out.read_text().splitlines()]
            runs.append((result, [(r["index"], r["pred"], r["input_tokens"])
                                  for r in rows]))
        (jres, jrows), (tres, trows) = runs
        assert trows == jrows, task
        assert trows[0][2] > 900
        assert (tres["score"], tres["n"], tres["nulls"]) == (
            jres["score"], jres["n"], jres["nulls"])
        assert tres["avg_sparsity"] == pytest.approx(jres["avg_sparsity"],
                                                     rel=1e-2, abs=1e-12)
        if estimator != "full":
            assert 0 < tres["avg_sparsity"] < 0.2

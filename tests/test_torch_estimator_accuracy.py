"""The needle-accuracy eval of the port (`evals/needle.py`,
`examples/estimator_accuracy_torch.py`) against the JAX package's
`examples/estimator_accuracy.py`, on the CPU in float32 with the trained
weights of `data/needle_ckpt.npz`.

The haystacks are equal array for array; the estimator configs field for
field; at 1024 tokens on 8 samples, full attention, TopK, Quest and
block_topk predict the JAX engine's tokens probe for probe. LSH draws its
own hash projections in each package (different generators), so its
accuracy is held to a band: the LSH rows of `results/estimator_accuracy/`
lie within 0.04 of full attention at n = 150, and on 8 samples one probe
is 0.125, so the port's LSH accuracy must lie within 0.25 (two probes) of
the JAX engine's.
"""

import dataclasses
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from magicpig_tpu_torch.evals import needle
from magicpig_tpu_torch.models.convert import load_params
from magicpig_tpu_torch.runtime.engine import LLM

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "data" / "needle_ckpt.npz"
CTX, N_SAMPLES, SEED = 1024, 8, 7
EXACT = ("full", "topk_2pct", "quest_4pct", "block_topk_8pct")
LSH = "lsh_K10L150"
LSH_BAND = 0.25


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's engines: beside the other test
    workers, torch's default of one thread a core oversubscribes the host
    (this file took 316 s of one worker in a full run without it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_eval():
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import estimator_accuracy as jea
        import train_needle as jtn
    finally:
        sys.path.remove(str(ROOT / "examples"))
    return jea, jtn


@pytest.mark.parametrize("task,n_needles", [("single", 2), ("multiquery", 3),
                                            ("hop", 2)])
def test_samples_equal_jax(task, n_needles):
    jea, _ = _jax_eval()
    for ctx in (1024, 2048):
        rng_j = np.random.default_rng(SEED + ctx)
        rng_t = np.random.default_rng(SEED + ctx)
        for _ in range(5):
            jt, jq = jea.make_eval_sample(rng_j, ctx, n_needles, task=task)
            tt, tq = needle.make_eval_sample(rng_t, ctx, n_needles, task=task)
            np.testing.assert_array_equal(tt, jt)
            assert tt.dtype == jt.dtype
            assert tq == jq


def test_vocabulary_and_model_config_equal_jax():
    _, jtn = _jax_eval()
    for name in ("PAD", "BOS", "MARK", "QUERY", "QUERY2", "FILLER_LO",
                 "FILLER_HI", "KEY_LO", "KEY_HI", "VAL_LO", "VAL_HI", "VOCAB"):
        assert getattr(needle, name) == getattr(jtn, name), name
    jc, tc = jtn.model_config(), needle.model_config()
    for f in dataclasses.fields(tc):
        if f.name != "dtype":
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name


def test_estimator_configs_equal_jax():
    jea, _ = _jax_eval()
    jcfg, tcfg = jea.estimator_configs(10, 150), needle.estimator_configs(10, 150)
    assert list(tcfg) == list(jcfg)
    for name, tc in tcfg.items():
        jc = jcfg[name]
        for f in dataclasses.fields(tc):
            assert getattr(tc, f.name) == getattr(jc, f.name), (name, f.name)


@pytest.fixture(scope="module")
def predictions():
    """Each package's greedy token per probe, for EXACT and LSH (the port's
    engines run in two more threads, one torch thread each, while the JAX
    engines run)."""
    import jax.numpy as jnp

    jea, jtn = _jax_eval()
    from magicpig_tpu.runtime.engine import LLM as JLLM

    rng = np.random.default_rng(SEED + CTX)
    samples = [needle.make_eval_sample(rng, CTX, 2) for _ in range(N_SAMPLES)]
    max_len = CTX + 256
    names = (*EXACT, LSH)

    tparams = load_params(CKPT, needle.model_config(), max_len, device="cpu")
    tcfg = needle.estimator_configs(10, 150)

    def port(some):
        torch.set_num_threads(1)        # this thread's own OpenMP setting
        out = {}
        for name in some:
            tl = LLM(needle.model_config(), batch_size=1, max_length=max_len,
                     chunk_size=CTX, params=tparams, lsh=tcfg[name],
                     device="cpu")
            out[name] = [t for toks, queries in samples
                         for t in needle.probe(tl, toks, queries)[1]]
        return out

    with ThreadPoolExecutor(2) as pool:
        port_preds = [pool.submit(port, names[i::2]) for i in range(2)]
        jparams = jtn.load_params(str(CKPT), jtn.model_config(jnp.float32),
                                  max_len)
        jcfg = jea.estimator_configs(10, 150)
        jax_preds = {}
        for name in names:
            jl = JLLM(jtn.model_config(jnp.float32), batch_size=1,
                      max_length=max_len, chunk_size=CTX, params=jparams,
                      lsh=jcfg[name], seed=0)
            jp = jax_preds[name] = []
            for toks, queries in samples:
                jl.release_slot(0)
                jl.prefill(toks, request_id=0)
                for marker, key, _ in queries:
                    jl.inference(np.asarray([marker], np.int32))
                    logits = jl.inference(np.asarray([key], np.int32))
                    jp.append(int(np.asarray(logits)[0].argmax()))
        port_preds = {k: v for f in port_preds for k, v in f.result().items()}
    values = np.asarray([v for _, qs in samples for _, _, v in qs])
    return {name: (np.asarray(port_preds[name]), np.asarray(jax_preds[name]),
                   values) for name in names}


@pytest.mark.parametrize("name", EXACT)
def test_predictions_equal_jax(predictions, name):
    tp, jp, _ = predictions[name]
    np.testing.assert_array_equal(tp, jp)


def test_lsh_accuracy_within_band(predictions):
    tp, jp, values = predictions[LSH]
    t_acc, j_acc = (tp == values).mean(), (jp == values).mean()
    assert abs(t_acc - j_acc) <= LSH_BAND, (t_acc, j_acc)


@pytest.mark.slow
def test_full_attention_at_8192_reproduces_jax():
    """Full attention at 8192 tokens on `--samples 150`'s haystacks: the
    JAX engine on the CPU in f32 over all 150 (its accuracy printed, to
    set beside the card's row and the TPU's), and the port predicting its
    tokens probe for probe on the first 40 (~30 min)."""
    import jax.numpy as jnp

    jea, jtn = _jax_eval()
    from magicpig_tpu.runtime.engine import LLM as JLLM

    ctx, n, n_port = 8192, 150, 40
    rng = np.random.default_rng(SEED + ctx)
    samples = [needle.make_eval_sample(rng, ctx, 2) for _ in range(n)]
    values = np.asarray([v for _, qs in samples for _, _, v in qs])
    max_len = ctx + 256
    jl = JLLM(jtn.model_config(jnp.float32), batch_size=1, max_length=max_len,
              chunk_size=2048,
              params=jtn.load_params(str(CKPT), jtn.model_config(jnp.float32),
                                     max_len),
              lsh=jea.estimator_configs(10, 150)["full"], seed=0)
    jp = []
    for toks, queries in samples:
        jl.release_slot(0)
        jl.prefill(toks, request_id=0)
        for marker, key, _ in queries:
            jl.inference(np.asarray([marker], np.int32))
            logits = jl.inference(np.asarray([key], np.int32))
            jp.append(int(np.asarray(logits)[0].argmax()))
    torch.set_num_threads(8)
    tl = LLM(needle.model_config(), batch_size=1, max_length=max_len,
             chunk_size=2048,
             params=load_params(CKPT, needle.model_config(), max_len,
                                device="cpu"),
             lsh=needle.estimator_configs(10, 150)["full"], device="cpu")
    tp = [p for toks, queries in samples[:n_port]
          for p in needle.probe(tl, toks, queries)[1]]
    j_acc = float((np.asarray(jp) == values).mean())
    t_acc = float((np.asarray(tp) == values[:n_port]).mean())
    print(f"JAX full at {ctx}: {j_acc:.4f} over {n}; port {t_acc:.4f} over "
          f"the first {n_port}, JAX {np.mean(np.asarray(jp[:n_port]) == values[:n_port]):.4f}")
    np.testing.assert_array_equal(tp, jp[:n_port])

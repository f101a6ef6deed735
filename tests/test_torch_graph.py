"""The port's engine around its compiled decode step, on the CPU.

On the card `LLM.inference` and `LLM.decode_steps` replay a CUDA graph of
one decode step (`runtime/engine.py`, `DecodeGraph`); these tests hold what
that needs and what stays of it on the CPU, at `llama-tiny` size: `clear()`
resets the state in place (every buffer keeps its address, and the state
equals a fresh one), decoding after it still matches the JAX engine, the
sparsity snapshot is not moved by later steps, the launch accounting of a
capture, a CPU engine that never touches `torch.cuda.graph`, and logits
that the next step does not overwrite. The graph itself runs only on the
card (`tests/test_torch_graph_cuda.py`).

Tolerances: float32 prefill logits against JAX 1e-4
(`tests/test_torch_engine.py`'s F32), greedy tokens exactly, the sampled fraction 2e-3 (the two frameworks
round the model's float32 products differently, so a SimHash sign at
rounding scale may flip); the port against itself exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicpig_tpu.config import LSHConfig as JLSHConfig
from magicpig_tpu.config import preset as jpreset
from magicpig_tpu.models import llama as jllama
from magicpig_tpu.runtime.engine import LLM as JLLM
from magicpig_tpu_torch.config import LSHConfig, preset
from magicpig_tpu_torch.models.convert import params_from_numpy
from magicpig_tpu_torch.ops.kernels import LAUNCHES, _lib
from magicpig_tpu_torch.runtime import state as tstate
from magicpig_tpu_torch.runtime.engine import LLM

F32 = 1e-4
MAX_LEN = 512
LSH_KW = dict(K=10, L=150, num_sink_tokens=4, num_local_tokens=16,
              generation_buffer=32)
JCFG = dataclasses.replace(jpreset("llama-tiny"), dtype=jnp.float32)
TCFG = dataclasses.replace(preset("llama-tiny"), dtype=torch.float32)

# The state layouts of the engine: each estimator, cache type and the dense
# (K=0) engine.
LAYOUTS = {
    "lsh": LSHConfig(**LSH_KW),
    "lsh_int8": LSHConfig(**LSH_KW, offload_quant="int8"),
    "lsh_sampled": LSHConfig(**LSH_KW, decode_mode="sampled"),
    "block_topk_int8": LSHConfig(**LSH_KW, estimator="block_topk",
                                 offload_quant="int8",
                                 block_topk_block_size=16),
    "block_topk_int4": LSHConfig(**LSH_KW, estimator="block_topk",
                                 offload_quant="int4",
                                 block_topk_block_size=16),
    "dense": LSHConfig(K=0, L=0),
    "dense_int8": LSHConfig(K=0, L=0, dense_quant="int8"),
}


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(
        1, TCFG.vocab_size, n).astype(np.int32)


def _state_tensors(state):
    for field in dataclasses.fields(state):
        value = getattr(state, field.name)
        for i, t in enumerate(value if isinstance(value, list) else [value]):
            yield f"{field.name}[{i}]", t


@pytest.fixture(scope="module")
def weights():
    """JAX llama-tiny weights, and the same weights as the port's params."""
    jp = jllama.init_params(JCFG, jax.random.key(0), MAX_LEN)
    tree = dataclasses.asdict(jax.tree_util.tree_map(np.asarray, jp))
    return jp, params_from_numpy(tree, device="cpu")


@pytest.fixture(scope="module")
def bank():
    return np.random.default_rng(42).standard_normal(
        (TCFG.head_dim, LSH_KW["K"] * LSH_KW["L"])).astype(np.float32)


def _engine(weights, bank, lsh=LAYOUTS["lsh"], batch_size=1):
    return LLM(TCFG, batch_size=batch_size, max_length=MAX_LEN,
               params=weights[1], lsh=lsh, projections=torch.from_numpy(bank),
               device="cpu")


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_clear_keeps_buffers_and_equals_a_fresh_state(weights, bank, layout):
    """After two prefills and three steps, clear() leaves every state
    tensor at its address and equal to `init_state`'s."""
    lsh = LAYOUTS[layout]
    eng = _engine(weights, bank, lsh, batch_size=2)
    before = {name: t.data_ptr() for name, t in _state_tensors(eng.state)}
    for req, n in enumerate((200, 150)):
        eng.prefill(_prompt(req, n), request_id=req)
    eng.decode_steps([1, 2], 3)
    assert any(t.any() for _, t in _state_tensors(eng.state))
    eng.clear()
    fresh = dict(_state_tensors(tstate.init_state(TCFG, lsh, 2, MAX_LEN, "cpu")))
    got = dict(_state_tensors(eng.state))
    assert got.keys() == fresh.keys() == before.keys()
    for name, t in got.items():
        assert t.data_ptr() == before[name], name
        assert t.dtype == fresh[name].dtype and torch.equal(t, fresh[name]), name


def test_decoding_after_clear_matches_jax(weights, bank):
    """A request decoded, clear(), another prefilled and decoded greedily:
    the second request's prefill logits and greedy tokens are the JAX
    engine's (decode logits differ by the debias weight, whose JAX float32
    form cancels: `tests/test_torch_engine.py`)."""
    jp, _ = weights
    jl = JLLM(JCFG, max_length=MAX_LEN, chunk_size=64, params=jp,
              lsh=JLSHConfig(**LSH_KW))
    jl.projections = jnp.asarray(bank)
    tl = _engine(weights, bank)
    for eng in (jl, tl):
        first = np.asarray(eng.prefill(_prompt(6, 240)))[0].argmax()
        eng.decode_steps([int(first)], 3)
        eng.clear()
    jlogits = np.asarray(jl.prefill(_prompt(7, 260)))
    tlogits = tl.prefill(_prompt(7, 260)).numpy()
    np.testing.assert_allclose(tlogits, jlogits, atol=F32, rtol=F32)
    jt, tt = [int(jlogits[0].argmax())], [int(tlogits[0].argmax())]
    for _ in range(6):
        jt.append(int(np.asarray(jl.inference(np.asarray([jt[-1]])))[0].argmax()))
        tt.append(int(tl.inference(torch.tensor([tt[-1]]))[0].argmax()))
    assert tt == jt
    assert tl.avg_sparsity == pytest.approx(jl.avg_sparsity, abs=2e-3)


def test_sparsity_snapshot_is_not_moved_by_later_steps(weights, bank):
    """A snapshot keeps its value through later steps, and
    `avg_sparsity_since` is the mean of the steps' fractions since it, as
    the eager step reports them on a twin engine."""
    eng, twin = _engine(weights, bank), _engine(weights, bank)
    for e in (eng, twin):
        e.prefill(_prompt(8, 300))
    eng.decode_steps([5], 2)
    snap = eng.sparsity_snapshot()
    held = snap[0].clone()
    eng.decode_steps([9], 3)
    eng.inference(torch.tensor([11]))
    assert torch.equal(snap[0], held)
    fracs = []
    for first, n in ((5, 2), (9, 3), (11, 1)):
        tok = torch.tensor([first])
        for _ in range(n):
            logits, frac = twin._decode(tok)
            tok = logits.argmax(-1)
            fracs.append(frac)
    want = sum(float(f) for f in fracs[2:]) / 4
    assert eng.avg_sparsity_since(snap) == pytest.approx(want, rel=1e-6)
    assert 0 < want < 1


def test_captured_launches_are_taken_out_and_added_per_replay(monkeypatch):
    """Driven directly: what a capture counted leaves `LAUNCHES` and
    `W4_SHAPE_LAUNCHES` when the capture ends, and each replay adds it
    once; counts from outside the capture stay."""
    monkeypatch.setattr(_lib, "LAUNCHES", dict.fromkeys(LAUNCHES, 0))
    monkeypatch.setattr(_lib, "W4_SHAPE_LAUNCHES", {"2048x3072": 4})
    launches, shapes = _lib.LAUNCHES, _lib.W4_SHAPE_LAUNCHES
    launches["flash_decode"] = 7
    with _lib.CapturedLaunches() as captured:
        launches["flash_decode"] += 3
        launches["lsh_fused_decode"] += 2
        shapes["2048x3072"] += 1
        shapes["2048x128256"] = 1
    assert launches == {**dict.fromkeys(LAUNCHES, 0), "flash_decode": 7}
    assert shapes == {"2048x3072": 4}
    for _ in range(2):
        captured.replayed()
    assert launches == {**dict.fromkeys(LAUNCHES, 0), "flash_decode": 13,
                        "lsh_fused_decode": 4}
    assert shapes == {"2048x3072": 6, "2048x128256": 2}
    _lib.reset_launches()
    captured.replayed()
    assert launches == {**dict.fromkeys(LAUNCHES, 0), "flash_decode": 3,
                        "lsh_fused_decode": 2}
    assert shapes == {"2048x3072": 1, "2048x128256": 1}


def _no_graph(*args, **kwargs):
    raise AssertionError("a CPU engine touched torch.cuda's graphs")


@pytest.mark.parametrize("entry", ["inference", "decode_steps", "generate"])
def test_cpu_engine_never_captures(weights, bank, monkeypatch, entry):
    """Through each entry point, several steps on a CPU engine run
    eagerly: torch.cuda.graph and CUDAGraph are never touched."""
    monkeypatch.setattr(torch.cuda, "graph", _no_graph)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _no_graph)
    eng = _engine(weights, bank)
    if entry == "generate":
        assert len(eng.generate(_prompt(9, 200), max_tokens=4,
                                temperature=0.0)) == 4
    else:
        tok = int(eng.prefill(_prompt(9, 200))[0].argmax())
        for _ in range(3):
            if entry == "inference":
                tok = int(eng.inference(torch.tensor([tok]))[0].argmax())
            else:
                tok = int(eng.decode_steps([tok], 2)[-1, 0])
    assert eng._graph is None


def test_inference_logits_survive_the_next_step(weights, bank):
    """The logits one step returns are unchanged by the next steps."""
    eng = _engine(weights, bank)
    tok = int(eng.prefill(_prompt(10, 220))[0].argmax())
    kept = []
    for _ in range(3):
        logits = eng.inference(torch.tensor([tok]))
        kept.append((logits, logits.clone()))
        tok = int(logits[0].argmax())
    for logits, copy in kept:
        assert torch.equal(logits, copy)
    assert not torch.equal(kept[0][1], kept[1][1])

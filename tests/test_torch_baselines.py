"""The reference's accuracy baselines (Quest, TopK, OracleSampling) in the
port against the JAX package's, on the CPU: the functions of
`ops/baselines.py`, the Quest fill, one sparse layer of each estimator
through both attention servers, and the `llama-tiny` engines.

Tolerances: landmarks and fills exactly; `quest_decode` and `topk_decode`
1e-5 with f32 inputs and 2e-3 with bf16 ones (the products are exact in
f32 in both packages, only the order of the sums differs); oracle
sampling's LSE 1e-5, its output statistically (the port draws by a
counter-based hash on the device, JAX by its PRNG, so the two draw
different ids); one sparse layer 1e-5 (2e-2 with int8 offload, as
tests/test_torch_block_topk.py holds int8 layers); engines in f32 1e-4 of
the largest logit, greedy tokens and the realized fraction equal; at
full budget the engines track the K=0 engine within 2e-3 (0.15 for oracle
sampling), the tolerances of tests/test_engine.py:170-200.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicpig_tpu.config import LSHConfig as JLSHConfig
from magicpig_tpu.config import preset as jpreset
from magicpig_tpu.models import llama as jllama
from magicpig_tpu.ops import baselines as jb
from magicpig_tpu.runtime import server as jserver
from magicpig_tpu.runtime import state as jstate
from magicpig_tpu.runtime.engine import LLM as JLLM
from magicpig_tpu_torch.config import LSHConfig, preset
from magicpig_tpu_torch.models.convert import params_from_numpy
from magicpig_tpu_torch.ops import attention as tattn
from magicpig_tpu_torch.ops import baselines as tb
from magicpig_tpu_torch.runtime import server as tserver
from magicpig_tpu_torch.runtime import state as tstate
from magicpig_tpu_torch.runtime.engine import LLM

MAX_LEN = 512
BASE_KW = dict(K=10, L=0, num_sink_tokens=4, num_local_tokens=16,
               generation_buffer=32)
JCFG = dataclasses.replace(jpreset("llama-tiny"), dtype=jnp.float32)
TCFG = dataclasses.replace(preset("llama-tiny"), dtype=torch.float32)
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-3}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: beside the
    other test workers, torch's default of one thread a core oversubscribes
    the host and a greedy decode loop slows by an order of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _inputs(seed, b, hq, hkv, s, d, dtype):
    """q [B, Hq, d], k, v [B, Hkv, S, d] as torch tensors of `dtype` and
    the same values as JAX arrays."""
    rng = np.random.default_rng(seed)
    t = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
         for shape in ((b, hq, d), (b, hkv, s, d), (b, hkv, s, d))]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return t, [jnp.asarray(x.float().numpy()).astype(jdt) for x in t]


# -- the functions -------------------------------------------------------------

LENGTHS = [(160, 165), (161, 256), (1, 0)]   # on, inside and past a page


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quest_landmarks_equal_jax(dtype):
    (_, k, _), (_, jk, _) = _inputs(0, 2, 4, 2, 128, 64, dtype)
    for got, want in zip(tb.quest_landmarks(k, 16), jb.quest_landmarks(jk, 16)):
        assert got.dtype == dtype and got.shape == (2, 2, 8, 64)
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 3, 4])
def test_quest_and_topk_decode_match_jax(dtype, d, g):
    hkv, s, page = 2, 256, 16
    (q, k, v), (jq, jk, jv) = _inputs(d + g, 2, g * hkv, hkv, s, d, dtype)
    kmin, kmax = tb.quest_landmarks(k, page)
    jmin, jmax = jb.quest_landmarks(jk, page)
    tol = TOL[dtype]
    for lens in LENGTHS:
        length, jlength = torch.tensor(lens), jnp.asarray(lens, jnp.int32)
        for got, want in (
                (tb.quest_decode(q, k, v, kmin, kmax, length, page, 5),
                 jb.quest_decode(jq, jk, jv, jmin, jmax, jlength, page, 5)),
                (tb.topk_decode(q, k, v, length, 13),
                 jb.topk_decode(jq, jk, jv, jlength, 13))):
            for a, w in zip(got, want):
                np.testing.assert_allclose(_np(a), _np(w), rtol=tol, atol=tol)


def test_quest_selects_the_pages_jax_selects():
    """Quest's token mask equals the one JAX's page ranking gives (its
    [B, Hkv, G, budget, S] comparison recomputed here), and TopK keeps
    every token tied with the n-th score."""
    hkv, s, page, pages = 2, 256, 16, 5
    (q, k, _), _ = _inputs(3, 2, 8, hkv, s, 64, torch.float32)
    length = torch.tensor([200, 37])
    kmin, kmax = tb.quest_landmarks(k, page)
    mask = tb.quest_select(q, kmin, kmax, length, page, pages, s)
    qh = _np(q).reshape(2, hkv, 4, 64)
    lo, hi = _np(kmin), _np(kmax)
    bound = np.maximum(qh[..., None, :] * lo[:, :, None],
                       qh[..., None, :] * hi[:, :, None]).sum(-1)
    for b, n in enumerate((200, 37)):
        bound[b, ..., -(-n // page):] = -np.inf
    top = np.argsort(-bound, axis=-1, kind="stable")[..., :pages]
    want = np.zeros(mask.shape, bool)
    for idx in np.ndindex(*top.shape[:3]):
        for p in top[idx]:
            want[idx + (slice(p * page, (p + 1) * page),)] = True
    want &= np.arange(s) < np.array([200, 37])[:, None, None, None]
    np.testing.assert_array_equal(mask.numpy(), want)
    scores = torch.tensor([[[[3.0, 1.0, 2.0, 2.0, -np.inf]]]])
    assert tb.topk_select(scores, 3).tolist() == [[[[True, False, True, True,
                                                     False]]]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_oracle_sampling_lse_and_convergence(dtype):
    """The LSE equals JAX's; the ids are a function of (seed, step, layer)
    only, new at each step; the mean of the output over steps converges to
    full attention, and the ids' frequencies to the softmax."""
    hkv, s, n = 2, 128, 1024
    (q, k, v), (jq, jk, jv) = _inputs(2, 1, 4, hkv, s, 16, dtype)
    length = torch.tensor([100])
    _, jlse = jb.oracle_sampling_decode(jax.random.key(0), jq, jk, jv,
                                        jnp.asarray([100], jnp.int32), n)
    outs = []
    for step in range(16):
        u = tb.counter_uniforms(tb.OS_SEED, torch.tensor(step, dtype=torch.int32),
                                1, (1, hkv, 2, n))
        out, lse = tb.oracle_sampling_decode(q, k, v, length, n, u)
        np.testing.assert_allclose(_np(lse), _np(jlse), rtol=1e-5, atol=1e-5)
        outs.append(_np(out))
    again = tb.counter_uniforms(tb.OS_SEED, torch.tensor(15, dtype=torch.int32),
                                1, (1, hkv, 2, n))
    assert torch.equal(again, u)
    other = tb.counter_uniforms(tb.OS_SEED, torch.tensor(15, dtype=torch.int32),
                                2, (1, hkv, 2, n))
    assert not torch.equal(other, u)
    assert not np.array_equal(outs[0], outs[1])
    full, _ = tattn.full_decode(q, k, v, length)
    full = _np(full)
    # The mean of 16 * n draws: each head's squared error has expectation
    # (E_p |v|^2 - |E_p v|^2) / (16 n); hold every head within 3 sigma.
    scores = tb.masked_scores(q, k, length)
    p = torch.softmax(scores, dim=-1)
    vf = _np(v)[:, :, None]                                   # [B, Hkv, 1, S, d]
    second = (_np(p)[..., None] * vf ** 2).sum((-2, -1)).reshape(1, 4)
    var = (second - (full ** 2).sum(-1)) / (16 * n)
    err2 = ((np.mean(outs, 0) - full) ** 2).sum(-1)
    assert (err2 < 9 * var).all(), (err2, var)
    ids = tb.sample_ids(scores, u)
    assert int(ids.max()) < 100
    freq = torch.zeros_like(p).scatter_add_(-1, ids, torch.ones(ids.shape))
    assert float((freq / n - p).abs().sum(-1).max()) < 0.3
    # A head with no valid key draws the last row and weighs 0.
    out, lse = tb.oracle_sampling_decode(q, k, v, torch.tensor([0]), n, u)
    assert torch.isneginf(lse).all() and torch.isfinite(out).all()


# -- the attention server --------------------------------------------------------

_jfill_sparse = jax.jit(jserver.fill_sparse_layer, static_argnums=(1, 7))
_jdecode_sparse = jax.jit(jserver.decode_sparse_layer, static_argnums=(1, 6))


def _bf16_values(rng, shape):
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(torch.bfloat16).float().numpy()


def _filled(estimator, quant, **kw):
    """Both servers' states after filling requests of 300 and 120 tokens
    into sparse layer 1: (JAX config, state, port config, state, rng)."""
    kw = dict(BASE_KW, estimator=estimator, offload_quant=quant, **kw)
    jl, tl = JLSHConfig(**kw), LSHConfig(**kw)
    js = jstate.init_state(JCFG, jl, 2, MAX_LEN)
    ts = tstate.init_state(TCFG, tl, 2, MAX_LEN, "cpu")
    hkv, d = TCFG.num_key_value_heads, TCFG.head_dim
    rng = np.random.default_rng(0)
    for req, p in enumerate((300, 120)):
        k, v = _bf16_values(rng, (p, hkv, d)), _bf16_values(rng, (p, hkv, d))
        pad = np.zeros((320 - p, hkv, d), np.float32)
        js = _jfill_sparse(js, 1, jnp.int32(req),
                           jnp.asarray(np.concatenate([k, pad])),
                           jnp.asarray(np.concatenate([v, pad])),
                           jnp.int32(p), jnp.zeros((d, 1)), jl)
        tserver.fill_sparse_layer(ts, 1, req, torch.from_numpy(k),
                                  torch.from_numpy(v), None, tl)
    return jl, js, tl, ts, rng


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_quest_fill_matches_jax(quant):
    _, js, _, ts, _ = _filled("quest", quant)
    assert ts.quest_min[1].shape == js.quest_min[1].shape == (2, 2, 32, 16)
    assert ts.quest_min[1].dtype == torch.float32
    for name in ("quest_min", "quest_max"):
        np.testing.assert_array_equal(_np(getattr(ts, name)[1]),
                                      _np(getattr(js, name)[1]))
    np.testing.assert_array_equal(_np(ts.off_len), _np(js.off_len))
    assert not ts.planes and not ts.k_norm and len(ts.quest_min) == 2
    # Past each length: the page holding it bounded by its valid rows,
    # the pages after it +-max.
    big = np.finfo(np.float32).max
    assert (_np(ts.quest_min[1])[1, :, 7:] == big).all()   # 100 rows: 7 pages
    assert (_np(ts.quest_max[1])[1, :, 7:] == -big).all()
    assert (np.abs(_np(ts.quest_min[1])[1, :, 6]) < 10).all()


@pytest.mark.parametrize("estimator,quant", [
    ("quest", "none"), ("quest", "int8"), ("topk", "none"), ("topk", "int8"),
    ("topk", "int4"), ("oracle_sampling", "none")])
def test_sparse_layer_decode_matches_jax(estimator, quant):
    """Fill and two decode steps of one sparse layer in both servers at a
    quarter budget, the realized fraction exactly. Oracle sampling (512
    draws over 280 and 100 offloaded tokens) draws other ids than JAX: each
    server's output is held to the exact layer (TopK at full budget on a
    copy of the port's state), the port's RMS error within 1.5x JAX's."""
    budget = dict(quest_budget_frac=0.25, topk_budget_frac=0.25,
                  os_budget_frac=8.0 if estimator == "oracle_sampling" else 0.25)
    jl, js, tl, ts, rng = _filled(estimator, quant, **budget)
    exact = dataclasses.replace(tl, estimator="topk", topk_budget_frac=1.0)
    d = TCFG.head_dim
    for _ in range(2):
        q = _bf16_values(rng, (2, TCFG.num_attention_heads, d))
        kn = _bf16_values(rng, (2, TCFG.num_key_value_heads, d))
        vn = _bf16_values(rng, (2, TCFG.num_key_value_heads, d))
        args = [torch.from_numpy(x) for x in (q, kn, vn)]
        ref, _ = tserver.decode_sparse_layer(copy.deepcopy(ts), 1, *args,
                                             None, exact)
        jo, js, jfrac = _jdecode_sparse(js, 1, jnp.asarray(q), jnp.asarray(kn),
                                        jnp.asarray(vn), jnp.zeros((d, 1)), jl)
        to, tfrac = tserver.decode_sparse_layer(ts, 1, *args, None, tl)
        ts.hot_len += 1
        js = js.replace(hot_len=js.hot_len + 1)
        assert float(tfrac) == float(jfrac) and 0 < float(tfrac) <= 1
        if estimator == "oracle_sampling":
            rms = [float(np.sqrt(((_np(o) - _np(ref)) ** 2).mean()))
                   for o in (to, jo)]
            assert rms[0] < 1.5 * rms[1], rms
            continue
        tol = {"none": 1e-5, "int8": 2e-2, "int4": 2e-2}[quant]
        np.testing.assert_allclose(_np(to), _np(jo), atol=tol, rtol=tol)


# -- the engines ------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(JCFG, jax.random.key(0), MAX_LEN)
    tree = dataclasses.asdict(jax.tree_util.tree_map(np.asarray, jp))
    return jp, params_from_numpy(tree, device="cpu")


PROMPT = np.random.default_rng(7).integers(1, 512, 300).astype(np.int32)


def _greedy(eng, step, steps=4):
    logits = [_np(eng.prefill(PROMPT))]
    toks = [int(logits[0][0].argmax())]
    for _ in range(steps):
        logits.append(_np(step(toks[-1])))
        toks.append(int(logits[-1][0].argmax()))
    return logits, toks, eng.avg_sparsity


@pytest.mark.parametrize("estimator", ["quest", "topk"])
def test_engine_matches_jax(weights, estimator):
    """Default budgets: 2 of 32 Quest pages, 16 TopK tokens (the floor),
    over offloads of 280 tokens; dense layers {0, 1} of 4."""
    jp, tp = weights
    kw = dict(BASE_KW, estimator=estimator)
    jl = JLLM(JCFG, max_length=MAX_LEN, chunk_size=64, params=jp,
              lsh=JLSHConfig(**kw))
    tl = LLM(TCFG, max_length=MAX_LEN, params=tp, lsh=LSHConfig(**kw),
             device="cpu")
    assert [k for k, _ in tl.groups] == [k for k, _ in jl.groups] == [
        "dense", "dense", "sparse", "sparse"]
    jlog, jtok, jsp = _greedy(jl, lambda t: jl.inference(np.asarray([t])))
    tlog, ttok, tsp = _greedy(tl, lambda t: tl.inference(torch.tensor([t])))
    for a, b in zip(tlog, jlog):
        assert np.abs(a - b).max() / np.abs(b).max() < 1e-4
    assert ttok == jtok
    assert tsp == pytest.approx(jsp, abs=1e-7) and 0 < tsp < 1


def _port_llm(tp, **kw):
    return LLM(TCFG, max_length=MAX_LEN, params=tp, device="cpu",
               lsh=LSHConfig(**dict(BASE_KW, **kw)))


@pytest.mark.parametrize("estimator,kw,tol", [
    ("topk", {"topk_budget_frac": 1.0}, 2e-3),
    ("quest", {"quest_budget_frac": 1.0}, 2e-3),
    ("oracle_sampling", {"os_budget_frac": 8.0}, 0.15)])
def test_engine_full_budget_tracks_full_attention(weights, estimator, kw, tol):
    """At full budget TopK and Quest attend every offloaded token and
    oracle sampling's mean converges: each engine tracks the K=0 engine
    (tests/test_engine.py:170-200)."""
    _, tp = weights
    full = _port_llm(tp, K=0)
    base = _port_llm(tp, estimator=estimator, dense_layers=(0,), **kw)
    assert [k for k, _ in base.groups] == ["dense"] + ["sparse"] * 3
    flog, _, _ = _greedy(full, lambda t: full.inference(torch.tensor([t])), 3)
    blog, _, sp = _greedy(base, lambda t: base.inference(torch.tensor([t])), 3)
    np.testing.assert_allclose(blog[0], flog[0], rtol=1e-3, atol=1e-3)
    errs = [np.abs(b - f).max() / np.abs(f).max()
            for b, f in zip(blog[1:], flog[1:])]
    assert max(errs) < tol, errs
    assert sp == 1.0


@pytest.mark.parametrize("estimator", ["topk", "quest"])
def test_engine_int8_offload_tracks_bf16(weights, estimator):
    """int8 offload K/V dequantized to bf16 tracks the unquantized engine
    (tests/test_engine.py:222-240: 5e-2 of the largest logit)."""
    _, tp = weights
    runs = []
    for quant in ("none", "int8"):
        eng = _port_llm(tp, estimator=estimator, offload_quant=quant,
                        topk_budget_frac=0.25, quest_budget_frac=0.25)
        runs.append(_greedy(eng, lambda t, e=eng: e.inference(torch.tensor([t])),
                            3)[0])
    for a, b in zip(*runs):
        assert np.abs(a - b).max() / np.abs(b).max() < 5e-2


def test_negative_k_selects_quest():
    llm = LLM(TCFG, K=-10, max_length=256, device="cpu")
    assert llm.lsh.estimator == "quest" and llm.lsh.K == 10
    jl = JLLM(JCFG, K=-10, max_length=256, chunk_size=32)
    assert (llm.lsh.estimator, llm.lsh.K) == (jl.lsh.estimator, jl.lsh.K)
    assert llm.lsh.dense_layers_for(4) == jl.lsh.dense_layers_for(4) == (0, 1)
    assert len(llm.state.quest_min) == 2


def test_oracle_sampling_engine_draws_by_step(weights):
    """The decode step counter advances under oracle sampling only; clear()
    resets it, so a replayed request draws the same ids, and the same
    engine seed gives the same logits on a fresh engine."""
    _, tp = weights
    runs = []
    for _ in range(2):
        eng = _port_llm(tp, estimator="oracle_sampling", os_budget_frac=0.25)
        log1, _, _ = _greedy(eng, lambda t: eng.inference(torch.tensor([t])), 2)
        assert int(eng.state.step) == 2
        eng.clear()
        assert int(eng.state.step) == 0
        log2, _, _ = _greedy(eng, lambda t: eng.inference(torch.tensor([t])), 2)
        runs.append(log1)
        for a, b in zip(log1, log2):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(runs[0][1], runs[0][2])
    topk = _port_llm(tp, estimator="topk")
    _greedy(topk, lambda t: topk.inference(torch.tensor([t])), 2)
    assert int(topk.state.step) == 0

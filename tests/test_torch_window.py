"""Mistral's sliding window in the port against the JAX package and HF
`MistralForCausalLM`, on the CPU in float32, at tests/test_mistral.py's
tiny Mistral shape (3 layers, 8/2 heads of 16, window 48 or 144).

The window reaches every stage: the plain `full_decode` with a first row
`start` (the kernel's bound) against JAX's `full_decode` with the
equivalent `extra_mask`; the sparse fill's offload clip against JAX's
fill; the dense and sparse decode (sink aging) against JAX's layer
functions; the engines (whole and chunked prefill, decode across the
window) against HF and the JAX `LLM`.

Tolerances: `full_decode` 2e-3 (float32 inputs, the same masked softmax:
the values agree to ~1e-6); fill state exactly (lengths, V rows, raw K
rows, the SimHash bits), LSH's mean key and centered rows 1e-6
(`CENTER_TOL`: the two packages sum the mean in another order, 1 ulp);
float32 layer
and model paths 1e-4 (`F32`, as tests/test_torch_engine.py); HF logits
2e-3, as tests/test_mistral.py holds the JAX engine; an LSH sparse layer's
output and the LSH engines' decode logits 2e-2 (`JAX_DEBIAS_TOL`, the JAX
package's float32 collision weight cancels; tests/test_torch_engine.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicpig_tpu import config as jcfg
from magicpig_tpu.models.loader import params_from_state_dict as j_from_state_dict
from magicpig_tpu.ops import attention as jatt
from magicpig_tpu.ops import bitcodes as jbits
from magicpig_tpu.runtime import server as jserver
from magicpig_tpu.runtime import serving as jserving
from magicpig_tpu.runtime import state as jstate
from magicpig_tpu.runtime.engine import LLM as JLLM
from magicpig_tpu_torch.config import LSHConfig, ModelConfig
from magicpig_tpu_torch.models.loader import params_from_state_dict
from magicpig_tpu_torch.ops import attention as tatt
from magicpig_tpu_torch.ops import bitcodes as tbits
from magicpig_tpu_torch.runtime import server as tserver
from magicpig_tpu_torch.runtime import state as tstate
from magicpig_tpu_torch.runtime.engine import LLM
from magicpig_tpu_torch.runtime.serving import Scheduler

F32 = 1e-4
CENTER_TOL = 1e-6
HF_TOL = 2e-3
DECODE_TOL = 2e-3
JAX_DEBIAS_TOL = 2e-2
MAX_LEN = 256
SHAPE = dict(vocab_size=512, hidden_size=128, intermediate_size=256,
             num_hidden_layers=3, num_attention_heads=8, num_key_value_heads=2,
             head_dim=16, rms_norm_eps=1e-5, rope_theta=10000.0,
             max_position_embeddings=4096)
HOT_KW = dict(num_sink_tokens=4, num_local_tokens=16, generation_buffer=32)
LSH_KW = dict(K=6, L=40, **HOT_KW)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _configs(window):
    """The tiny Mistral in both packages, float32."""
    j = jcfg.ModelConfig(name="mistral-tiny", eos_token_ids=(2,),
                         rope_scaling=None, dtype=jnp.float32,
                         sliding_window=window, **SHAPE)
    t = ModelConfig(name="mistral-tiny", eos_token_ids=(2,), rope_scaling=None,
                    dtype=torch.float32, sliding_window=window, **SHAPE)
    return j, t


@pytest.fixture(scope="module")
def hf_model():
    """A random-weight HF Mistral with the window 48, eager attention (its
    sliding-window mask exact at every length)."""
    from transformers import MistralConfig, MistralForCausalLM

    torch.manual_seed(2)
    cfg = MistralConfig(**SHAPE, sliding_window=48, tie_word_embeddings=False,
                        attn_implementation="eager")
    return MistralForCausalLM(cfg).eval()


@pytest.fixture(scope="module")
def bank():
    return np.random.default_rng(42).standard_normal(
        (SHAPE["head_dim"], LSH_KW["K"] * LSH_KW["L"])).astype(np.float32)


def _engines(hf_model, bank, window, lsh_kw, batch_size=1, chunk_size=32):
    """The JAX LLM and the port's CPU LLM on the HF weights and one hash
    bank, with `window`."""
    jc, tc = _configs(window)
    sd = hf_model.state_dict()
    jp = j_from_state_dict(jc, sd, MAX_LEN, dtype=jnp.float32)
    tp = params_from_state_dict(tc, sd, MAX_LEN, device="cpu")
    jl = JLLM(jc, batch_size=batch_size, max_length=MAX_LEN,
              chunk_size=chunk_size, params=jp,
              lsh=jcfg.LSHConfig(**lsh_kw))
    jl.projections = jnp.asarray(bank)
    tl = LLM(tc, batch_size=batch_size, max_length=MAX_LEN,
             chunk_size=chunk_size, params=tp, lsh=LSHConfig(**lsh_kw),
             projections=_t(bank), device="cpu")
    return jl, tl


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(3, SHAPE["vocab_size"],
                                                n).astype(np.int32)


# -- the plain full_decode with a first row ------------------------------------


@pytest.mark.parametrize("lens,starts", [
    ((200, 37), (120, 0)),       # a window's bound in one request
    ((200, 37), (199, 36)),      # one row each
    ((200, 37), (200, 50)),      # empty ranges: out 0, lse -inf
])
def test_full_decode_start_matches_jax_extra_mask(lens, starts):
    rng = np.random.default_rng(sum(starts))
    b, hq, hkv, s, d = 2, 8, 2, 256, 16
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    length = np.asarray(lens, np.int32)
    start = np.asarray(starts, np.int32)
    extra = np.arange(s)[None, :] >= start[:, None]
    jo, jl = jatt.full_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(length),
                              extra_mask=jnp.asarray(extra))
    to, tl = tatt.full_decode(_t(q), _t(k), _t(v), _t(length),
                              start=_t(start))
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=2e-3, rtol=2e-3)
    empty = start >= length
    assert np.isneginf(_np(tl)[empty]).all()
    assert (_np(to)[empty] == 0).all()
    # The bound moves the output wherever it drops a row.
    full, _ = tatt.full_decode(_t(q), _t(k), _t(v), _t(length))
    moved = np.abs(_np(full) - _np(to)).max(axis=(1, 2)) > 1e-3
    np.testing.assert_array_equal(moved, start > 0)


# -- the attention server ------------------------------------------------------

_jfill_sparse = jax.jit(jserver.fill_sparse_layer, static_argnums=(1, 7, 8))
_jdecode_sparse = jax.jit(jserver.decode_sparse_layer,
                          static_argnums=(1, 6, 7))
_jfill_dense = jax.jit(jserver.fill_dense_layer, static_argnums=(1,))
_jdecode_dense = jax.jit(jserver.decode_dense_layer, static_argnums=(1, 5))


def _kv(rng, p, hkv=2, d=16):
    return (rng.standard_normal((p, hkv, d)).astype(np.float32),
            rng.standard_normal((p, hkv, d)).astype(np.float32))


def _token_bits_jax(planes, off_cap, d):
    """JAX blocked planes [Hkv, L, K, W] -> token-order bits [Hkv, L, K, S]."""
    fold = max(128 // d, 1)
    blk = jbits.plane_block(off_cap, fold)
    return np.asarray(jbits.unpack_words_blocked(jnp.asarray(planes), blk,
                                                 fold, off_cap))


def _filled_states(window, estimator, bank, lens=(230, 100), sinks=None):
    """One sparse layer of two requests filled by both packages with
    `window`: request 0 longer than the window (clipped), request 1
    shorter; with `sinks` [Hkv, d], the four sink keys of each request set
    to it. Returns (JAX state, port state, JAX and port LSH configs, the
    prompts' K/V)."""
    _, tc = _configs(window)
    jc, _ = _configs(window)
    kw = dict(LSH_KW, estimator=estimator, block_topk_block_size=16,
              block_topk_budget_frac=1.0)
    jl, tl = jcfg.LSHConfig(**kw), LSHConfig(**kw)
    js = jstate.init_state(jc, jl, 2, MAX_LEN)
    ts = tstate.init_state(tc, tl, 2, MAX_LEN, "cpu")
    rng = np.random.default_rng(window)
    kvs = []
    for req, p in enumerate(lens):
        k, v = _kv(rng, p)
        if sinks is not None:
            k[:4] = sinks
        kvs.append((k, v))
        pad = np.zeros((MAX_LEN - p, 2, 16), np.float32)
        js = _jfill_sparse(js, 1, jnp.int32(req),
                           jnp.asarray(np.concatenate([k, pad])),
                           jnp.asarray(np.concatenate([v, pad])),
                           jnp.int32(p), jnp.asarray(bank), jl, window)
        tserver.fill_sparse_layer(ts, 1, req, _t(k), _t(v), _t(bank), tl,
                                  window)
    return js, ts, jl, tl, kvs


@pytest.mark.parametrize("estimator", ["lsh", "block_topk"])
def test_sparse_fill_with_window_matches_jax(estimator, bank):
    window = 144
    js, ts, _, _, kvs = _filled_states(window, estimator, bank)
    np.testing.assert_array_equal(_np(ts.off_len), np.asarray(js.off_len))
    np.testing.assert_array_equal(_np(ts.hot_len), np.asarray(js.hot_len))
    # Request 0 clipped to its last `window` tokens less the local ones.
    assert _np(ts.off_len).tolist() == [window - 16, 100 - 20]
    d = 16
    joff_k = np.asarray(js.off_k[1]).reshape(2, 2, -1, d)
    joff_v = np.asarray(js.off_v[1]).reshape(2, 2, -1, d)
    off_cap = joff_k.shape[2]
    for req, (k, v) in enumerate(kvs):
        n, p = int(ts.off_len[req]), k.shape[0]
        first = max(4, p - window)
        np.testing.assert_array_equal(_np(ts.off_v[1])[req, :, :n],
                                      joff_v[req, :, :n])
        np.testing.assert_array_equal(_np(ts.off_v[1])[req, :, :n],
                                      v[first:first + n].transpose(1, 0, 2))
        if estimator != "lsh":
            np.testing.assert_array_equal(_np(ts.off_k[1])[req, :, :n],
                                          joff_k[req, :, :n])
            continue
        # Centered keys: the two packages sum the mean in another order.
        np.testing.assert_allclose(_np(ts.off_k[1])[req, :, :n],
                                   joff_k[req, :, :n], atol=CENTER_TOL)
        np.testing.assert_allclose(_np(ts.avg_k[1])[req],
                                   np.asarray(js.avg_k[1])[req],
                                   atol=CENTER_TOL)
        np.testing.assert_allclose(_np(ts.avg_k[1])[req],
                                   k[first:first + n].mean(axis=0),
                                   atol=CENTER_TOL)
        want = _token_bits_jax(js.planes[1][req], off_cap, d)[..., :n]
        got = _np(tbits.unpack_words(ts.planes[1][req], off_cap))[..., :n]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pos_past_window", [-1, 0, 1, 3, 9])
def test_sparse_decode_ages_sinks_as_jax(pos_past_window, bank):
    """The hot partial with sinks aging, against JAX's sparse layer: at pos
    = window + j sinks 0..j have left the window (all four from j = 3), at
    j = -1 none has. The query of each kv head points along that head's
    sink keys (scores ~4 above the rest), so the sinks hold most of the
    attention and each one that ages moves the output by far more than the
    tolerance. block_topk at budget fraction 1.0 (every offload block
    attended: JAX's XLA oracle), decode logits' tolerance `DECODE_TOL` of
    the largest output, as tests/test_torch_block_topk.py holds the port's
    block_topk (it rounds q / sqrt(d) to bf16 before the dot, as the
    kernels do)."""
    window, d = 144, 16
    rng = np.random.default_rng(5)
    dirs = rng.standard_normal((2, d)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    js, ts, jl, tl, _ = _filled_states(window, "block_topk", bank,
                                       sinks=4 * dirs)
    pos = np.asarray([window + pos_past_window, 100], np.int32)
    js = js.replace(pos=jnp.asarray(pos))
    ts.pos.copy_(_t(pos))
    q = (4 * np.repeat(dirs, 4, axis=0)[None].repeat(2, axis=0)
         + 0.1 * rng.standard_normal((2, 8, d))).astype(np.float32)
    kn, vn = _kv(rng, 2)
    jo, _, jfrac = _jdecode_sparse(js, 1, jnp.asarray(q), jnp.asarray(kn),
                                   jnp.asarray(vn), jnp.zeros((d, 1)), jl,
                                   window)
    before = [t.clone() for t in (ts.hot_k[1], ts.hot_v[1])]
    to, tfrac = tserver.decode_sparse_layer(ts, 1, _t(q), _t(kn), _t(vn),
                                            None, tl, window)
    scale = np.abs(np.asarray(jo)).max()
    np.testing.assert_allclose(_np(to), np.asarray(jo),
                               atol=DECODE_TOL * scale, rtol=0)
    assert float(tfrac) == pytest.approx(float(jfrac), abs=1e-7)
    # Without the window (the hot region as it was) request 0 moves by far
    # more than the tolerance exactly when a sink has aged.
    ts.hot_k[1].copy_(before[0])
    ts.hot_v[1].copy_(before[1])
    free, _ = tserver.decode_sparse_layer(ts, 1, _t(q), _t(kn), _t(vn), None,
                                          tl)
    moved = np.abs(_np(free) - _np(to)).max(axis=(1, 2)) > 10 * DECODE_TOL * scale
    assert moved.tolist() == [pos_past_window >= 0, False]


def test_dense_decode_with_window_matches_jax():
    window = 48
    jc, tc = _configs(window)
    jl, tl = jcfg.LSHConfig(**LSH_KW), LSHConfig(**LSH_KW)
    js = jstate.init_state(jc, jl, 2, MAX_LEN)
    ts = tstate.init_state(tc, tl, 2, MAX_LEN, "cpu")
    rng = np.random.default_rng(3)
    for req, p in enumerate((100, 30)):
        k, v = _kv(rng, p)
        pad = np.zeros((128 - p, 2, 16), np.float32)
        js = _jfill_dense(js, 0, jnp.int32(req),
                          jnp.asarray(np.concatenate([k, pad])),
                          jnp.asarray(np.concatenate([v, pad])), jnp.int32(p))
        tserver.fill_dense_layer(ts, 0, req, _t(k), _t(v))
    for step in range(3):
        q = rng.standard_normal((2, 8, 16)).astype(np.float32)
        kn, vn = _kv(rng, 2)
        jo, js = _jdecode_dense(js, 0, jnp.asarray(q), jnp.asarray(kn),
                                jnp.asarray(vn), window)
        to = tserver.decode_dense_layer(ts, 0, _t(q), _t(kn), _t(vn), window)
        np.testing.assert_allclose(_np(to), np.asarray(jo), atol=F32,
                                   rtol=F32)
        js = js.replace(dense_len=js.dense_len + 1)
        ts.dense_len += 1


# -- the engines ---------------------------------------------------------------


@pytest.mark.parametrize("chunked", [False, True])
def test_full_attention_window_engine_matches_hf(hf_model, bank, chunked):
    """tests/test_mistral.py:95 on the port: the K=0 engine with the
    window 48 (active: the prompt is 90 tokens) against HF on the prefill's
    last logits and 3 greedy steps (HF re-run over the whole sequence at
    each); whole or in chunks of 32 tokens."""
    _, tl = _engines(hf_model, bank, 48, dict(K=0, L=0, **HOT_KW))
    prompt = _prompt(7, 90)
    if chunked:
        cp = tl.start_prefill(prompt)
        while not cp.done:
            cp.step()
        logits = cp.logits
    else:
        logits = tl.prefill(prompt)
    ids = list(prompt)
    with torch.no_grad():
        want = hf_model(torch.tensor([ids], dtype=torch.int64)).logits[0, -1]
    np.testing.assert_allclose(_np(logits[0]), _np(want), atol=HF_TOL,
                               rtol=HF_TOL)
    tok = int(logits[0].argmax())
    for _ in range(3):
        ids.append(tok)
        ours = _np(tl.inference(torch.tensor([tok]))[0])
        with torch.no_grad():
            want = _np(hf_model(torch.tensor([ids])).logits[0, -1])
        np.testing.assert_allclose(ours, want, atol=HF_TOL, rtol=HF_TOL)
        assert ours.argmax() == want.argmax()
        tok = int(ours.argmax())


def _decode_both(jl, tl, tok, steps):
    """`steps` greedy steps of both engines from the same first token, the
    port's logits against JAX's at each (JAX's token fed to both)."""
    for _ in range(steps):
        jlog = np.asarray(jl.inference(np.asarray([tok])))
        tlog = _np(tl.inference(torch.tensor([tok])))
        np.testing.assert_allclose(tlog, jlog, atol=JAX_DEBIAS_TOL,
                                   rtol=JAX_DEBIAS_TOL)
        tok = int(jlog[0].argmax())


def test_lsh_window_engine_matches_jax(hf_model, bank):
    """tests/test_mistral.py:138 on the port: LSH (K=6, L=40) with the
    window 144 over a 220-token prompt: the offload clipped to window - 16
    tokens in every sparse layer, as in the JAX LLM; prefill logits and 4
    decode steps against it."""
    window = 144
    jl, tl = _engines(hf_model, bank, window, LSH_KW)
    prompt = _prompt(8, 220)
    jlog = np.asarray(jl.prefill(prompt))
    tlog = _np(tl.prefill(prompt))
    np.testing.assert_allclose(tlog, jlog, atol=F32, rtol=F32)
    assert int(tl.state.off_len[0]) == window - 16
    np.testing.assert_array_equal(_np(tl.state.off_len),
                                  np.asarray(jl.state.off_len))
    _decode_both(jl, tl, int(jlog[0].argmax()), 4)
    assert tl.avg_sparsity == pytest.approx(jl.avg_sparsity, abs=2e-3)


def test_sinks_age_one_by_one_during_decode_as_jax(hf_model, bank):
    """A 140-token prompt under the window 144: decode steps at positions
    140..147 move the window past the sinks one by one (the dense layer's
    first row from 1 at position 144), logits against the JAX LLM at each
    step; two requests, one of them past the window from the start."""
    window = 144
    jl, tl = _engines(hf_model, bank, window, LSH_KW, batch_size=2)
    for req, n in enumerate((140, 200)):
        prompt = _prompt(20 + req, n)
        np.testing.assert_allclose(_np(tl.prefill(prompt, request_id=req)),
                                   np.asarray(jl.prefill(prompt,
                                                         request_id=req)),
                                   atol=F32, rtol=F32)
    tok = np.asarray([5, 9])
    for _ in range(8):
        jlog = np.asarray(jl.inference(tok))
        tlog = _np(tl.inference(torch.from_numpy(tok)))
        np.testing.assert_allclose(tlog, jlog, atol=JAX_DEBIAS_TOL,
                                   rtol=JAX_DEBIAS_TOL)
        tok = jlog.argmax(-1)
    assert _np(tl.state.pos).tolist() == [148, 208]


def test_chunked_prefill_with_window_matches_jax_and_one_shot(hf_model, bank):
    """`start_prefill` in 32-token chunks with the window 144 under LSH
    over a 200-token prompt (the chunks' queries and the offload clipped):
    the first-token logits equal the one-shot prefill's and JAX's (which
    prefills in the same chunks), the fill state the one-shot one's, and
    2 decode steps JAX's."""
    jl, tl = _engines(hf_model, bank, 144, LSH_KW)
    prompt = _prompt(11, 200)
    cp = tl.start_prefill(prompt)
    while not cp.done:
        cp.step()
    chunked_logits = _np(cp.logits)
    chunked_state = {n: _np(getattr(tl.state, n)[1]).copy()
                     for n in ("off_k", "off_v", "hot_k", "avg_k")}
    tl.clear()
    np.testing.assert_allclose(_np(tl.prefill(prompt)), chunked_logits,
                               atol=1e-5, rtol=1e-5)
    for name, want in chunked_state.items():
        np.testing.assert_allclose(_np(getattr(tl.state, name)[1]), want,
                                   atol=1e-5, rtol=1e-5)
    jlog = np.asarray(jl.prefill(prompt))
    np.testing.assert_allclose(chunked_logits, jlog, atol=F32, rtol=F32)
    _decode_both(jl, tl, int(jlog[0].argmax()), 2)


@pytest.mark.parametrize("interleave", [False, True],
                         ids=["synchronous", "interleaved"])
def test_scheduler_with_window_matches_jax(hf_model, bank, interleave):
    """The `Scheduler` serves a windowed config unchanged: four requests
    around the window 144 (two past it, one crossing it while it decodes)
    over two slots, one-shot or a 32-token chunk a step; each request's
    greedy tokens equal the JAX Scheduler's in the same mode."""
    prompts = [_prompt(30 + i, n) for i, n in enumerate((200, 140, 170, 96))]
    got = {}
    for name in ("jax", "port"):
        jl, tl = _engines(hf_model, bank, 144, LSH_KW, batch_size=2)
        sched = (jserving.Scheduler(jl, interleave=interleave)
                 if name == "jax" else Scheduler(tl, interleave=interleave))
        for p in prompts:
            sched.submit(p, max_tokens=6)
        finished = sched.run()
        assert len(finished) == 4 and not sched.pending
        got[name] = {r.uid: r.generated for r in finished}
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("window,lsh_kw,refused", [
    (128, LSH_KW, True),                       # = the hot capacity
    (129, LSH_KW, False),
    (48, dict(K=0, L=0, **HOT_KW), False),     # no sparse layer: any window
])
def test_window_within_hot_capacity_refused(window, lsh_kw, refused):
    _, tc = _configs(window)
    if refused:
        with pytest.raises(ValueError, match="hot capacity"):
            LLM(tc, max_length=MAX_LEN, lsh=LSHConfig(**lsh_kw), device="cpu")
        jc, _ = _configs(window)
        with pytest.raises(AssertionError):
            JLLM(jc, max_length=MAX_LEN, lsh=jcfg.LSHConfig(**lsh_kw))
    else:
        LLM(tc, max_length=MAX_LEN, lsh=LSHConfig(**lsh_kw), device="cpu")

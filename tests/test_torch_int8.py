"""int8 K/V for the LSH estimator and the dense layers, and the quantized
engines, against the JAX package on the CPU.

Kernels: the plain int8 flash decode and fused LSH decode against the Pallas
kernels in interpret mode, to 5e-3 (tests/test_pallas_kernels.py:86, the
JAX package's int8 tolerance); sampled counts exactly. JAX takes the scales
fold-major ([.., f, c] scales token c * fold + f), the port in token order;
the tests convert.

Fill: the port's int8 rows and scales equal the eager JAX quantizer's of the
same rows byte for byte, and the jitted JAX fill's within one step and one
ulp (under jit XLA computes amax / 127 as amax * f32(1/127)). The LSH norms
and signatures are those of the dequantized centered keys, checked directly.
A sparse layer's output 2e-2 (`JAX_DEBIAS_TOL`, tests/test_torch_engine.py:
the JAX collision weight cancels in float32 with random keys); a dense int8
layer's 5e-3 against JAX's int8 flash decode.

Engines (llama-tiny in float32, the JAX weights carried across): bench.py's
lsh mode (W8A8 fused weights, int8 offload) gives JAX's greedy tokens,
prefill logits within `W8_LOGIT_TOL` of the largest logit and the sampled
fraction to 2e-3. W8A8 turns float32 rounding differences into int8 steps:
an activation within ~1e-7 of a rounding boundary moves one step, 1/127 of
its row's largest value, so a few rows of a layer differ by up to ~1% (the
two engines' attention outputs differ by 5e-7; the linear layers alone
agree to 1e-6, tests/test_torch_weights.py); 5e-2 is the bound the JAX
package holds W8A8 to against exact weights (tests/test_engine.py:450).
With exact weights and int8 offload at K=1, L=32 and K=4, L=8 (few keys
with small collision weights), decode logits within `INT8_TOL` of the
largest logit (measured up to 1.4e-3: JAX's CPU path rounds the
dequantized K/V to bf16, the port scales the int8 products) and equal
tokens; at K=10, L=150 with random weights the decode logits of the two
engines drift apart by up to ~0.3 of the largest logit within 8 steps (the
bf16 engines too at some steps), through the JAX collision weight's
cancellation and SimHash sign flips, so there only tokens are compared, as
in tests/test_torch_engine.py. The full_int8 mode with W4 weights (K=0,
dense int8, int4 fused): on the CPU JAX's decode-size int4 products quantize the activations
to int8 (its W4A8 route), while the port computes the TPU kernel's function
(bf16 activations, exact nibbles), as the JAX package does on its TPU. So
the same top-1 at prefill and logits within `W4_LOGIT_TOL` of the largest
logit, each step.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicpig_tpu.config import LSHConfig as JLSHConfig
from magicpig_tpu.config import preset as jpreset
from magicpig_tpu.models import llama as jllama
from magicpig_tpu.ops import bitcodes as jbits
from magicpig_tpu.ops import quant as jquant
from magicpig_tpu.ops.pallas.decode import flash_decode as j_flash_decode
from magicpig_tpu.ops.pallas.lsh_fused import lsh_fused_attention2
from magicpig_tpu.runtime import server as jserver
from magicpig_tpu.runtime import state as jstate
from magicpig_tpu.runtime.engine import LLM as JLLM
from magicpig_tpu_torch.config import LSHConfig, preset
from magicpig_tpu_torch.models import llama as tllama
from magicpig_tpu_torch.models.convert import params_from_numpy
from magicpig_tpu_torch.ops import bitcodes as tbits
from magicpig_tpu_torch.ops.kernels import LAUNCHES, flash_decode, lsh_fused_decode
from magicpig_tpu_torch.ops.quant import dequantize_rows, quantize_rows
from magicpig_tpu_torch.runtime import server as tserver
from magicpig_tpu_torch.runtime import state as tstate
from magicpig_tpu_torch.runtime.engine import LLM

INT8_TOL = 5e-3
JAX_DEBIAS_TOL = 2e-2
W8_LOGIT_TOL = 5e-2
W4_LOGIT_TOL = 5e-2
MAX_LEN = 512
LSH_KW = dict(K=10, L=150, num_sink_tokens=4, num_local_tokens=16,
              generation_buffer=32)
JCFG = dataclasses.replace(jpreset("llama-tiny"), dtype=jnp.float32)
TCFG = dataclasses.replace(preset("llama-tiny"), dtype=torch.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bf16_values(rng, shape):
    """Normal draws rounded to bf16, as f32."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(torch.bfloat16).float().numpy()


def _fold_major(scale, d):
    """Token-order scales [B, Hkv, S] -> JAX's fold-major [B, Hkv, fold,
    S/fold]."""
    b, h, s = scale.shape
    fold = max(128 // d, 1)
    return np.ascontiguousarray(
        _np(scale).reshape(b, h, s // fold, fold).transpose(0, 1, 3, 2))


def _unfold_tokens(x):
    """JAX fold-major per-token values [B, Hkv, fold, cap/fold] -> [B, Hkv, cap]."""
    b, h, f, c = x.shape
    return np.asarray(x).transpose(0, 1, 3, 2).reshape(b, h, f * c)


def _int8_kv(rng, b, hkv, s, d):
    k, ks = quantize_rows(_t(_bf16_values(rng, (b, hkv, s, d))))
    v, vs = quantize_rows(_t(_bf16_values(rng, (b, hkv, s, d))))
    return k, ks, v, vs


# -- kernels: plain int8 versions against the Pallas kernels -------------------


@pytest.mark.parametrize("B,HKV,G,S,D", [
    (3, 2, 4, 256, 64),
    (2, 2, 2, 256, 128),
    (3, 2, 4, 512, 16),
    (2, 2, 4, 256, 128),     # Llama-3.1-8B's head dim and group size
    (2, 2, 3, 256, 64),      # the general tile's group sizes, the small
    (2, 1, 16, 256, 128),    # head dims
    (2, 2, 6, 256, 32),
])
def test_flash_decode_int8_plain_matches_pallas(B, HKV, G, S, D):
    """Request 1 ends mid-block (37 tokens), request 2 is empty."""
    rng = np.random.default_rng(1)
    q = _bf16_values(rng, (B, HKV * G, D))
    k, ks, v, vs = _int8_kv(rng, B, HKV, S, D)
    length = np.asarray(([S, 37, 0] * B)[:B], np.int32)
    jo, jl = j_flash_decode(jnp.asarray(q), jnp.asarray(_np(k)),
                            jnp.asarray(_np(v)), jnp.asarray(length),
                            block_tokens=128, interpret=True,
                            k_scale=jnp.asarray(_fold_major(ks, D)),
                            v_scale=jnp.asarray(_fold_major(vs, D)))
    before = dict(LAUNCHES)
    to, tl = flash_decode(_t(q), k, v, _t(length), ks, vs)
    assert LAUNCHES == before
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=INT8_TOL, rtol=INT8_TOL)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=INT8_TOL, rtol=INT8_TOL)
    if B == 3:
        assert (_np(to)[2] == 0).all() and np.isneginf(_np(tl)[2]).all()


@pytest.mark.parametrize("B,HKV,G,S,D,K,L", [
    (2, 2, 4, 256, 64, 6, 20),
    (1, 2, 2, 512, 16, 10, 30),
    (2, 2, 4, 256, 64, 10, 150),
    (2, 2, 4, 256, 128, 6, 20),    # head dim 128, group 4: bench lsh at 8B
    (1, 2, 3, 256, 64, 6, 20),     # the general tile's group sizes, the
    (1, 1, 16, 256, 128, 6, 20),   # small head dims
    (1, 2, 6, 256, 32, 6, 20),
])
def test_lsh_int8_plain_matches_pallas_fused(B, HKV, G, S, D, K, L):
    """int8 centered keys and values; norms and signatures of the
    dequantized keys on both sides; keys planted near each query so that
    the sample is not empty."""
    rng = np.random.default_rng(3)
    q = _bf16_values(rng, (B, HKV * G, D))
    kc = rng.standard_normal((B, HKV, S, D)).astype(np.float32)
    kc[:, :, 5:40] = q.reshape(B, HKV, G, D)[:, :, :1] + 0.3 * kc[:, :, 5:40]
    kq, ks = quantize_rows(_t(kc))
    vq, vs = quantize_rows(_t(_bf16_values(rng, (B, HKV, S, D))))
    kd = _np(dequantize_rows(kq, ks, torch.float32))
    knorm = np.linalg.norm(kd, axis=-1)
    proj = rng.standard_normal((D, K * L)).astype(np.float32)
    length = np.asarray(([S, S // 2 + 17] * B)[:B], np.int32)
    fold = max(128 // D, 1)
    blk = jbits.plane_block(S, fold)
    jplanes = jax.vmap(lambda kb: jbits.build_planes_blocked(
        kb.transpose(1, 0, 2), jnp.asarray(proj), K, blk, fold))(jnp.asarray(kd))
    jqb = jbits.hash_bits(jnp.asarray(q), jnp.asarray(proj), K)
    jo, jl, jc = lsh_fused_attention2(
        jnp.asarray(q), jnp.asarray(_np(kq)), jnp.asarray(_np(vq)),
        jnp.asarray(knorm), jplanes, jqb, jnp.asarray(length), K, L,
        interpret=True, k_scale=jnp.asarray(_fold_major(ks, D)),
        v_scale=jnp.asarray(_fold_major(vs, D)))
    planes = torch.stack([tbits.build_planes(_t(kd[b]).transpose(0, 1),
                                             _t(proj), K) for b in range(B)])
    qb = tbits.hash_bits(_t(q), _t(proj), K)
    to, tl, tc = lsh_fused_decode(_t(q), kq, vq, _t(knorm), planes, qb,
                                  _t(length), K, L, ks, vs)
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    assert _np(tc).reshape(B, HKV, G)[:, :, 0].min() > 0     # the planted heads
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=INT8_TOL, rtol=INT8_TOL)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=INT8_TOL, rtol=INT8_TOL)


# -- attention servers -------------------------------------------------------------

_jfill_dense = jax.jit(jserver.fill_dense_layer, static_argnums=(1,))
_jdecode_dense = jax.jit(functools.partial(jserver.decode_dense_layer,
                                           use_pallas="on"),
                         static_argnums=(1,))
_jfill_sparse = jax.jit(jserver.fill_sparse_layer, static_argnums=(1, 7))
_jdecode_sparse = jax.jit(jserver.decode_sparse_layer, static_argnums=(1, 6))


def _assert_rows_and_scales(got_q, got_s, want_q, want_s, jit_q, jit_s):
    """Bytes equal to the eager quantizer's; within one step and one ulp of
    the jitted JAX state."""
    np.testing.assert_array_equal(got_q, want_q)
    np.testing.assert_array_equal(got_s, want_s)
    step = np.abs(got_q.astype(int) - jit_q)
    assert step.max() <= 1 and step.mean() < 1e-2
    np.testing.assert_allclose(got_s, jit_s, rtol=2.5e-7, atol=0)


def test_dense_int8_layer_fill_and_append_match_jax():
    kw = dict(LSH_KW, dense_quant="int8")
    jl, tl = JLSHConfig(**kw), LSHConfig(**kw)
    js = jstate.init_state(JCFG, jl, 2, MAX_LEN)
    ts = tstate.init_state(TCFG, tl, 2, MAX_LEN, "cpu")
    assert ts.dense_k[0].dtype == torch.int8 and ts.dense_k_scale[0].shape == (2, 2, MAX_LEN)
    rng = np.random.default_rng(4)
    kv = {}
    for req, p in ((0, 100), (1, 37)):
        k, v = _bf16_values(rng, (p, 2, 16)), _bf16_values(rng, (p, 2, 16))
        kv[req] = (k, v)
        pad = np.zeros((128 - p, 2, 16), np.float32)
        js = _jfill_dense(js, 0, jnp.int32(req), jnp.asarray(np.concatenate([k, pad])),
                          jnp.asarray(np.concatenate([v, pad])), jnp.int32(p))
        tserver.fill_dense_layer(ts, 0, req, _t(k), _t(v))
    for _ in range(2):
        q = _bf16_values(rng, (2, 8, 16))
        kn, vn = _bf16_values(rng, (2, 2, 16)), _bf16_values(rng, (2, 2, 16))
        for req in range(2):
            kv[req] = tuple(np.concatenate([a, n[req][None]])
                            for a, n in zip(kv[req], (kn, vn)))
        jo, js = _jdecode_dense(js, 0, jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn))
        to = tserver.decode_dense_layer(ts, 0, _t(q), _t(kn), _t(vn))
        ts.dense_len += 1
        js = js.replace(dense_len=js.dense_len + 1)
        np.testing.assert_allclose(_np(to), np.asarray(jo), atol=INT8_TOL, rtol=INT8_TOL)
    for name, i in (("k", 0), ("v", 1)):
        jq = np.asarray(getattr(js, f"dense_{name}")[0]).reshape(2, 2, -1, 16)
        jsc = _unfold_tokens(getattr(js, f"dense_{name}_scale")[0])
        for req in range(2):
            n = int(ts.dense_len[req])
            rows = jnp.asarray(kv[req][i].transpose(1, 0, 2))       # [Hkv, n, d]
            wq, wsc = jquant.quantize_rows(rows)
            _assert_rows_and_scales(
                _np(getattr(ts, f"dense_{name}")[0])[req, :, :n],
                _np(getattr(ts, f"dense_{name}_scale")[0])[req, :, :n],
                np.asarray(wq), np.asarray(wsc), jq[req, :, :n], jsc[req, :, :n])


def test_lsh_int8_sparse_layer_fill_and_decode_match_jax(bank_small):
    kw = dict(LSH_KW, offload_quant="int8")
    jl, tl = JLSHConfig(**kw), LSHConfig(**kw)
    js = jstate.init_state(JCFG, jl, 2, MAX_LEN)
    ts = tstate.init_state(TCFG, tl, 2, MAX_LEN, "cpu")
    assert ts.off_k[1].dtype == torch.int8 and len(ts.k_norm) == len(ts.off_k_scale)
    jproj = jnp.asarray(bank_small)
    rng = np.random.default_rng(5)
    kv = []
    for req, p in enumerate((300, 120)):
        k, v = _bf16_values(rng, (p, 2, 16)), _bf16_values(rng, (p, 2, 16))
        kv.append((k, v))
        pad = np.zeros((320 - p, 2, 16), np.float32)
        js = _jfill_sparse(js, 1, jnp.int32(req), jnp.asarray(np.concatenate([k, pad])),
                           jnp.asarray(np.concatenate([v, pad])), jnp.int32(p),
                           jproj, jl)
        tserver.fill_sparse_layer(ts, 1, req, _t(k), _t(v), _t(bank_small), tl)
    np.testing.assert_array_equal(_np(ts.off_len), np.asarray(js.off_len))
    np.testing.assert_allclose(_np(ts.avg_k[1]), np.asarray(js.avg_k[1]),
                               atol=1e-6, rtol=1e-6)
    jk = np.asarray(js.off_k[1]).reshape(2, 2, -1, 16)
    jv = np.asarray(js.off_v[1]).reshape(2, 2, -1, 16)
    jks, jvs = _unfold_tokens(js.off_k_scale[1]), _unfold_tokens(js.off_v_scale[1])
    jnorm = _unfold_tokens(js.k_norm[1])
    for req, (k, v) in enumerate(kv):
        n = int(ts.off_len[req])
        # The port's centered keys (its own mean), through the eager JAX
        # quantizer as the JAX fill applies it: quantize, dequantize (the
        # keys decode scores against), quantize again for storage.
        centered = (k[4:4 + n] - _np(ts.avg_k[1])[req][None]).transpose(1, 0, 2)
        deq = jquant.dequantize_rows(*jquant.quantize_rows(jnp.asarray(centered)),
                                     jnp.float32)
        wq, wsc = jquant.quantize_rows(deq)
        _assert_rows_and_scales(_np(ts.off_k[1])[req, :, :n],
                                _np(ts.off_k_scale[1])[req, :, :n],
                                np.asarray(wq), np.asarray(wsc),
                                jk[req, :, :n], jks[req, :, :n])
        vq, vsc = jquant.quantize_rows(jnp.asarray(v[4:4 + n].transpose(1, 0, 2)))
        _assert_rows_and_scales(_np(ts.off_v[1])[req, :, :n],
                                _np(ts.off_v_scale[1])[req, :, :n],
                                np.asarray(vq), np.asarray(vsc),
                                jv[req, :, :n], jvs[req, :, :n])
        # Norms and signatures of the dequantized keys, not of the float32
        # centered keys: the debias cosine must describe what decode scores.
        got_norm = _np(ts.k_norm[1])[req, :, :n]
        np.testing.assert_allclose(got_norm, np.linalg.norm(np.asarray(deq), axis=-1),
                                   rtol=1e-6, atol=0)
        assert np.abs(got_norm - np.linalg.norm(centered, axis=-1)).max() > 1e-5
        np.testing.assert_allclose(got_norm, jnorm[req, :, :n], rtol=1e-5, atol=1e-6)
        w = -(-n // 32)
        got_planes = _np(ts.planes[1])[req, ..., :w]

        def planes_of(rows):                  # [Hkv, n, d], padded to words
            pad = np.zeros((rows.shape[0], 32 * w - n, rows.shape[2]), np.float32)
            keys = _t(np.concatenate([np.asarray(rows), pad], axis=1))
            return _np(tbits.build_planes(keys.transpose(0, 1), _t(bank_small),
                                          LSH_KW["K"]))

        from_deq, from_f32 = planes_of(deq), planes_of(centered)
        np.testing.assert_array_equal(got_planes, from_deq)
        assert (got_planes != from_f32).any()

    for _ in range(2):
        q = _bf16_values(rng, (2, 8, 16))
        kn, vn = _bf16_values(rng, (2, 2, 16)), _bf16_values(rng, (2, 2, 16))
        jo, js, jfrac = _jdecode_sparse(js, 1, jnp.asarray(q), jnp.asarray(kn),
                                        jnp.asarray(vn), jproj, jl)
        to, tfrac = tserver.decode_sparse_layer(ts, 1, _t(q), _t(kn), _t(vn),
                                                _t(bank_small), tl)
        ts.hot_len += 1
        js = js.replace(hot_len=js.hot_len + 1)
        assert 0 < float(tfrac) < 1
        assert float(tfrac) == pytest.approx(float(jfrac), abs=2e-3)
        np.testing.assert_allclose(_np(to), np.asarray(jo), atol=JAX_DEBIAS_TOL,
                                   rtol=JAX_DEBIAS_TOL)


@pytest.fixture(scope="module")
def bank_small():
    return np.random.default_rng(42).standard_normal(
        (TCFG.head_dim, LSH_KW["K"] * LSH_KW["L"])).astype(np.float32)


# -- the engines -----------------------------------------------------------------------


def _engines(weight_quant, fuse, lsh_kw, bank):
    jcfg = dataclasses.replace(JCFG, weight_quant=weight_quant,
                               fuse_small_linears=fuse)
    tcfg = dataclasses.replace(TCFG, weight_quant=weight_quant,
                               fuse_small_linears=fuse)
    jp = jllama.init_params(jcfg, jax.random.key(0), MAX_LEN)
    tp = params_from_numpy(dataclasses.asdict(jax.tree_util.tree_map(np.asarray, jp)),
                           device="cpu")
    jl = JLLM(jcfg, max_length=MAX_LEN, chunk_size=64, params=jp,
              lsh=JLSHConfig(**lsh_kw))
    jl.projections = jnp.asarray(bank)
    tl = LLM(tcfg, max_length=MAX_LEN, params=tp, lsh=LSHConfig(**lsh_kw),
             projections=_t(bank), device="cpu")
    return jl, tl


def _greedy(jl, tl, steps=8):
    prompt = np.random.default_rng(0).integers(1, TCFG.vocab_size, 300).astype(np.int32)
    runs = []
    for eng, step in ((jl, lambda t: jl.inference(np.asarray([t]))),
                      (tl, lambda t: tl.inference(torch.tensor([t])))):
        logits = [_np(eng.prefill(prompt))]
        toks = [int(logits[0][0].argmax())]
        for _ in range(steps - 1):
            logits.append(_np(step(toks[-1])))
            toks.append(int(logits[-1][0].argmax()))
        runs.append((logits, toks, eng.avg_sparsity))
    return runs


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def lsh_mode_runs(bank_small):
    """bench.py's lsh mode: W8A8 fused weights, int8 offload."""
    jl, tl = _engines("int8", True, dict(LSH_KW, offload_quant="int8"), bank_small)
    assert isinstance(tl.params.layers.wqkv, tllama.QuantWeight)
    return _greedy(jl, tl)


def test_engine_lsh_mode_prefill_logits_match_jax(lsh_mode_runs):
    (jlog, _, _), (tlog, _, _) = lsh_mode_runs
    assert _rel(tlog[0], jlog[0]) < W8_LOGIT_TOL


def test_engine_lsh_mode_greedy_tokens_match_jax(lsh_mode_runs):
    (_, jtok, _), (_, ttok, _) = lsh_mode_runs
    assert ttok == jtok


def test_engine_lsh_mode_avg_sparsity_matches_jax(lsh_mode_runs):
    (_, _, jsp), (_, _, tsp) = lsh_mode_runs
    assert 0 < tsp < 1
    assert tsp == pytest.approx(jsp, abs=2e-3)


@pytest.mark.parametrize("K,L", [(1, 32), (4, 8)])
def test_engine_int8_offload_lsh_logits_match_jax(K, L):
    """Exact weights, int8 offload (tests/test_engine.py:231, its lsh case)."""
    bank = np.random.default_rng(42).standard_normal(
        (TCFG.head_dim, K * L)).astype(np.float32)
    jl, tl = _engines("none", False, dict(LSH_KW, K=K, L=L, offload_quant="int8"),
                      bank)
    (jlog, jtok, jsp), (tlog, ttok, tsp) = _greedy(jl, tl)
    for a, b in zip(tlog, jlog):
        assert _rel(a, b) < INT8_TOL
    assert ttok == jtok and tsp == pytest.approx(jsp, abs=2e-3)


def test_engine_full_int8_mode_with_w4_weights_tracks_jax(bank_small):
    """K=0, dense int8 K/V, int4 fused weights (tests/test_engine.py:286
    and :450 on the JAX side)."""
    jl, tl = _engines("int4", True, dict(LSH_KW, K=0, L=0, dense_quant="int8"),
                      bank_small)
    assert tl.state.dense_k[0].dtype == torch.int8
    (jlog, jtok, _), (tlog, ttok, _) = _greedy(jl, tl, steps=5)
    assert ttok[0] == jtok[0]
    for a, b in zip(tlog, jlog):
        assert _rel(a, b) < W4_LOGIT_TOL


def test_int8_weights_track_exact_weights():
    """The port's W8A8 engine against its exact-weight engine on the same
    weights (tests/test_engine.py:450): close logits, the same top-1."""
    p = tllama.init_params(TCFG, MAX_LEN, torch.Generator().manual_seed(0), "cpu")
    kw = dict(LSH_KW, K=0, L=0)
    exact = LLM(TCFG, max_length=MAX_LEN, params=p, lsh=LSHConfig(**kw), device="cpu")
    quant = LLM(TCFG, max_length=MAX_LEN, params=tllama.quantize_params(p),
                lsh=LSHConfig(**kw), device="cpu")
    prompt = np.random.default_rng(9).integers(1, TCFG.vocab_size, 80)
    ref, got = _np(exact.prefill(prompt)), _np(quant.prefill(prompt))
    assert _rel(got, ref) < 0.05
    assert got[0].argmax() == ref[0].argmax()
    assert np.isfinite(_np(quant.inference(torch.tensor([int(got[0].argmax())])))).all()


def test_lsh_engine_with_int8_offload_and_dense_int8_decodes():
    """Both int8 caches in one engine, two requests, decode_steps."""
    lsh = LSHConfig(**dict(LSH_KW, offload_quant="int8", dense_quant="int8"))
    tl = LLM(dataclasses.replace(TCFG, weight_quant="int4"), batch_size=2,
             max_length=MAX_LEN, lsh=lsh, device="cpu")
    tl.prefill(np.arange(1, 260), request_id=0)
    tl.prefill(np.arange(3, 150), request_id=1)
    toks = tl.decode_steps([1, 2], 3)
    assert toks.shape == (3, 2) and 0 < tl.avg_sparsity < 1
    assert torch.isfinite(tl.inference(torch.tensor([1, 2]))).all()

"""The block_topk estimator through the port's attention server and engine
against the JAX package's, on the CPU in float32, with the JAX weights
carried across (`models/convert.py::params_from_numpy`).

JAX runs its block_topk branch in two ways on the CPU: by default through
the XLA oracle `block_topk_decode`, and with `use_pallas="on"` through its
Pallas kernels in interpret mode, which is the path whose arithmetic the
port's kernels follow (q / sqrt(d) rounded to bf16 before the dot) and the
only one where the "rescore" and "store" pipelines differ. The server tests
and the engine at a sparse budget use the Pallas path; the engine at full
budget uses the default.

Tolerances: bf16 offload state exactly; int8 offload state exactly against
the JAX quantize_rows of the same rows, and within one int8 step and one
f32 ulp of the scale against the jitted JAX fill (XLA computes its amax /
127 as amax * f32(1/127)). A sparse layer's output 2e-3 with f32 values and
2e-2 with int8 ones: the Pallas attend rounds p (times the V scale) and V
to bf16, the port's plain attend rounds only p with int8 V; the inputs are
bf16 values so that V itself rounds alike. The engine at budget fraction
1.0, where every block is attended: prefill logits 1e-3 and decode logits
2e-3 of the largest logit, as tests/test_engine.py:175-176 holds block_topk
at full budget against full attention. At budget fraction 0.25: greedy
tokens equal, and the realized fraction (avg_sparsity) to 1e-6.
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
from magicpig_tpu.ops import quant as jquant
from magicpig_tpu.runtime import server as jserver
from magicpig_tpu.runtime import state as jstate
from magicpig_tpu.runtime.engine import LLM as JLLM
from magicpig_tpu_torch.config import LSHConfig, preset
from magicpig_tpu_torch.models.convert import params_from_numpy
from magicpig_tpu_torch.runtime import server as tserver
from magicpig_tpu_torch.runtime import state as tstate
from magicpig_tpu_torch.runtime.engine import LLM

MAX_LEN = 512
BLOCK_KW = dict(K=10, L=150, num_sink_tokens=4, num_local_tokens=16,
                generation_buffer=32, estimator="block_topk",
                block_topk_block_size=16)
JCFG = dataclasses.replace(jpreset("llama-tiny"), dtype=jnp.float32)
TCFG = dataclasses.replace(preset("llama-tiny"), dtype=torch.float32)
PREFILL_TOL = 1e-3
DECODE_TOL = 2e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bf16_values(rng, shape):
    """Normal draws rounded to bf16, as f32."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(torch.bfloat16).float().numpy()


# -- the attention server ------------------------------------------------------

_jfill_sparse = jax.jit(jserver.fill_sparse_layer, static_argnums=(1, 7))
_jdecode_sparse = jax.jit(jserver.decode_sparse_layer, static_argnums=(1, 6))


def _unfold_tokens(x):
    """JAX fold-major per-token values [B, Hkv, fold, cap/fold] -> [B, Hkv, cap]."""
    b, h, f, c = x.shape
    return np.asarray(x).transpose(0, 1, 3, 2).reshape(b, h, f * c)


@pytest.mark.parametrize("quant,pipeline", [
    ("int8", "rescore"), ("int8", "store"), ("none", "store")])
def test_sparse_layer_fill_and_decode_match_jax(quant, pipeline):
    kw = dict(BLOCK_KW, offload_quant=quant, block_topk_pipeline=pipeline,
              block_topk_budget_frac=0.25)
    jl, tl = JLSHConfig(use_pallas="on", **kw), LSHConfig(**kw)
    js = jstate.init_state(JCFG, jl, 2, MAX_LEN)
    ts = tstate.init_state(TCFG, tl, 2, MAX_LEN, "cpu")
    hkv, d = TCFG.num_key_value_heads, TCFG.head_dim
    rng = np.random.default_rng(0)
    keys, values = [], []
    for req, p in enumerate((300, 120)):
        k, v = _bf16_values(rng, (p, hkv, d)), _bf16_values(rng, (p, hkv, d))
        keys.append(k)
        values.append(v)
        pad = np.zeros((320 - p, hkv, d), np.float32)
        js = _jfill_sparse(js, 1, jnp.int32(req),
                           jnp.asarray(np.concatenate([k, pad])),
                           jnp.asarray(np.concatenate([v, pad])),
                           jnp.int32(p), jnp.zeros((d, 1)), jl)
        tserver.fill_sparse_layer(ts, 1, req, _t(k), _t(v), None, tl)
    np.testing.assert_array_equal(_np(ts.off_len), np.asarray(js.off_len))
    np.testing.assert_array_equal(_np(ts.hot_len), np.asarray(js.hot_len))
    assert ts.off_k[1].shape[2] == js.off_k[1].shape[2] * 128 // d   # capacity
    assert not ts.planes and not ts.avg_k and not ts.k_norm
    # The jitted JAX fill computes the scale as amax * f32(1/127): XLA turns
    # the division by the constant into that product, which is one ulp off
    # amax / 127 in some rows and so moves a few int8 values by one step.
    # The port divides, as the JAX source does; its bytes equal the eager
    # JAX quantize_rows of the same rows exactly.
    for name, src in (("off_k", keys), ("off_v", values)):
        want = np.asarray(getattr(js, name)[1]).reshape(2, hkv, -1, d)
        got = _np(getattr(ts, name)[1])
        assert got.dtype == (np.int8 if quant == "int8" else np.float32)
        for req in range(2):
            n = int(ts.off_len[req])
            if quant == "int8":
                diff = np.abs(got[req, :, :n].astype(int) - want[req, :, :n])
                assert diff.max() <= 1 and diff.mean() < 1e-2
                rows = jnp.asarray(src[req][4:4 + n].transpose(1, 0, 2))
                np.testing.assert_array_equal(
                    got[req, :, :n], np.asarray(jquant.quantize_rows(rows)[0]))
            else:
                np.testing.assert_array_equal(got[req, :, :n], want[req, :, :n])
    if quant == "int8":
        for name in ("off_k_scale", "off_v_scale"):
            want = _unfold_tokens(getattr(js, name)[1])
            got = _np(getattr(ts, name)[1])
            for req in range(2):
                n = int(ts.off_len[req])
                np.testing.assert_allclose(got[req, :, :n], want[req, :, :n],
                                           rtol=2.5e-7, atol=0)
    else:
        assert not ts.off_k_scale and not ts.off_v_scale

    for _ in range(2):
        q = _bf16_values(rng, (2, TCFG.num_attention_heads, d))
        kn, vn = _bf16_values(rng, (2, hkv, d)), _bf16_values(rng, (2, hkv, d))
        jo, js, jfrac = _jdecode_sparse(js, 1, jnp.asarray(q), jnp.asarray(kn),
                                        jnp.asarray(vn), jnp.zeros((d, 1)), jl)
        to, tfrac = tserver.decode_sparse_layer(ts, 1, _t(q), _t(kn), _t(vn),
                                                None, tl)
        ts.hot_len += 1
        js = js.replace(hot_len=js.hot_len + 1)
        tol = 2e-2 if quant == "int8" else DECODE_TOL
        np.testing.assert_allclose(_np(to), np.asarray(jo), atol=tol, rtol=tol)
        assert float(tfrac) == pytest.approx(float(jfrac), abs=1e-7)
        assert 0 < float(tfrac) < 1


def test_static_budget_and_realized_fraction_match_jax():
    for n, frac, floor in ((32, 0.08, 1), (4, 0.25, 1), (100, 0.02, 16),
                           (3, 0.5, 16)):
        assert (tserver._static_budget(n, frac, floor)
                == jserver._static_budget(n, frac, floor))
    for lens in ((11932, 6932), (0, 0), (100, 2000)):
        got = tserver._realized_frac(1536, torch.tensor(lens, dtype=torch.int32))
        want = jserver._realized_frac(1536, jnp.asarray(lens, jnp.int32))
        assert float(got) == float(want)


# -- the engine ----------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(JCFG, jax.random.key(0), MAX_LEN)
    tree = dataclasses.asdict(jax.tree_util.tree_map(np.asarray, jp))
    return jp, params_from_numpy(tree, device="cpu")


def _run(weights, quant, frac, use_pallas, steps=5):
    """Prefill + greedy steps in both engines: (JAX logits, tokens,
    sparsity), (port logits, tokens, sparsity)."""
    jp, tp = weights
    kw = dict(BLOCK_KW, offload_quant=quant, block_topk_budget_frac=frac)
    jl = JLLM(JCFG, max_length=MAX_LEN, chunk_size=64, params=jp,
              lsh=JLSHConfig(use_pallas=use_pallas, **kw))
    tl = LLM(TCFG, max_length=MAX_LEN, params=tp, lsh=LSHConfig(**kw),
             device="cpu")
    prompt = np.random.default_rng(0).integers(1, TCFG.vocab_size, 300).astype(np.int32)
    runs = []
    for eng, step in ((jl, lambda t: jl.inference(np.asarray([t]))),
                      (tl, lambda t: tl.inference(torch.tensor([t])))):
        logits = [_np(eng.prefill(prompt))]
        toks = [int(logits[0][0].argmax())]
        for _ in range(steps):
            logits.append(_np(step(toks[-1])))
            toks.append(int(logits[-1][0].argmax()))
        runs.append((logits, toks, eng.avg_sparsity))
    return runs


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_engine_full_budget_matches_jax(weights, quant):
    (jlog, jtok, jsp), (tlog, ttok, tsp) = _run(weights, quant, 1.0, "auto")
    np.testing.assert_allclose(tlog[0], jlog[0], atol=PREFILL_TOL, rtol=PREFILL_TOL)
    for a, b in zip(tlog[1:], jlog[1:]):
        assert np.abs(a - b).max() / np.abs(b).max() < DECODE_TOL
    assert ttok == jtok
    assert tsp == jsp == 1.0


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_engine_sparse_budget_matches_jax(weights, quant):
    (_, jtok, jsp), (_, ttok, tsp) = _run(weights, quant, 0.25, "on")
    assert ttok == jtok
    assert 0 < tsp < 1
    assert tsp == pytest.approx(jsp, abs=1e-6)


def test_engine_decodes_after_clear():
    """After clear() every offload length is 0: the chosen blocks hold no
    valid token, the partial is empty and the logits stay finite."""
    lsh = LSHConfig(**dict(BLOCK_KW, offload_quant="int8",
                           block_topk_budget_frac=0.25))
    tl = LLM(TCFG, batch_size=2, max_length=MAX_LEN, lsh=lsh, device="cpu")
    tl.prefill(np.arange(1, 200), request_id=1)
    tl.clear()
    toks = tl.decode_steps([1, 2], 3)
    assert toks.shape == (3, 2)
    assert torch.isfinite(tl.inference(torch.tensor([1, 2]))).all()
    assert tl.avg_sparsity == 0.0

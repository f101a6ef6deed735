"""`runtime/synthetic.py::synthetic_prefill` against the JAX package's, on
the CPU at the tiny float32 size of `tests/test_synthetic.py` (B = 2,
max_length 1024, 896 tokens): with the port's draw replaced by JAX's draws
(the key chain of `magicpig_tpu/runtime/synthetic.py`), the port's fills
leave JAX's state, read through the JAX layouts (token-folded caches,
fold-major scales and norms, block-striped planes); then decode runs on it.

Tolerances: float32 caches and means 1e-6, norms 1e-5 (sums in another
order); int8 rows equal, or one step off where JAX's jitted quantizer
multiplies by 1/127 and the port divides (ROADMAP C, "int8 scales under
jax.jit"), scales to 2.5e-7 of their value, or 1e-6 for LSH's centered
keys (centered by a mean summed in another order, off by an ulp);
lengths, positions and signature bits exactly.
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
from magicpig_tpu.ops import bitcodes as jbits
from magicpig_tpu.runtime.engine import LLM as JLLM
from magicpig_tpu.runtime.synthetic import synthetic_prefill as j_synthetic_prefill
from magicpig_tpu_torch.config import LSHConfig, preset
from magicpig_tpu_torch.models.convert import params_from_numpy
from magicpig_tpu_torch.ops import bitcodes as tbits
from magicpig_tpu_torch.runtime import synthetic
from magicpig_tpu_torch.runtime.engine import LLM

SEQ = 896
MAX_LEN = 1024
JCFG = dataclasses.replace(jpreset("llama-tiny"), dtype=jnp.float32)
TCFG = dataclasses.replace(preset("llama-tiny"), dtype=torch.float32)
MODES = {   # tests/test_synthetic.py's configurations, quest aside (A8)
    "full_int8": dict(K=0, L=0, dense_quant="int8"),
    "lsh_int8": dict(K=4, L=8, decode_mode="masked", offload_quant="int8"),
    "block_topk": dict(K=1, L=0, estimator="block_topk", offload_quant="int8"),
}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax_draws(seed, hkv, d):
    """JAX's draws in synthetic_prefill's order, one (K, V) pair a call."""
    key = jax.random.key(seed)

    def draw(gen, seq_len, hkv_, d_, dtype, device):
        nonlocal key
        key, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)
        return tuple(torch.from_numpy(np.array(jax.random.normal(
            kk, (seq_len, hkv, d), jnp.float32))) for kk in (k1, k2))
    return draw


def _unfold(x):
    """JAX's fold-major per-token values [B, Hkv, fold, S/fold] -> [B, Hkv, S]."""
    b, h, f, c = x.shape
    return np.asarray(x).transpose(0, 1, 3, 2).reshape(b, h, f * c)


def _rows(x, d):
    """JAX's token-folded rows [B, Hkv, S/fold, d*fold] -> [B, Hkv, S, d]."""
    x = np.asarray(x)
    return x.reshape(x.shape[0], x.shape[1], -1, d)


def _check_int8(got, want, got_scale, want_scale, rtol=2.5e-7):
    step = np.abs(got.astype(int) - want.astype(int))
    assert step.max() <= 1 and step.mean() < 1e-2
    np.testing.assert_allclose(got_scale, want_scale, rtol=rtol, atol=0)


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(JCFG, jax.random.key(0), MAX_LEN)
    tree = dataclasses.asdict(jax.tree_util.tree_map(np.asarray, jp))
    return jp, params_from_numpy(tree, device="cpu")


@pytest.mark.parametrize("mode", list(MODES))
def test_synthetic_state_matches_jax_then_decodes(weights, mode, monkeypatch):
    jp, tp = weights
    kw = MODES[mode]
    jl = JLLM(JCFG, batch_size=2, max_length=MAX_LEN, params=jp,
              lsh=JLSHConfig(**kw), seed=0)
    tl = LLM(TCFG, batch_size=2, max_length=MAX_LEN, params=tp,
             lsh=LSHConfig(**kw), device="cpu",
             projections=torch.from_numpy(np.array(jl.projections)))
    j_synthetic_prefill(jl, SEQ, seed=1)
    hkv, d = TCFG.num_key_value_heads, TCFG.head_dim
    monkeypatch.setattr(synthetic, "draw_kv", _jax_draws(1, hkv, d))
    assert synthetic.synthetic_prefill(tl, SEQ, seed=1) is tl
    js, ts = jl.state, tl.state

    for name in ("pos", "dense_len", "hot_len", "off_len"):
        np.testing.assert_array_equal(_np(getattr(ts, name)),
                                      np.asarray(getattr(js, name)), err_msg=name)
    assert tl._hot_used == jl._hot_used and tl._pos_used == jl._pos_used
    n = int(ts.dense_len[0])
    for i in range(len(ts.dense_k)):
        for kv in ("k", "v"):
            got = _np(getattr(ts, f"dense_{kv}")[i])[:, :, :n]
            want = _rows(getattr(js, f"dense_{kv}")[i], d)[:, :, :n]
            if ts.dense_k_scale:
                _check_int8(got, want,
                            _np(getattr(ts, f"dense_{kv}_scale")[i])[:, :, :n],
                            _unfold(getattr(js, f"dense_{kv}_scale")[i])[:, :, :n])
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    n, h = int(ts.off_len[0]), int(ts.hot_len[0])
    for i in range(len(ts.off_k)):
        for kv in ("k", "v"):
            np.testing.assert_allclose(
                _np(getattr(ts, f"hot_{kv}")[i])[:, :, :h],
                np.asarray(getattr(js, f"hot_{kv}")[i])[:, :, :h],
                rtol=1e-6, atol=1e-6)
            _check_int8(_np(getattr(ts, f"off_{kv}")[i])[:, :, :n],
                        _rows(getattr(js, f"off_{kv}")[i], d)[:, :, :n],
                        _np(getattr(ts, f"off_{kv}_scale")[i])[:, :, :n],
                        _unfold(getattr(js, f"off_{kv}_scale")[i])[:, :, :n],
                        rtol=1e-6 if kv == "k" and ts.planes else 2.5e-7)
    for i in range(len(ts.planes)):
        np.testing.assert_allclose(_np(ts.avg_k[i]), np.asarray(js.avg_k[i]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_np(ts.k_norm[i])[:, :, :n],
                                   _unfold(js.k_norm[i])[:, :, :n],
                                   rtol=1e-5, atol=1e-6)
        cap = ts.off_k[i].shape[2]
        fold = max(128 // d, 1)
        blk = jbits.plane_block(cap, fold)
        got = _np(tbits.unpack_words(ts.planes[i], cap))[..., :n]
        want = np.asarray(jbits.unpack_words_blocked(js.planes[i], blk, fold,
                                                     cap))[..., :n]
        np.testing.assert_array_equal(got, want)
    assert len(ts.planes) == (len(ts.off_k) if mode == "lsh_int8" else 0)

    toks = tl.decode_steps(torch.zeros((2,), dtype=torch.int64), 3)
    assert toks.shape == (3, 2)
    assert 0.0 <= tl.avg_sparsity <= 1.0


def test_synthetic_prefill_refuses_lengths_outside_the_state(weights):
    _, tp = weights
    tl = LLM(TCFG, batch_size=1, max_length=MAX_LEN, params=tp,
             lsh=LSHConfig(K=4, L=8), device="cpu")
    for n in (MAX_LEN + 1, 68):
        with pytest.raises(ValueError, match="outside"):
            synthetic.synthetic_prefill(tl, n)

"""The LSH debias forms of the port ("exact", "poly", "none") against the
JAX package on the CPU.

Coefficients: the port's numpy fit of log(w + 1e-4) equals the JAX
package's `log_weight_poly` to 1e-12 (the same float64 computation).

Kernels: the plain fused LSH decode (collision mask, then
`lsh_masked_decode`) with debias "poly" and "none", bf16-valued and int8
K/V, against the Pallas kernel `lsh_fused_attention2` in interpret mode
with the same debias, to 3e-3 (tests/test_pallas_kernels.py:366-392 holds
the kernel to its oracle so); sampled counts exactly. The JAX XLA path
(`ops/attention.py::lsh_masked_decode`) applies the exact weight for
"poly" (only its Pallas kernels evaluate the polynomial), so the port's
"poly" is held against the Pallas kernel, and its "none" against both.

The sparse layer with int4 offload K and the polynomial debias, fill and
two decode steps through the port's server against the JAX server with
`use_pallas="on"` (its Pallas kernels in interpret mode): sampled
fractions to 2e-3 and outputs to 2e-2 (`JAX_DEBIAS_TOL`, as
tests/test_torch_int8.py holds the int8 layer: SimHash signs at |proj| ~ 0
and float32 rounding of the dequantized keys move a few samples).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicpig_tpu.config import LSHConfig as JLSHConfig
from magicpig_tpu.config import preset as jpreset
from magicpig_tpu.ops import attention as jatt
from magicpig_tpu.ops import bitcodes as jbits
from magicpig_tpu.ops import debias as jdebias
from magicpig_tpu.ops.pallas.lsh_decode import lsh_fused_decode as j_route
from magicpig_tpu.ops.pallas.lsh_fused import lsh_fused_attention2
from magicpig_tpu.runtime import server as jserver
from magicpig_tpu.runtime import state as jstate
from magicpig_tpu_torch.config import LSHConfig, preset
from magicpig_tpu_torch.ops import bitcodes as tbits
from magicpig_tpu_torch.ops import debias as tdebias
from magicpig_tpu_torch.ops.kernels import LAUNCHES, lsh_decode, lsh_fused_decode
from magicpig_tpu_torch.ops.quant import dequantize_rows, quantize_rows
from magicpig_tpu_torch.runtime import server as tserver
from magicpig_tpu_torch.runtime import state as tstate

KERNEL_TOL = 3e-3
JAX_DEBIAS_TOL = 2e-2
MAX_LEN = 512
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


@pytest.mark.parametrize("K,L", [(10, 150), (1, 32), (6, 20)])
def test_poly_coefficients_equal_jax(K, L):
    got, want = tdebias.log_weight_poly(K, L), jdebias.log_weight_poly(K, L)
    assert len(got) == len(want) == tdebias.POLY_DEGREE + 1
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    c = np.linspace(-1.0, 1.0, 101)
    np.testing.assert_array_equal(tdebias.exact_log_weight(c, K, L),
                                  jdebias.exact_log_weight(c, K, L))
    if (K, L) == (10, 150):
        # The fit tracks the exact log-weight: the JAX module's own claim
        # is a largest error of 0.014 at K=10, L=150. (At K=1 it departs
        # by several units near cos = -1, where w falls to 0.)
        fit = _np(tdebias.eval_poly(torch.from_numpy(c), got))
        assert np.abs(fit - tdebias.exact_log_weight(c, K, L)).max() < 0.015


def _lsh_inputs(seed, B, HKV, G, S, D, K, L, quant):
    """Keys planted near each group's first query (a non-empty sample);
    norms and signatures of the keys as stored (dequantized for int8)."""
    rng = np.random.default_rng(seed)
    q = _bf16_values(rng, (B, HKV * G, D))
    kc = rng.standard_normal((B, HKV, S, D)).astype(np.float32)
    kc[:, :, 5:40] = q.reshape(B, HKV, G, D)[:, :, :1] + 0.3 * kc[:, :, 5:40]
    v = _bf16_values(rng, (B, HKV, S, D))
    if quant:
        k, ks = quantize_rows(_t(kc))
        v, vs = quantize_rows(_t(v))
        kd = _np(dequantize_rows(k, ks, torch.float32))
    else:
        k = _t(kc).to(torch.bfloat16)
        kd = k.float().numpy()
        v, ks, vs = _t(v).to(torch.bfloat16), None, None
    proj = rng.standard_normal((D, K * L)).astype(np.float32)
    length = np.asarray(([S, S // 2 + 17] * B)[:B], np.int32)
    return dict(q=q, k=k, v=v, ks=ks, vs=vs, kd=kd,
                knorm=np.linalg.norm(kd, axis=-1), proj=proj, length=length)


def _j_fused(x, K, L, D, debias):
    """The Pallas kernel (interpret mode) on the same inputs; at odd L
    JAX's own route, `lsh_decode.py::lsh_fused_decode`: the scan, then the
    Pallas masked attend."""
    fold = max(128 // D, 1)
    blk = jbits.plane_block(x["kd"].shape[2], fold)
    planes = jax.vmap(lambda kb: jbits.build_planes_blocked(
        kb.transpose(1, 0, 2), jnp.asarray(x["proj"]), K, blk, fold))(
            jnp.asarray(x["kd"]))
    qb = jbits.hash_bits(jnp.asarray(x["q"]), jnp.asarray(x["proj"]), K)
    quant = x["ks"] is not None
    as_j = (lambda t: jnp.asarray(_np(t)) if quant
            else jnp.asarray(t.float().numpy(), jnp.bfloat16))
    return (lsh_fused_attention2 if L % 2 == 0 else j_route)(
        jnp.asarray(x["q"]), as_j(x["k"]), as_j(x["v"]),
        jnp.asarray(x["knorm"]), planes, qb, jnp.asarray(x["length"]), K, L,
        interpret=True,
        k_scale=jnp.asarray(_fold_major(x["ks"], D)) if quant else None,
        v_scale=jnp.asarray(_fold_major(x["vs"], D)) if quant else None,
        debias=debias)


def _t_fused(x, K, L, debias):
    """The port's fused kernel on the same inputs; at odd L its route,
    `lsh_decode`: the collision words, then the masked attend."""
    planes = torch.stack([tbits.build_planes(_t(kd).transpose(0, 1),
                                             _t(x["proj"]), K) for kd in x["kd"]])
    qb = tbits.hash_bits(_t(x["q"]), _t(x["proj"]), K)
    return (lsh_fused_decode if L % 2 == 0 else lsh_decode)(
        _t(x["q"]), x["k"], x["v"], _t(x["knorm"]), planes, qb,
        _t(x["length"]), K, L, x["ks"], x["vs"], debias)


@pytest.mark.parametrize("quant,debias,D,L", [
    *(pytest.param(quant, debias, d, 20, id=f"{quant}-{debias}" + (
        "" if d == 64 else f"-d{d}"))
      for d in (64, 128)                     # 128: Llama-3.1-8B's head dim
      for quant in (False, True) for debias in ("poly", "none")),
    # Odd L at d = 128: both packages' two-stage routes, each debias form.
    *(pytest.param(quant, debias, 128, 21, id=f"{quant}-{debias}-d128-odd-l")
      for quant in (False, True) for debias in ("exact", "poly", "none"))])
def test_lsh_debias_plain_matches_pallas_fused(quant, debias, D, L):
    B, HKV, G, S, K = 2, 2, 4, 256, 6
    x = _lsh_inputs(3, B, HKV, G, S, D, K, L, quant)
    jo, jl, jc = _j_fused(x, K, L, D, debias)
    before = dict(LAUNCHES)
    to, tl, tc = _t_fused(x, K, L, debias)
    assert LAUNCHES == before                  # the CPU takes the plain version
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    assert _np(tc).reshape(B, HKV, G)[:, :, 0].min() > 0     # the planted heads
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=KERNEL_TOL,
                               rtol=KERNEL_TOL)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=KERNEL_TOL,
                               rtol=KERNEL_TOL)


def test_lsh_debias_none_matches_the_xla_oracle_and_differs_from_exact():
    """tests/test_pallas_kernels.py:366-392 on the port: "none" drops the
    reweight (the JAX XLA oracle's "none" agrees), and the knob does
    something."""
    B, HKV, G, S, D, K, L = 1, 2, 2, 256, 64, 6, 20
    x = _lsh_inputs(12, B, HKV, G, S, D, K, L, quant=False)
    none, _, cnt = _t_fused(x, K, L, "none")
    exact, _, _ = _t_fused(x, K, L, "exact")
    poly, _, _ = _t_fused(x, K, L, "poly")
    planes = torch.stack([tbits.build_planes(_t(kd).transpose(0, 1),
                                             _t(x["proj"]), K) for kd in x["kd"]])
    mask = tbits.sampled_mask(tbits.hash_bits(_t(x["q"]), _t(x["proj"]), K),
                              planes, _t(x["length"]))
    jo, _ = jatt.lsh_masked_decode(
        jnp.asarray(x["q"]), jnp.asarray(x["kd"]), jnp.asarray(x["v"].float().numpy()),
        jnp.asarray(x["knorm"]), jnp.asarray(_np(mask)), jnp.asarray(x["length"]),
        K, L, debias="none")
    np.testing.assert_allclose(_np(none), np.asarray(jo), atol=KERNEL_TOL,
                               rtol=KERNEL_TOL)
    assert np.abs(_np(exact) - _np(none)).max() > 1e-4
    # The polynomial approximates the exact weight: closer to it than none.
    assert np.abs(_np(poly) - _np(exact)).max() < np.abs(_np(none) - _np(exact)).max()
    assert float(cnt.min()) > 0


# -- the sparse layer: int4 offload K with the polynomial debias ---------------

_jfill_sparse = jax.jit(jserver.fill_sparse_layer, static_argnums=(1, 7))
_jdecode_sparse = jax.jit(jserver.decode_sparse_layer, static_argnums=(1, 6))


def test_lsh_int4_poly_sparse_layer_matches_jax_pallas():
    """llama-tiny widths (d 16), K=6, L=20; two requests of 300 and 120
    tokens; JAX through its Pallas kernels in interpret mode, the only
    JAX path that evaluates the polynomial."""
    kw = dict(K=6, L=20, num_sink_tokens=4, num_local_tokens=16,
              generation_buffer=32, offload_quant="int4", lsh_debias="poly")
    jl, tl = JLSHConfig(use_pallas="on", **kw), LSHConfig(**kw)
    js = jstate.init_state(JCFG, jl, 2, MAX_LEN)
    ts = tstate.init_state(TCFG, tl, 2, MAX_LEN, "cpu")
    rng = np.random.default_rng(21)
    bank = rng.standard_normal((TCFG.head_dim, 6 * 20)).astype(np.float32)
    for req, p in enumerate((300, 120)):
        k, v = _bf16_values(rng, (p, 2, 16)), _bf16_values(rng, (p, 2, 16))
        pad = np.zeros((320 - p, 2, 16), np.float32)
        js = _jfill_sparse(js, 1, jnp.int32(req), jnp.asarray(np.concatenate([k, pad])),
                           jnp.asarray(np.concatenate([v, pad])), jnp.int32(p),
                           jnp.asarray(bank), jl)
        tserver.fill_sparse_layer(ts, 1, req, _t(k), _t(v), _t(bank), tl)
    # K on the 4-bit grid in the int8 layout; V int8.
    assert ts.off_k[1].shape == ts.off_v[1].shape
    assert int(ts.off_k[1].abs().max()) == 7 and int(ts.off_v[1].abs().max()) == 127
    for _ in range(2):
        q = _bf16_values(rng, (2, 8, 16))
        kn, vn = _bf16_values(rng, (2, 2, 16)), _bf16_values(rng, (2, 2, 16))
        jo, js, jfrac = _jdecode_sparse(js, 1, jnp.asarray(q), jnp.asarray(kn),
                                        jnp.asarray(vn), jnp.asarray(bank), jl)
        to, tfrac = tserver.decode_sparse_layer(ts, 1, _t(q), _t(kn), _t(vn),
                                                _t(bank), tl)
        ts.hot_len += 1
        js = js.replace(hot_len=js.hot_len + 1)
        assert 0 < float(tfrac) < 1
        assert float(tfrac) == pytest.approx(float(jfrac), abs=2e-3)
        np.testing.assert_allclose(_np(to), np.asarray(jo), atol=JAX_DEBIAS_TOL,
                                   rtol=JAX_DEBIAS_TOL)

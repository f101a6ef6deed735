"""The port's plain PyTorch ops against the JAX package's, on the CPU.

Inputs come from numpy under fixed seeds and go through both packages.
Tolerances: float32 paths 1e-4, except against the JAX debias, whose float32
cancellation sets the bound (`test_debias_matches_jax`); collision words and
masks exactly, given the same projection bank and the
same keys (`hash_bits` signs agree except where a projection is at float
rounding scale, which these inputs do not reach).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicpig_tpu import config as jcfg
from magicpig_tpu.ops import attention as jatt
from magicpig_tpu.ops import bitcodes as jbits
from magicpig_tpu.ops.debias import collision_weight as j_collision_weight
from magicpig_tpu.ops.debias import debias_scores as j_debias_scores
from magicpig_tpu.ops.hashing import hash_codes as j_hash_codes
from magicpig_tpu.ops.merge import merge_partials as j_merge
from magicpig_tpu.ops.norms import rms_norm as j_rms_norm
from magicpig_tpu.ops.rope import apply_rope as j_apply_rope
from magicpig_tpu.ops.rope import rope_cos_sin as j_rope_cos_sin
from magicpig_tpu.runtime import state as jstate
from magicpig_tpu.utils.tokenizer import ByteTokenizer as JByteTokenizer
from magicpig_tpu_torch import config as tcfg
from magicpig_tpu_torch.ops import attention as tatt
from magicpig_tpu_torch.ops import bitcodes as tbits
from magicpig_tpu_torch.ops.debias import collision_weight, debias_scores
from magicpig_tpu_torch.ops.merge import merge_partials
from magicpig_tpu_torch.ops.norms import rms_norm
from magicpig_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from magicpig_tpu_torch.ops.sampling import greedy_sample, top_p_sample
from magicpig_tpu_torch.runtime import state as tstate
from magicpig_tpu_torch.utils.tokenizer import ByteTokenizer

F32 = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- config ------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(tcfg.PRESETS))
def test_presets_match_jax_field_for_field(name):
    t, j = tcfg.preset(name), jcfg.preset(name)
    for f in dataclasses.fields(t):
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if f.name == "dtype":
            assert tv == torch.bfloat16 and jv == jnp.bfloat16
        elif f.name == "rope_scaling" and tv is not None:
            assert dataclasses.asdict(tv) == dataclasses.asdict(jv)
        else:
            assert tv == jv, f.name


@pytest.mark.parametrize("n", [1, 4, 16, 17, 33, 80])
def test_default_dense_layers_match_jax(n):
    assert tcfg.default_dense_layers(n) == jcfg.default_dense_layers(n)
    assert (tcfg.LSHConfig().dense_layers_for(n)
            == jcfg.LSHConfig().dense_layers_for(n))
    assert (tcfg.LSHConfig(K=0).dense_layers_for(n)
            == jcfg.LSHConfig(K=0).dense_layers_for(n))


@pytest.mark.parametrize("field,value", [
    ("estimator", "quest"), ("estimator", "topk"),
    ("estimator", "oracle_sampling")])
def test_unported_lsh_options_raise(field, value):
    """The reference's baselines construct with the JAX package's budgets
    and dense layers; a name neither package knows raises ValueError."""
    t, j = tcfg.LSHConfig(**{field: value}), jcfg.LSHConfig(**{field: value})
    for f in ("quest_page_size", "quest_budget_frac", "topk_budget_frac",
              "os_budget_frac"):
        assert getattr(t, f) == getattr(j, f), f
    for n in (1, 2, 16, 33):
        assert t.dense_layers_for(n) == j.dense_layers_for(n)
    with pytest.raises(ValueError, match=field):
        tcfg.LSHConfig(**{field: value + "_x"})


@pytest.mark.parametrize("mode", ["gathered", "dense", ""])
def test_unknown_decode_mode_raises(mode):
    with pytest.raises(ValueError, match="decode_mode"):
        tcfg.LSHConfig(decode_mode=mode)


@pytest.mark.parametrize("estimator", ["lsh", "block_topk"])
@pytest.mark.parametrize("offload,dense", [("int8", "none"), ("none", "int8"),
                                           ("int8", "int8")])
def test_int8_cache_options_match_jax(estimator, offload, dense):
    """int8 offload (either estimator) and dense int8 K/V are ported."""
    t = tcfg.LSHConfig(estimator=estimator, offload_quant=offload,
                       dense_quant=dense)
    j = jcfg.LSHConfig(estimator=estimator, offload_quant=offload,
                       dense_quant=dense)
    assert t.offload_quantized == j.offload_quantized
    assert t.dense_quantized == j.dense_quantized


@pytest.mark.parametrize("estimator", ["lsh", "block_topk"])
@pytest.mark.parametrize("debias", ["exact", "poly", "none"])
def test_int4_offload_and_debias_options_match_jax(estimator, debias):
    """int4 offload (K on the 4-bit grid, V int8) and the three debias forms
    are ported. The port packs block_topk's int4 K at any even head dim;
    the JAX package only at 512-token blocks and d >= 64, where both
    pack."""
    kw = dict(estimator=estimator, offload_quant="int4", lsh_debias=debias)
    t, j = tcfg.LSHConfig(**kw), jcfg.LSHConfig(**kw)
    assert t.offload_quantized == j.offload_quantized
    assert t.offload_k_bits == j.offload_k_bits == 4
    assert t.lsh_debias == j.lsh_debias
    assert t.packed_k4(64) == j.packed_k4(64) == (estimator == "block_topk")
    small = tcfg.LSHConfig(block_topk_block_size=16, **kw)
    assert small.packed_k4(16) == (estimator == "block_topk")
    assert tcfg.LSHConfig(estimator=estimator).offload_k_bits == 8


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_block_topk_config_matches_jax(quant):
    """The ported block_topk options, their defaults, dense layers and the
    offload capacity (whole ranking blocks) are the JAX package's."""
    t = tcfg.LSHConfig(estimator="block_topk", offload_quant=quant)
    j = jcfg.LSHConfig(estimator="block_topk", offload_quant=quant)
    assert tcfg.ESTIMATORS == jcfg.ESTIMATORS
    for f in ("block_topk_block_size", "block_topk_budget_frac",
              "block_topk_pipeline", "offload_quantized"):
        assert getattr(t, f) == getattr(j, f), f
    for n in (2, 16, 33):
        assert t.dense_layers_for(n) == j.dense_layers_for(n)
    for max_len, bs in ((16384, 512), (512, 16), (700, 64), (300, 512)):
        tc = dataclasses.replace(t, block_topk_block_size=bs)
        jc = dataclasses.replace(j, block_topk_block_size=bs)
        assert tstate.offload_capacity(tc, max_len) == jstate.offload_capacity(
            jc, max_len, 64)
    with pytest.raises(ValueError):
        tcfg.LSHConfig(estimator="block_topk", block_topk_pipeline="other")


# -- rope, norm --------------------------------------------------------------


@pytest.mark.parametrize("name", ["llama-tiny", "llama-3.2-1b"])
def test_rope_matches_jax(name):
    rng = np.random.default_rng(0)
    tc, jc = tcfg.preset(name), jcfg.preset(name)
    cos, sin = rope_cos_sin(tc, 64, device="cpu")
    jcos, jsin = j_rope_cos_sin(jc, 64)
    np.testing.assert_allclose(_np(cos), np.asarray(jcos), atol=F32, rtol=F32)
    np.testing.assert_allclose(_np(sin), np.asarray(jsin), atol=F32, rtol=F32)
    x = rng.standard_normal((2, 5, 3, tc.head_dim)).astype(np.float32)
    pos = rng.integers(0, 64, (2, 5))
    got = apply_rope(_t(x), cos, sin, _t(pos))
    want = j_apply_rope(jnp.asarray(x), jcos, jsin, jnp.asarray(pos))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=F32, rtol=F32)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, 32)).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    got = rms_norm(_t(x), _t(w), 1e-5)
    want = j_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=F32, rtol=F32)


# -- hashing, signatures, collision scan ---------------------------------------


def _bank(seed, d, K, L):
    return np.random.default_rng(seed).standard_normal((d, K * L)).astype(np.float32)


def test_hash_bits_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 16)).astype(np.float32)
    proj = _bank(3, 16, 6, 20)
    got = tbits.hash_bits(_t(x), _t(proj), 6)
    want = jbits.hash_bits(jnp.asarray(x), jnp.asarray(proj), 6)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("K,L", [(6, 20), (10, 150), (4, 7)])
def test_planes_and_collision_words_match_jax_exactly(K, L):
    """Flat bit-planes, the >=2-of-L scan and the valid-length mask are
    bit-identical to the JAX flat-layout functions."""
    rng = np.random.default_rng(4)
    B, HKV, G, S, D = 2, 2, 4, 256, 16
    keys = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
    q = rng.standard_normal((B, HKV * G, D)).astype(np.float32)
    # Plant near-copies of the queries so that some keys collide.
    keys[:, 10:30] = q.reshape(B, HKV, G, D)[:, :, :1].transpose(0, 2, 1, 3) \
        + 0.1 * keys[:, 10:30]
    proj = _bank(5, D, K, L)
    length = np.asarray([S, 150], np.int32)

    planes = torch.stack([tbits.build_planes(_t(keys[b]), _t(proj), K)
                          for b in range(B)])
    jplanes = jnp.stack([jbits.build_planes(jnp.asarray(keys[b]),
                                            jnp.asarray(proj), K, chunk=64)
                         for b in range(B)])
    np.testing.assert_array_equal(_np(planes), np.asarray(jplanes))

    qb = tbits.hash_bits(_t(q), _t(proj), K)
    jqb = jbits.hash_bits(jnp.asarray(q), jnp.asarray(proj), K)
    words = tbits.collision_words(qb, planes)
    jwords = jbits.collision_words(jqb, jplanes)
    np.testing.assert_array_equal(_np(words), np.asarray(jwords))
    np.testing.assert_array_equal(
        _np(tbits.valid_words(_t(length), S // 32)),
        np.asarray(jbits.valid_words(jnp.asarray(length), S // 32)))
    mask = tbits.sampled_mask(qb, planes, _t(length))
    jmask = jbits.unpack_words(
        jwords & jbits.valid_words(jnp.asarray(length), S // 32)[:, None], S)
    np.testing.assert_array_equal(_np(mask), np.asarray(jmask))
    assert _np(mask).any()


def test_collision_mask_from_codes_matches_jax():
    rng = np.random.default_rng(6)
    B, HKV, G, S, L = 2, 2, 2, 64, 12
    qc = rng.integers(0, 4, (B, HKV * G, L)).astype(np.int32)
    kc = rng.integers(0, 4, (B, HKV, L, S)).astype(np.int32)
    got = tatt.collision_mask(_t(qc), _t(kc))
    want = jatt.collision_mask(jnp.asarray(qc), jnp.asarray(kc))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert _np(got).any() and not _np(got).all()


def test_collision_mask_agrees_with_bitplane_scan():
    """Per-table codes and bit-planes give the same >=2-of-L set."""
    rng = np.random.default_rng(7)
    B, HKV, G, S, D, K, L = 1, 2, 2, 64, 16, 3, 10
    keys = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
    q = rng.standard_normal((B, HKV * G, D)).astype(np.float32)
    proj = _bank(8, D, K, L)
    kcodes = np.asarray(j_hash_codes(jnp.asarray(keys), jnp.asarray(proj), K))
    qcodes = np.asarray(j_hash_codes(jnp.asarray(q), jnp.asarray(proj), K))
    by_codes = tatt.collision_mask(_t(qcodes), _t(kcodes.transpose(0, 2, 3, 1)))
    planes = tbits.build_planes(_t(keys[0]), _t(proj), K)[None]
    qb = tbits.hash_bits(_t(q), _t(proj), K)
    by_planes = tbits.sampled_mask(qb, planes, torch.tensor([S], dtype=torch.int32))
    np.testing.assert_array_equal(_np(by_codes), _np(by_planes))


# -- debias, merge, decode ------------------------------------------------------


@pytest.mark.parametrize("K,L", [(10, 150), (6, 41), (1, 32)])
def test_debias_matches_float64_reference(K, L):
    """The port's collision weight carries no float32 cancellation: its
    log(w + 1e-4) agrees with the float64 formula to 1e-4 over all cos."""
    from magicpig_tpu.ops.debias import exact_log_weight
    cos = np.linspace(-1, 1, 20001).astype(np.float32)
    got = np.log(_np(collision_weight(_t(cos), K, L)).astype(np.float64) + 1e-4)
    np.testing.assert_allclose(got, exact_log_weight(cos.astype(np.float64), K, L),
                               atol=F32, rtol=0)


@pytest.mark.parametrize("K,L", [(10, 150), (6, 41), (1, 32)])
def test_debias_matches_jax(K, L):
    """Against the JAX form, which computes w as 1 - x with x near 1: its w
    is off by up to ~(L-1) float32 roundings of 1 (2^-24 each), and its
    log(w + 1e-4) by that over the 1e-4 floor."""
    w_tol = 2 * (L - 1) * 2.0 ** -24 + 1e-7
    log_tol = w_tol / 1e-4 + F32
    rng = np.random.default_rng(9)
    cos = rng.uniform(-1, 1, 257).astype(np.float32)
    np.testing.assert_allclose(_np(collision_weight(_t(cos), K, L)),
                               np.asarray(j_collision_weight(jnp.asarray(cos), K, L)),
                               atol=w_tol, rtol=0)
    raw = rng.standard_normal((3, 40)).astype(np.float32) * 4
    qn = np.abs(rng.standard_normal((3, 1))).astype(np.float32) * 3 + 2
    kn = np.abs(rng.standard_normal((3, 40))).astype(np.float32) * 3 + 2
    got = debias_scores(_t(raw), _t(qn), _t(kn), 64, K, L)
    want = j_debias_scores(jnp.asarray(raw), jnp.asarray(qn), jnp.asarray(kn),
                           64, K, L)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=log_tol, rtol=0)


def test_merge_partials_matches_jax_with_empty_partials():
    rng = np.random.default_rng(10)
    o = [rng.standard_normal((2, 4, 8)).astype(np.float32) for _ in range(3)]
    l = [rng.standard_normal((2, 4)).astype(np.float32) for _ in range(3)]
    l[1][0, :] = -np.inf                 # one partial empty for a row
    for x in l:
        x[1, 2] = -np.inf                # every partial empty for a row
    got_o, got_l = merge_partials([_t(x) for x in o], [_t(x) for x in l])
    want_o, want_l = j_merge([jnp.asarray(x) for x in o],
                             [jnp.asarray(x) for x in l])
    np.testing.assert_allclose(_np(got_o), np.asarray(want_o), atol=F32, rtol=F32)
    np.testing.assert_allclose(_np(got_l), np.asarray(want_l), atol=F32, rtol=F32)
    assert np.isneginf(_np(got_l)[1, 2]) and (_np(got_o)[1, 2] == 0).all()


@pytest.mark.parametrize("G,D", [(4, 64), (2, 16)])
def test_full_decode_matches_jax(G, D):
    rng = np.random.default_rng(11)
    B, HKV, S = 3, 2, 96
    q = rng.standard_normal((B, HKV * G, D)).astype(np.float32)
    k = rng.standard_normal((B, HKV, S, D)).astype(np.float32)
    v = rng.standard_normal((B, HKV, S, D)).astype(np.float32)
    length = np.asarray([S, 40, 0], np.int32)
    o, l = tatt.full_decode(_t(q), _t(k), _t(v), _t(length))
    jo, jl = jatt.full_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(length))
    np.testing.assert_allclose(_np(o), np.asarray(jo), atol=F32, rtol=F32)
    np.testing.assert_allclose(_np(l), np.asarray(jl), atol=F32, rtol=F32)
    assert (_np(o)[2] == 0).all() and np.isneginf(_np(l)[2]).all()


# -- sampling, tokenizer --------------------------------------------------------


def test_greedy_sample_matches_jax():
    from magicpig_tpu.ops.sampling import greedy_sample as j_greedy
    logits = np.random.default_rng(12).standard_normal((4, 50)).astype(np.float32)
    np.testing.assert_array_equal(_np(greedy_sample(_t(logits))),
                                  np.asarray(j_greedy(jnp.asarray(logits))))


def test_top_p_sample_keeps_the_nucleus():
    """Only tokens inside the top-p nucleus are ever drawn (the draws
    themselves come from a torch generator, not JAX's)."""
    # probabilities ~ (0.50, 0.30, 0.19, 0.01, 0): the first two tokens hold
    # 0.80 of the mass, so top_p = 0.7 keeps exactly those two.
    logits = torch.log(torch.tensor([[0.50, 0.30, 0.19, 0.01, 1e-9]]))
    gen = torch.Generator().manual_seed(0)
    draws = {int(top_p_sample(gen, logits, temperature=1.0, top_p=0.7)[0])
             for _ in range(200)}
    assert draws == {0, 1}
    assert int(top_p_sample(gen, logits, temperature=1.0, top_p=1e-6)[0]) == 0


def test_byte_tokenizer_matches_jax():
    text = "needle: 42 — café"
    assert ByteTokenizer().encode(text) == JByteTokenizer().encode(text)
    assert ByteTokenizer().decode(ByteTokenizer().encode(text)) == text

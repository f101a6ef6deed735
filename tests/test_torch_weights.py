"""The port's quantized weights against the JAX package's, on the CPU.

Tolerances: the quantizers, the nibble packing and the converters exactly
(byte for byte against the eager JAX functions). The W8A8 `linear`
against eager JAX `linear`: 1e-6 relative to the output's largest value
(both quantize the activations with the same float32 steps and take an
exact integer product; the rescale rounds in float32) and exactly in the
model dtype for bf16. The packed-nibble matmul's plain version against the
Pallas kernel in interpret mode: 1e-6 relative to the largest output, both
sum bf16 values times exact nibbles in float32, in another order. The int4
products that do not take the kernel (the W4A8 grouped integer product and
the dequantized weight) against JAX `_linear4_part`: 1e-6 relative, the
same float32 steps. Fused weights equal the unfused ones exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicpig_tpu.config import ModelConfig as JModelConfig
from magicpig_tpu.models import llama as jllama
from magicpig_tpu.ops.pallas.w4_matmul import w4_block_shapes
from magicpig_tpu.ops.pallas.w4_matmul import w4_matmul as j_w4_matmul
from magicpig_tpu_torch.config import ModelConfig, preset
from magicpig_tpu_torch.models import llama as tllama
from magicpig_tpu_torch.models.convert import params_from_numpy
from magicpig_tpu_torch.ops.kernels import LAUNCHES, w4_matmul
from magicpig_tpu_torch.ops.kernels.w4_matmul import (
    split_k,
    w4_matmul_plain,
    w4_supported,
)

REL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rel=REL):
    want = np.asarray(want, np.float32)
    err = np.abs(_np(got).astype(np.float32) - want).max()
    assert err <= rel * np.abs(want).max(), err / np.abs(want).max()


def _weights(seed, shape, scale=0.05):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)


# -- quantizers and the nibble layout -----------------------------------------


@pytest.mark.parametrize("shape", [(256, 192), (3, 128, 64), (2, 384, 40)])
def test_quantize_weight_is_bit_exact_with_jax(shape):
    w = _weights(0, shape)
    w[..., 5] = 0.0                        # a zero channel: scale 0, q 0
    tq = tllama.quantize_weight(_t(w))
    jq = jllama.quantize_weight(jnp.asarray(w))
    np.testing.assert_array_equal(_np(tq.q), np.asarray(jq.q))
    np.testing.assert_array_equal(_np(tq.scale), np.asarray(jq.scale))


@pytest.mark.parametrize("shape", [(256, 192), (3, 128, 64), (2, 384, 128)])
def test_quantize_weight4_is_bit_exact_with_jax(shape):
    w = _weights(1, shape)
    w[..., :128, 3] = 0.0                  # a zero group
    tq = tllama.quantize_weight4(_t(w))
    jq = jllama.quantize_weight4(jnp.asarray(w))
    assert tq.q.dtype == torch.int8
    np.testing.assert_array_equal(_np(tq.q), np.asarray(jq.q))
    np.testing.assert_array_equal(_np(tq.scale), np.asarray(jq.scale))


def test_pack_and_unpack_nibbles_match_jax():
    """Every value in [-7, 7] in both nibbles, packed and unpacked."""
    rng = np.random.default_rng(2)
    q = rng.integers(-7, 8, (2, 256, 24)).astype(np.int8)
    tp = tllama._pack_nibbles(_t(q))
    jp = jllama._pack_nibbles(jnp.asarray(q))
    np.testing.assert_array_equal(_np(tp), np.asarray(jp))
    np.testing.assert_array_equal(_np(tllama.unpack_weight4(tp)), q)
    # Every byte, as the kernel sees packed weights.
    b = np.arange(-128, 128, dtype=np.int8).reshape(64, 4)
    np.testing.assert_array_equal(_np(tllama.unpack_weight4(_t(b))),
                                  np.asarray(jllama.unpack_weight4(jnp.asarray(b))))


# -- linear ------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 2, 37])
def test_int8_linear_matches_eager_jax(dtype, m):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((m, 256)).astype(np.float32)
    x[0] = 0.0                             # a zero row: scale 0
    w = _weights(4, (256, 96))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx = jnp.asarray(x).astype(jdt)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(tdt)
    want = jllama.linear(jx, jllama.quantize_weight(jnp.asarray(w).astype(jdt)))
    got = tllama.linear(tx, tllama.quantize_weight(_t(w).to(tdt)))
    assert got.dtype == tdt
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_np(got.float()),
                                      np.asarray(want.astype(jnp.float32)))
    else:
        _close(got, want)


@pytest.mark.parametrize("m,kin,out", [(1, 512, 384), (3, 2048, 256),
                                       (8, 4096, 512), (5, 3072, 128),
                                       (2, 128, 128), (64, 1024, 256)])
def test_w4_matmul_plain_matches_pallas(m, kin, out):
    """The shapes of tests/test_w4.py's kernel test, and the largest M."""
    rng = np.random.default_rng(7)
    w = jllama.quantize_weight4(jnp.asarray(rng.standard_normal((kin, out)) / 8,
                                            jnp.float32))
    x = rng.standard_normal((m, kin)).astype(np.float32)
    want = j_w4_matmul(jnp.asarray(x).astype(jnp.bfloat16), w.q, w.scale,
                       interpret=True)
    before = dict(LAUNCHES)
    got = w4_matmul(_t(x), _t(w.q), _t(w.scale))     # rounds x to bf16 itself
    assert LAUNCHES == before
    assert got.dtype == torch.float32 and got.shape == (m, out)
    _close(got, want)


@pytest.mark.parametrize("m,kin,out", [
    (1, 512, 384), (64, 2048, 256), (2, 2048, 16384), (2, 8192, 2048),
    (65, 512, 512), (128, 512, 512), (1, 192, 512), (1, 512, 192),
    (1, 2816 * 2, 512), (3, 3072, 128), (1, 2048, 128256)])
def test_w4_routing_predicate_matches_w4_block_shapes(m, kin, out):
    """Including the shapes tests/test_w4.py:195 rejects."""
    assert w4_supported(m, kin, out) == (w4_block_shapes(m, kin, out) is not None)


# The plans `split_k` makes: the served shapes' (q|k|v, o, gate|up, down,
# lm_head at M=2) are the splits chip_smoke.py's sweep of 1 to 16 measured
# fastest or within noise of it on the card (PERF.md).
W4_SPLITS = {(2048, 3072, 2): (16, 1), (2048, 2048, 2): (16, 1),
             (2048, 16384, 2): (4, 4), (8192, 2048, 2): (16, 4),
             (2048, 128256, 2): (1, 16), (1024, 256, 64): (8, 1),
             (4096, 512, 7): (16, 2)}


@pytest.mark.parametrize("kin,out,m", [(2048, 3072, 2), (2048, 2048, 2),
                                       (2048, 16384, 2), (8192, 2048, 2),
                                       (2048, 128256, 2), (1024, 256, 64),
                                       (4096, 512, 7)])
def test_w4_split_k_covers_whole_groups(kin, out, m):
    """Every split non-empty, at most 16 groups (the shared-memory x slice)
    in one, at most 16 splits (the loads of the block that sums them)
    where 16 groups a split allow; each plan the one pinned above."""
    groups = kin // 128
    ks, per = split_k(kin, out, m)
    assert (ks, per) == W4_SPLITS[(kin, out, m)]
    assert 1 <= ks <= groups and 1 <= per <= 16
    assert (ks - 1) * per < groups <= ks * per
    assert ks <= max(16, -(-groups // 16))


@pytest.mark.parametrize("m", [600, 100])
def test_linear4_without_the_kernel_matches_jax(m):
    """M >= 512: the dequantized weight; 64 < M < 512: the W4A8 grouped
    integer product (JAX `_linear4_part`, both branches)."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((m, 512)).astype(np.float32)
    w = jllama.quantize_weight4(jnp.asarray(_weights(9, (512, 256))))
    want = jllama._linear4_part(jnp.asarray(x), w.q, w.scale)
    got = tllama._linear4_part(_t(x), _t(w.q), _t(w.scale))
    _close(got, want)
    tw = tllama.Quant4Weight(q=_t(w.q), scale=_t(w.scale))
    _close(tllama.linear(_t(x), tw), want)


def test_linear4_takes_the_kernel_function_at_decode_size():
    """M <= 64 at kernel shapes: bf16 x times exact nibbles, no activation
    quantization (the JAX package's TPU route)."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 1, 512)).astype(np.float32)
    w = tllama.quantize_weight4(_t(_weights(11, (512, 256))))
    got = tllama.linear(_t(x), w)
    want = w4_matmul_plain(_t(x).reshape(2, 512), w.q, w.scale).reshape(2, 1, 256)
    assert torch.equal(got, want)


# -- params: fuse, quantize, init, convert -----------------------------------------


JCFG = JModelConfig(name="t", vocab_size=64, hidden_size=128,
                    intermediate_size=256, num_hidden_layers=2,
                    num_attention_heads=4, num_key_value_heads=2, head_dim=32,
                    rope_theta=1e4, rope_scaling=None,
                    max_position_embeddings=256, eos_token_ids=(0,),
                    dtype=jnp.float32)
TCFG = ModelConfig(name="t", vocab_size=64, hidden_size=128,
                   intermediate_size=256, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=2, head_dim=32,
                   rope_theta=1e4, rope_scaling=None,
                   max_position_embeddings=256, eos_token_ids=(0,),
                   dtype=torch.float32)


def _tree(jp):
    return dataclasses.asdict(jax.tree_util.tree_map(np.asarray, jp))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_and_fuse_match_jax(bits):
    """quantize_params of the same exact weights gives the eager JAX
    quantizer's bytes, and the jitted JAX quantize_params' within one ulp of
    each scale and one step of each value (under jit XLA computes amax / 127
    as amax * f32(1/127)); the fused projections equal the unfused ones
    exactly (mirrors tests/test_w4.py::test_fused_qkv_gateup_matches_unfused)."""
    jp = jllama.init_params(JCFG, jax.random.key(0), 64)
    tp = params_from_numpy(_tree(jp), device="cpu")
    tq = tllama.quantize_params(tp, bits=bits)
    jq = jllama.quantize_params(jp, bits=bits)
    eager = jllama.quantize_weight if bits == 8 else jllama.quantize_weight4
    kind = tllama.QuantWeight if bits == 8 else tllama.Quant4Weight
    assert isinstance(tq.layers.wq, kind) and isinstance(tq.lm_head, kind)
    pairs = [(getattr(tq.layers, n), getattr(jp.layers, n), getattr(jq.layers, n))
             for n in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")]
    for got, exact, jitted in pairs + [(tq.lm_head, jp.lm_head, jq.lm_head)]:
        want = eager(exact)
        np.testing.assert_array_equal(_np(got.q), np.asarray(want.q))
        np.testing.assert_array_equal(_np(got.scale), np.asarray(want.scale))
        np.testing.assert_allclose(_np(got.scale), np.asarray(jitted.scale),
                                   rtol=2.5e-7, atol=0)
        if bits == 8:
            step = np.abs(_np(got.q).astype(int) - np.asarray(jitted.q))
            assert step.max() <= 1
    tf = tllama.fuse_params(tq)
    assert tf.layers.wq is None and tf.layers.w_gate is None
    # 100 rows: every int4 product, fused or not, takes the W4A8 route (at
    # decode size a 128-aligned output takes the kernel, another does not).
    rng = np.random.default_rng(0)
    hidden = _t(rng.standard_normal((2, 50, 128)).astype(np.float32))
    pos = torch.zeros((2, 50), dtype=torch.long)
    for i in range(2):
        a = tllama.qkv_proj(tq.layers.layer(i), TCFG, hidden, pos, tp.cos, tp.sin)
        b = tllama.qkv_proj(tf.layers.layer(i), TCFG, hidden, pos, tp.cos, tp.sin)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
            assert y.is_contiguous()          # the kernels take dense rows
        attn = _t(rng.standard_normal((2, 50, 128)).astype(np.float32))
        assert torch.equal(
            tllama.post_attention(tq.layers.layer(i), TCFG, attn, hidden),
            tllama.post_attention(tf.layers.layer(i), TCFG, attn, hidden))


@pytest.mark.parametrize("quant,fuse", [("int8", False), ("int8", True),
                                        ("int4", False), ("int4", True)])
def test_params_from_numpy_carries_quantized_and_fused_trees(quant, fuse):
    """JAX init_params under weight_quant (and fuse_small_linears) carried
    across: every leaf equal, the kinds right, None slots None; and the
    layer math on them matches JAX's (W4 at M = 100 takes the W4A8 product
    in both)."""
    jcfg = dataclasses.replace(JCFG, weight_quant=quant, fuse_small_linears=fuse)
    tcfg = dataclasses.replace(TCFG, weight_quant=quant, fuse_small_linears=fuse)
    jp = jllama.init_params(jcfg, jax.random.key(1), 64)
    tp = params_from_numpy(_tree(jp), device="cpu")
    kind = tllama.QuantWeight if quant == "int8" else tllama.Quant4Weight
    names = (("wqkv", "wo", "w_gateup", "w_down") if fuse else
             ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"))
    for name in ("wq", "wk", "wv", "w_gate", "w_up", "wqkv", "w_gateup"):
        if name not in names:
            assert getattr(tp.layers, name) is None
    for name in names:
        tw, jw = getattr(tp.layers, name), getattr(jp.layers, name)
        assert isinstance(tw, kind)
        np.testing.assert_array_equal(_np(tw.q), np.asarray(jw.q))
        np.testing.assert_array_equal(_np(tw.scale), np.asarray(jw.scale))
    assert isinstance(tp.lm_head, kind)
    np.testing.assert_array_equal(_np(tp.lm_head.scale), np.asarray(jp.lm_head.scale))
    rng = np.random.default_rng(2)
    hidden = rng.standard_normal((2, 50, 128)).astype(np.float32)
    pos = np.zeros((2, 50), np.int32)
    jq, _, _ = jllama.qkv_proj(jp.layers.layer(1), jcfg, jnp.asarray(hidden),
                               jnp.asarray(pos), jp.cos, jp.sin)
    tq, _, _ = tllama.qkv_proj(tp.layers.layer(1), tcfg, _t(hidden),
                               _t(pos).long(), tp.cos, tp.sin)
    _close(tq, jq, 1e-5)


@pytest.mark.parametrize("quant,fuse", [("int8", True), ("int4", False)])
def test_init_params_quantized_on_the_device(quant, fuse):
    """init_params draws and quantizes per layer: quantized kinds and
    shapes, an exact embedding, a tied lm_head as its own quantized copy of
    embed.T, fused slots under fuse_small_linears."""
    cfg = dataclasses.replace(preset("llama-tiny"), weight_quant=quant,
                              fuse_small_linears=fuse, tie_word_embeddings=True)
    p = tllama.init_params(cfg, 64, torch.Generator().manual_seed(0), "cpu")
    kind = tllama.QuantWeight if quant == "int8" else tllama.Quant4Weight
    n, h = cfg.num_hidden_layers, cfg.hidden_size
    assert p.embed.dtype == cfg.dtype
    assert isinstance(p.lm_head, kind)
    assert p.lm_head.q.is_contiguous() and p.lm_head.scale.is_contiguous()
    want = (tllama.quantize_weight if quant == "int8"
            else tllama.quantize_weight4)(p.embed.T)
    assert torch.equal(p.lm_head.q, want.q)
    assert torch.equal(p.lm_head.scale, want.scale)
    wo = p.layers.wo
    assert isinstance(wo, kind)
    assert wo.q.shape == ((n, h, h) if quant == "int8" else (n, h // 2, h))
    assert (p.layers.wqkv is not None) == fuse
    assert (p.layers.wq is None) == fuse
    layer = p.layers.layer(1)
    assert isinstance(layer.w_down, kind) and layer.w_down.q.dim() == 2


def test_weight_quant_is_checked():
    with pytest.raises(ValueError):
        dataclasses.replace(preset("llama-tiny"), weight_quant="int2")
    with pytest.raises(TypeError):
        tllama.fuse_params(tllama.init_params(
            preset("llama-tiny"), 64, torch.Generator().manual_seed(0), "cpu"))

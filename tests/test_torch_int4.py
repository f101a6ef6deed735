"""int4 offload K in the port against the JAX package on the CPU: the 4-bit
grid, the port's packed layout, the plain versions of the packed block
kernels, the int4 fills of both estimators and the engines.

Layouts: the port packs K along the head dimension (byte j of a token's row
holds channel j and channel j + d/2, `magicpig_tpu_torch/ops/pack4.py`),
tokens in order; the JAX package pairs folded rows across the two halves of
each 512-token span and keeps scores, scales and length masks in a
2*fold-group layout (`magicpig_tpu/ops/pack4.py`), and packs only at
512-token blocks (below that its int4 K keeps the int8 layout). The tests
convert the JAX state: `unpack_rows`, `ungroup_scales`, then the port's
`pack_k4`.

Tolerances: 4-bit rows, their scales and packed bytes exactly against the
eager JAX quantizer (the jitted JAX fill computes amax / 7 as amax *
f32(1/7): within one 4-bit step and one f32 ulp of the scale). Scores and
block maxes 2e-2 and top-k block ids exactly on separated block maxes, as
tests/test_pack4.py and tests/test_torch_block_kernels.py hold the scorer;
the attends 2e-2 (int8 V, tests/test_torch_block_kernels.py:48-50). A
sparse layer's output 2e-2 with int8 V. Engines: int4 offload within 0.25
of the largest bf16-offload logit at decode and 1e-3 at prefill, JAX's own
bound (tests/test_engine.py:261-285); against the JAX engine at full block
budget, prefill logits 1e-3 and decode logits `INT4_DECODE_TOL` of the
largest, as tests/test_torch_block_topk.py holds int8 offload (measured up
to 6.4e-4), greedy tokens equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicpig_tpu.config import LSHConfig as JLSHConfig
from magicpig_tpu.config import ModelConfig as JModelConfig
from magicpig_tpu.config import preset as jpreset
from magicpig_tpu.models import llama as jllama
from magicpig_tpu.ops import pack4 as jpack4
from magicpig_tpu.ops import quant as jquant
from magicpig_tpu.ops.pallas.block_attend import block_attend as j_block_attend
from magicpig_tpu.ops.pallas.rescore_attend import rescore_attend as j_rescore_attend
from magicpig_tpu.ops.pallas.score import block_rank as j_block_rank
from magicpig_tpu.ops.pallas.score import exact_scores_ranked as j_exact_scores_ranked
from magicpig_tpu.runtime import server as jserver
from magicpig_tpu.runtime import state as jstate
from magicpig_tpu.runtime.engine import LLM as JLLM
from magicpig_tpu_torch.config import LSHConfig, ModelConfig, preset
from magicpig_tpu_torch.models.convert import params_from_numpy
from magicpig_tpu_torch.ops import bitcodes as tbits
from magicpig_tpu_torch.ops import pack4 as tpack4
from magicpig_tpu_torch.ops import quant as tquant
from magicpig_tpu_torch.ops.kernels import (
    LAUNCHES,
    block_attend,
    block_rank,
    exact_scores_ranked,
    rescore_attend,
)
from magicpig_tpu_torch.ops.kernels.block_score import block_scores_plain
from magicpig_tpu_torch.runtime import server as tserver
from magicpig_tpu_torch.runtime import state as tstate
from magicpig_tpu_torch.runtime.engine import LLM

SCORE_TOL = 2e-2
INT8_V_TOL = 2e-2
PREFILL_TOL = 1e-3
INT4_DRIFT = 0.25
INT4_DECODE_TOL = 2e-3
SPAN = jpack4.SPAN_TOKENS
B, HKV, G, D = 2, 2, 4, 64
FOLD = 128 // D


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().cpu().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bf16_values(rng, shape):
    """Normal draws rounded to bf16, as f32."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(torch.bfloat16).float().numpy()


def _unfold_tokens(x):
    """JAX fold-major per-token values [B, Hkv, fold, cap/fold] -> [B, Hkv, cap]."""
    b, h, f, c = x.shape
    return np.asarray(x).transpose(0, 1, 3, 2).reshape(b, h, f * c)


def _from_jax_k(off_k, off_k_scale, d, packed):
    """JAX int4 offload K state -> the port's (packed bytes [B, Hkv, S,
    d/2], token-order scales [B, Hkv, S])."""
    fold = max(128 // d, 1)
    rows = jpack4.unpack_rows(off_k, fold) if packed else off_k
    b, h = rows.shape[:2]
    k = torch.from_numpy(np.asarray(rows).reshape(b, h, -1, d))
    scale = (jpack4.ungroup_scales(off_k_scale, fold) if packed
             else _unfold_tokens(off_k_scale))
    return tpack4.pack_k4(k), torch.from_numpy(np.asarray(scale))


# -- the 4-bit grid and the packed layout ----------------------------------------


def test_pack_k4_roundtrip_and_nibbles_equal_jax():
    rng = np.random.default_rng(0)
    k = torch.from_numpy(rng.integers(-7, 8, (3, 5, 64)).astype(np.int8))
    packed = tpack4.pack_k4(k)
    assert packed.shape == (3, 5, 32) and packed.dtype == torch.int8
    assert torch.equal(tpack4.unpack_k4(packed), k)
    # byte j: channel j in the low nibble, channel j + 32 in the high one
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jquant.pack_nibbles(jnp.asarray(k[..., :32].numpy()),
                                                       jnp.asarray(k[..., 32:].numpy()))))
    lo, hi = tquant.unpack_nibbles(packed)
    jlo, jhi = jquant.unpack_nibbles(jnp.asarray(packed.numpy()))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    assert tpack4.is_packed(torch.zeros(1, 8, 64), packed)
    assert not tpack4.is_packed(torch.zeros(1, 8, 64), k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_rows_4bit_is_bit_exact_with_eager_jax(dtype):
    """The 4-bit grid (qmax 7) stored in int8; a zero row and values at
    halfway points of the grid in."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 2, 50, 64)).astype(np.float32) * 3
    x[0, 0, 7] = 0.0                                  # zero row: scale 0
    x[1, 1, 3, :4] = [7.0, 0.5, -1.5, 2.5]            # halves round to even
    tx = torch.from_numpy(x).to(dtype)
    jx = jnp.asarray(tx.float().numpy(),
                     jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    tq, ts = tquant.quantize_rows(tx, bits=4)
    jq, js = jquant.quantize_rows(jx, 4)
    assert int(tq.abs().max()) == 7
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq[1, 1, 3, 1] == 0 and tq[1, 1, 3, 3] == 2    # 0.5 -> 0, 2.5 -> 2


def test_second_4bit_pass_keeps_the_values():
    """The LSH fill quantizes the centered keys at 4 bits, dequantizes them
    (the keys norms and signatures describe), and quantizes those again for
    storage, as the JAX fill does (`server.py:211`, `:269`). The second
    pass gives the same 4-bit values and the same scales: its scale is
    fl(fl(7 s) / 7) with s = fl(amax / 7), which is s again (for an
    arbitrary float32 s, fl(fl(7 s) / 7) differs from s about one time in
    eight). Both passes equal the eager JAX ones."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((4, 2000, 16)).astype(np.float32))
    q1, s1 = tquant.quantize_rows(x, 4)
    q2, s2 = tquant.quantize_rows(tquant.dequantize_rows(q1, s1, torch.float32), 4)
    assert torch.equal(q1, q2) and torch.equal(s1, s2)
    jq1, js1 = jquant.quantize_rows(jnp.asarray(x.numpy()), 4)
    jq2, js2 = jquant.quantize_rows(jquant.dequantize_rows(jq1, js1, jnp.float32), 4)
    np.testing.assert_array_equal(q2.numpy(), np.asarray(jq2))
    np.testing.assert_array_equal(s2.numpy(), np.asarray(js2))


# -- the plain packed kernels against the JAX packed kernels ---------------------


def _inputs(seed, s=2 * SPAN, lengths=(2 * SPAN - 200, 700), planted=False,
            d=D):
    """q; K on the 4-bit grid (the port's packed bytes and JAX's packed
    rows, from the same values); int8 V; lengths; head dim d (JAX folds
    128 // d tokens a row, one at d = 128). `planted`: one key per block
    along the group's summed query, with strengths far apart, so the block
    maxes are ordered."""
    rng = np.random.default_rng(seed)
    fold = max(128 // d, 1)
    q = rng.standard_normal((B, HKV * G, d)).astype(np.float32)
    k = rng.standard_normal((B, HKV, s, d)).astype(np.float32)
    v = rng.standard_normal((B, HKV, s, d)).astype(np.float32)
    if planted:
        qsum = q.reshape(B, HKV, G, d).sum(axis=2)
        qdir = qsum / np.linalg.norm(qsum, axis=-1, keepdims=True)
        for b in range(B):
            for h in range(HKV):
                strength = 4.0 + 3.0 * rng.permutation(s // SPAN)
                for j in range(s // SPAN):
                    k[b, h, j * SPAN + 5] = strength[j] * qdir[b, h]
    tq = torch.from_numpy(q).to(torch.bfloat16)
    kq, ks = tquant.quantize_rows(torch.from_numpy(k), 4)
    vq, vs = tquant.quantize_rows(torch.from_numpy(v))
    length = torch.tensor(lengths, dtype=torch.int32)
    jk = jpack4.pack_rows(jnp.asarray(kq.numpy()).reshape(B, HKV, s // fold, 128), fold)
    return dict(q=tq, kp=tpack4.pack_k4(kq), kq=kq, ks=ks, vq=vq, vs=vs,
                length=length, jq=jnp.asarray(tq.float().numpy(), jnp.bfloat16),
                jk=jk, jks=jpack4.group_scales(jnp.asarray(ks.numpy()), fold),
                jmask=jpack4.group_length_mask(jnp.asarray(lengths, jnp.int32), s, fold),
                jv=jnp.asarray(vq.numpy()).reshape(B, HKV, s // fold, 128),
                jvs=jnp.asarray(vs.numpy()).reshape(B, HKV, s // fold, fold).transpose(0, 1, 3, 2),
                fold=fold)


def _group_to_tokens(x, s, fold=FOLD):
    """JAX packed-group scores [B, Hkv, 2*fold*G, s/(2 fold)] -> token order
    [B, Hkv, G, s] (`group_token_index`)."""
    idx = np.asarray(jpack4.group_token_index(s, fold))       # [2 fold, cols]
    x = np.asarray(x).reshape(B, HKV, 2 * fold, G, -1)
    out = np.full((B, HKV, G, s), np.nan, np.float32)
    for g2 in range(2 * fold):
        out[..., idx[g2]] = x[:, :, g2]
    return out


def test_packed_scorer_plain_matches_pallas():
    """tests/test_pack4.py:67 on the port: scores in token order and block
    maxes, from the packed Pallas scorer (both of its entry points)."""
    _packed_scorer_case(D)


def test_packed_scorer_plain_matches_pallas_d128():
    """The same at head dim 128 (Llama-3.1-8B's; block_topk4 at 8B width):
    JAX's packed state at fold 1 against the port's bytes holding channels
    j and j + 64."""
    _packed_scorer_case(128)


def _packed_scorer_case(d):
    x = _inputs(3, d=d)
    s = x["kp"].shape[2]
    scores, bmax = block_scores_plain(x["q"], x["kp"], x["ks"], x["length"], SPAN)
    args = (x["jq"], x["jk"], x["jks"], x["jmask"], SPAN)
    j_scores, j_bmax = j_exact_scores_ranked(*args, interpret=True, packed=True)
    j_rank = j_block_rank(*args, interpret=True, packed=True)
    np.testing.assert_allclose(_np(scores), _group_to_tokens(j_scores, s, x["fold"]),
                               atol=SCORE_TOL, rtol=SCORE_TOL)
    np.testing.assert_allclose(_np(bmax), np.asarray(j_bmax), atol=SCORE_TOL, rtol=SCORE_TOL)
    np.testing.assert_allclose(_np(bmax), np.asarray(j_rank), atol=SCORE_TOL, rtol=SCORE_TOL)
    # The packed plain scores equal the int8 plain scores of the unpacked rows.
    unpacked = block_scores_plain(x["q"], x["kq"], x["ks"], x["length"], SPAN)
    assert torch.equal(scores, unpacked[0]) and torch.equal(bmax, unpacked[1])
    assert torch.isneginf(scores[1, :, :, 700:]).all()


def test_packed_top_k_block_ids_equal_jax():
    x = _inputs(4, s=4 * SPAN, lengths=(4 * SPAN, 3 * SPAN + 9), planted=True)
    bmax = block_rank(x["q"], x["kp"], x["ks"], x["length"], SPAN)
    j_bmax = j_block_rank(x["jq"], x["jk"], x["jks"], x["jmask"], SPAN,
                          interpret=True, packed=True)
    srt = np.sort(_np(bmax), axis=-1)
    assert (np.diff(srt, axis=-1) > SCORE_TOL).all()
    ids = torch.topk(bmax, 3, dim=-1).indices
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jax.lax.top_k(j_bmax, 3)[1]))


@pytest.mark.parametrize("which,d", [
    pytest.param(which, d, id=which + ("" if d == D else f"-d{d}"))
    for d in (D, 128) for which in ("rescore", "block")])
def test_packed_attends_plain_match_pallas(which, d):
    """tests/test_pack4.py:114,156 on the port: the rescore pipeline
    (packed K rescored) and the store pipeline (stored token-order scores
    with the unchanged block_attend) against the packed Pallas kernels, on
    the blocks JAX ranks first; request 1 leaves its last block empty; at
    head dims 64 and 128."""
    s = 4 * SPAN
    x = _inputs(5, s=s, lengths=(s - 300, SPAN + 100), d=d)
    j_scores, j_bmax = j_exact_scores_ranked(x["jq"], x["jk"], x["jks"], x["jmask"],
                                             SPAN, interpret=True, packed=True)
    _, j_ids = jax.lax.top_k(j_bmax, 3)
    ids = torch.from_numpy(np.array(j_ids)).to(torch.int32)
    before = dict(LAUNCHES)
    if which == "rescore":
        out, lse = rescore_attend(x["q"], ids, x["kp"], x["ks"], x["vq"], x["vs"],
                                  x["length"], SPAN)
        j_out, j_lse = j_rescore_attend(x["jq"], j_ids, x["jk"], x["jks"], x["jv"],
                                        x["jvs"], jnp.asarray(x["length"].numpy()),
                                        SPAN, d, interpret=True, packed=True)
    else:
        scores, _ = exact_scores_ranked(x["q"], x["kp"], x["ks"], x["length"], SPAN)
        out, lse = block_attend(scores, ids, x["vq"], x["vs"], SPAN)
        j_out, j_lse = j_block_attend(j_scores, j_ids, x["jv"], x["jvs"], SPAN, d,
                                      interpret=True, packed=True)
    assert LAUNCHES == before
    np.testing.assert_allclose(_np(out), np.asarray(j_out), atol=INT8_V_TOL, rtol=INT8_V_TOL)
    np.testing.assert_allclose(_np(lse), np.asarray(j_lse), atol=INT8_V_TOL, rtol=INT8_V_TOL)
    # The packed rescore equals the int8 rescore of the unpacked rows.
    if which == "rescore":
        ref = rescore_attend(x["q"], ids, x["kq"], x["ks"], x["vq"], x["vs"],
                             x["length"], SPAN)
        assert torch.equal(out, ref[0]) and torch.equal(lse, ref[1])


# -- the block_topk sparse layer -------------------------------------------------

_jfill_sparse = jax.jit(jserver.fill_sparse_layer, static_argnums=(1, 7))
_jdecode_sparse = jax.jit(jserver.decode_sparse_layer, static_argnums=(1, 6))


@pytest.mark.parametrize("block_size,pipeline", [
    (SPAN, "rescore"), (SPAN, "store"), (16, "rescore")])
def test_block_topk_int4_layer_fill_and_decode_match_jax(block_size, pipeline):
    """d = 64, one sparse layer, two requests. Block size 512 is JAX's
    packed case (2 blocks, 1 chosen), 16 its unpacked int4 case (64 blocks,
    16 chosen). The JAX state, converted, equals the port's bytes: the
    eager JAX fill exactly, the jitted one within a step. Then two decode
    steps, JAX through its Pallas kernels in interpret mode."""
    jcfg = JModelConfig(name="t", vocab_size=64, hidden_size=128, intermediate_size=64,
                        num_hidden_layers=1, num_attention_heads=HKV * G,
                        num_key_value_heads=HKV, head_dim=D, dtype=jnp.float32)
    tcfg = ModelConfig(name="t", vocab_size=64, hidden_size=128, intermediate_size=64,
                       num_hidden_layers=1, num_attention_heads=HKV * G,
                       num_key_value_heads=HKV, head_dim=D, dtype=torch.float32)
    kw = dict(K=1, L=0, estimator="block_topk", offload_quant="int4",
              num_sink_tokens=4, num_local_tokens=16, generation_buffer=32,
              block_topk_block_size=block_size, block_topk_pipeline=pipeline,
              block_topk_budget_frac=0.5 if block_size == SPAN else 0.25,
              dense_layers=())
    jl, tl = JLSHConfig(use_pallas="on", **kw), LSHConfig(**kw)
    assert jl.packed_k4(D) == (block_size == SPAN) and tl.packed_k4(D)
    max_len = 4 + 16 + 2 * SPAN
    js = jstate.init_state(jcfg, jl, B, max_len)
    je = js
    ts = tstate.init_state(tcfg, tl, B, max_len, "cpu")
    assert ts.off_k[0].shape == (B, HKV, 2 * SPAN, D // 2)
    rng = np.random.default_rng(6)
    proj = jnp.zeros((D, 1))
    for req, p in enumerate((2 * SPAN + 20, 700)):
        k, v = _bf16_values(rng, (p, HKV, D)), _bf16_values(rng, (p, HKV, D))
        pad = np.zeros((max_len - p, HKV, D), np.float32)
        args = (jnp.int32(req), jnp.asarray(np.concatenate([k, pad])),
                jnp.asarray(np.concatenate([v, pad])), jnp.int32(p), proj, jl)
        js = _jfill_sparse(js, 0, *args)
        je = jserver.fill_sparse_layer(je, 0, *args)
        tserver.fill_sparse_layer(ts, 0, req, _t(k), _t(v), None, tl)
    packed = block_size == SPAN
    ek, eks = _from_jax_k(je.off_k[0], je.off_k_scale[0], D, packed)
    jk, jks = _from_jax_k(js.off_k[0], js.off_k_scale[0], D, packed)
    for req in range(B):
        n = int(ts.off_len[req])
        assert torch.equal(ts.off_k[0][req, :, :n], ek[req, :, :n])
        assert torch.equal(ts.off_k_scale[0][req, :, :n], eks[req, :, :n])
        step = (tpack4.unpack_k4(ts.off_k[0][req, :, :n]).int()
                - tpack4.unpack_k4(jk[req, :, :n]).int()).abs()
        assert int(step.max()) <= 1 and float(step.float().mean()) < 1e-2
        np.testing.assert_allclose(_np(ts.off_k_scale[0][req, :, :n]),
                                   _np(jks[req, :, :n]), rtol=2.5e-7, atol=0)
        np.testing.assert_array_equal(
            _np(ts.off_v[0][req, :, :n]),
            np.asarray(je.off_v[0]).reshape(B, HKV, -1, D)[req, :, :n])
    for _ in range(2):
        q = _bf16_values(rng, (B, HKV * G, D))
        kn, vn = _bf16_values(rng, (B, HKV, D)), _bf16_values(rng, (B, HKV, D))
        jo, je, jfrac = _jdecode_sparse(je, 0, jnp.asarray(q), jnp.asarray(kn),
                                        jnp.asarray(vn), proj, jl)
        to, tfrac = tserver.decode_sparse_layer(ts, 0, _t(q), _t(kn), _t(vn), None, tl)
        ts.hot_len += 1
        je = je.replace(hot_len=je.hot_len + 1)
        np.testing.assert_allclose(_np(to), np.asarray(jo), atol=INT8_V_TOL,
                                   rtol=INT8_V_TOL)
        assert float(tfrac) == pytest.approx(float(jfrac), abs=1e-7)
        assert 0 < float(tfrac) < 1


def test_lsh_int4_fill_describes_the_4bit_keys():
    """lsh with int4 offload: the stored K is the second 4-bit pass over the
    dequantized centered keys (the eager JAX quantizer's bytes), V int8;
    the norms and signatures are those of the dequantized 4-bit keys."""
    lsh = LSHConfig(K=6, L=20, num_sink_tokens=4, num_local_tokens=16,
                    generation_buffer=32, offload_quant="int4")
    cfg = dataclasses.replace(preset("llama-tiny"), dtype=torch.float32)
    ts = tstate.init_state(cfg, lsh, 1, 512, "cpu")
    rng = np.random.default_rng(7)
    proj = rng.standard_normal((16, 6 * 20)).astype(np.float32)
    k, v = _bf16_values(rng, (300, 2, 16)), _bf16_values(rng, (300, 2, 16))
    tserver.fill_sparse_layer(ts, 0, 0, _t(k), _t(v), _t(proj), lsh)
    n = int(ts.off_len[0])
    centered = (k[4:4 + n] - _np(ts.avg_k[0])[0][None]).transpose(1, 0, 2)
    deq = jquant.dequantize_rows(*jquant.quantize_rows(jnp.asarray(centered), 4),
                                 jnp.float32)
    wq, wsc = jquant.quantize_rows(deq, 4)
    np.testing.assert_array_equal(ts.off_k[0][0, :, :n].numpy(), np.asarray(wq))
    np.testing.assert_array_equal(ts.off_k_scale[0][0, :, :n].numpy(), np.asarray(wsc))
    vq, _ = jquant.quantize_rows(jnp.asarray(v[4:4 + n].transpose(1, 0, 2)))
    np.testing.assert_array_equal(ts.off_v[0][0, :, :n].numpy(), np.asarray(vq))
    np.testing.assert_allclose(ts.k_norm[0][0, :, :n].numpy(),
                               np.linalg.norm(np.asarray(deq), axis=-1), rtol=1e-6, atol=0)
    w = -(-n // 32)
    keys = np.concatenate([np.asarray(deq), np.zeros((2, 32 * w - n, 16), np.float32)], 1)
    want = tbits.build_planes(_t(keys).transpose(0, 1), _t(proj), 6)
    assert torch.equal(ts.planes[0][0, ..., :w], want)


# -- the engines -----------------------------------------------------------------

MAX_LEN = 512
ENGINE_KW = dict(num_sink_tokens=4, num_local_tokens=16, generation_buffer=32)
JCFG = dataclasses.replace(jpreset("llama-tiny"), dtype=jnp.float32)
TCFG = dataclasses.replace(preset("llama-tiny"), dtype=torch.float32)


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(JCFG, jax.random.key(0), MAX_LEN)
    tree = dataclasses.asdict(jax.tree_util.tree_map(np.asarray, jp))
    return jp, params_from_numpy(tree, device="cpu")


def _estimator_kw(estimator):
    """tests/test_engine.py:265-268: block_topk at 16-token blocks and full
    budget (every block attended), lsh at K=1, L=32."""
    if estimator == "block_topk":
        return dict(K=10, L=0, estimator="block_topk", block_topk_block_size=16,
                    block_topk_budget_frac=1.0)
    return dict(K=1, L=32)


def _logits(eng, prompt, steps, tensor):
    out = [_np(eng.prefill(prompt))]
    tok = int(out[0][0].argmax())
    for _ in range(steps):
        out.append(_np(eng.inference(tensor([tok]))))
        tok = int(out[-1][0].argmax())
    return out


@pytest.mark.parametrize("estimator", ["block_topk", "lsh"])
def test_int4_offload_tracks_bf16_offload(weights, estimator):
    """tests/test_engine.py:261-285 on the port: the same engine with bf16
    and with int4 offload, the same greedy inputs."""
    _, tp = weights
    kw = dict(ENGINE_KW, **_estimator_kw(estimator))
    exact = LLM(TCFG, max_length=MAX_LEN, params=tp, lsh=LSHConfig(**kw), device="cpu")
    quant = LLM(TCFG, max_length=MAX_LEN, params=tp, device="cpu",
                lsh=LSHConfig(offload_quant="int4", **kw),
                projections=exact.projections)
    assert quant.state.off_k[0].shape[-1] == (8 if estimator == "block_topk" else 16)
    prompt = np.random.default_rng(9).integers(1, TCFG.vocab_size, 120)
    le = [_np(exact.prefill(prompt))]
    lq = [_np(quant.prefill(prompt))]
    np.testing.assert_allclose(lq[0], le[0], rtol=PREFILL_TOL, atol=PREFILL_TOL)
    tok = int(le[0][0].argmax())
    for _ in range(3):
        a = _np(exact.inference(torch.tensor([tok])))
        b = _np(quant.inference(torch.tensor([tok])))
        assert np.abs(b - a).max() / np.abs(a).max() < INT4_DRIFT
        tok = int(a[0].argmax())


@pytest.mark.parametrize("estimator", ["block_topk", "lsh"])
def test_int4_engine_matches_jax(weights, estimator):
    """The port's engine against the JAX engine with int4 offload: block_topk
    at full budget (16-token blocks), lsh at K=1, L=32 (nearly every key
    sampled), both through JAX's default (XLA) path. The dense layers stay
    exact: with dense int8 too the logits part by up to 5.9e-3 of the
    largest, with int8 offload as with int4, through the jitted JAX
    quantizer's one-ulp scales (ROADMAP C) in the dense layers."""
    jp, tp = weights
    kw = dict(ENGINE_KW, offload_quant="int4", **_estimator_kw(estimator))
    jl = JLLM(JCFG, max_length=MAX_LEN, chunk_size=64, params=jp, lsh=JLSHConfig(**kw))
    tl = LLM(TCFG, max_length=MAX_LEN, params=tp, lsh=LSHConfig(**kw), device="cpu")
    if estimator == "lsh":
        bank = np.random.default_rng(42).standard_normal((16, 32)).astype(np.float32)
        jl.projections = jnp.asarray(bank)
        tl.projections = _t(bank)
    prompt = np.random.default_rng(0).integers(1, TCFG.vocab_size, 300).astype(np.int32)
    jlog = _logits(jl, prompt, 5, np.asarray)
    tlog = _logits(tl, prompt, 5, torch.tensor)
    np.testing.assert_allclose(tlog[0], jlog[0], atol=PREFILL_TOL, rtol=PREFILL_TOL)
    for a, b in zip(tlog[1:], jlog[1:]):
        assert np.abs(a - b).max() / np.abs(b).max() < INT4_DECODE_TOL
    assert [int(x[0].argmax()) for x in tlog] == [int(x[0].argmax()) for x in jlog]
    assert tl.avg_sparsity == pytest.approx(jl.avg_sparsity, abs=2e-3)

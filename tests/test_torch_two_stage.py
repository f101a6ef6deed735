"""The two-stage LSH decode of the port against the JAX package on the CPU:
the standalone collision scan, the masked attend from precomputed words,
the sampled mode's id compaction and gathered decode, the sparse layer in
both routes, the engine, and the scorer's `exact_scores`.

The JAX Pallas kernels run in interpret mode, as the JAX package's own
tests run them on the CPU. Tolerances:
  * collision words bit for bit (both Pallas scans, even and odd L), as
    tests/test_bitcodes.py holds the JAX scans; sampled counts, budget ids
    and their validity exactly;
  * the plain masked attend against `lsh_masked_attention` 3e-3, as
    tests/test_torch_kernels.py holds the fused form: the Pallas kernel
    evaluates arccos with a 2e-4 rad polynomial and the collision weight
    as 1 - x with x near 1, the port with libm arccos and without that
    cancellation;
  * `lsh_sampled_decode` 2e-3 on keys planted near the queries (large
    collision weights), and 2e-2 (`JAX_DEBIAS_TOL`) where random keys
    sampled by chance carry the small weights at which the JAX float32
    weight cancels (tests/test_torch_engine.py);
  * the sparse layer 2e-2 and its sampled fraction 2e-3, as
    tests/test_torch_debias.py holds the layer (a SimHash sign at |proj|
    ~ 0 and the float32 rounding of dequantized keys move a few samples);
  * the engine's greedy tokens exactly and its avg sparsity to 2e-3, as
    tests/test_torch_engine.py;
  * `exact_scores` 2e-2, as tests/test_pallas_kernels.py:165 holds the
    Pallas scorer.
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
from magicpig_tpu.ops import attention as jatt
from magicpig_tpu.ops import bitcodes as jbits
from magicpig_tpu.ops.pallas.collide import collision_words_pallas as j_collide
from magicpig_tpu.ops.pallas.lsh_decode import lsh_masked_attention as j_masked
from magicpig_tpu.ops.pallas.mask import collision_words_pallas as j_mask_scan
from magicpig_tpu.ops.pallas.score import exact_scores as j_exact_scores
from magicpig_tpu.runtime import server as jserver
from magicpig_tpu.runtime import state as jstate
from magicpig_tpu.runtime.engine import LLM as JLLM
from magicpig_tpu_torch.config import LSHConfig, preset
from magicpig_tpu_torch.models.convert import params_from_numpy
from magicpig_tpu_torch.ops import attention as tatt
from magicpig_tpu_torch.ops import bitcodes as tbits
from magicpig_tpu_torch.ops.kernels import (
    LAUNCHES,
    collision_words,
    exact_scores,
    lsh_decode,
    lsh_masked_attention,
)
from magicpig_tpu_torch.ops.kernels.block_score import exact_scores_plain
from magicpig_tpu_torch.ops.kernels.lsh_fused import lsh_fused_decode_plain
from magicpig_tpu_torch.ops.quant import dequantize_rows, quantize_rows
from magicpig_tpu_torch.runtime import server as tserver
from magicpig_tpu_torch.runtime import state as tstate
from magicpig_tpu_torch.runtime.engine import LLM

KERNEL_TOL = 3e-3
# The P.V operand's rounding, p (times the V scale) in bf16: the Pallas
# kernel rounds each 128-token block's p against its running max, the
# plain version against the head's, so each term may round an ulp apart
# (2^-9 of it each way). The new forms' masked cases add this bound, 2^-8
# of sum(p |v|) / sum(p), to KERNEL_TOL: at group sizes 6, 7 and 16 over
# int8 K/V one to three output values of 1536-8192, near 0, came to
# 0.0051-0.0054 from the Pallas kernel's (KERNEL_TOL allows 0.003 there).
ROUNDING_ULPS = 2.0 ** -8
SAMPLED_TOL = 2e-3
JAX_DEBIAS_TOL = 2e-2
SCORE_TOL = 2e-2
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


# -- the collision scan (B5, B6) ------------------------------------------------


SCAN_CASES = [
    (2, 2, 4, 20, 6, 16),      # even L
    (1, 2, 4, 21, 6, 16),      # odd L
    (1, 2, 4, 75, 8, 32),      # the odd-L serve's K and L
    (1, 1, 8, 1, 3, 8),        # one table: nothing collides twice
    (1, 2, 3, 21, 6, 16),      # group size 3 (Llama-3.2-3B), odd L
    (1, 2, 6, 21, 6, 16),      # the general tile: group size 6, odd L
    (1, 1, 16, 20, 6, 16),     # and 16 (Llama-3.1-405B), two blocks a kv head
]


@functools.lru_cache(maxsize=None)
def _scan_case(B, HKV, G, L, K, W):
    """Random q bits and planes (any bit pattern), and the words of both
    Pallas scans in interpret mode, computed once per shape."""
    rng = np.random.default_rng(L)
    q_bits = rng.integers(0, 2, (B, HKV * G, L, K)).astype(np.int32)
    planes = rng.integers(-2**31, 2**31 - 1, (B, HKV, L, K, W)).astype(np.int32)
    jq, jp = jnp.asarray(q_bits), jnp.asarray(planes)
    return (q_bits, planes,
            np.asarray(j_collide(jq, jp, word_block=8, interpret=True)),
            np.asarray(j_mask_scan(jq, jp, K, L, block_words=8, interpret=True)))


def _scan_lengths(length, B, W):
    """Per-request lengths for a case: `length` ("mid" 16W + 5, "full" the
    capacity 32W) for request 0, the rest of the capacity for request 1."""
    n = {"mid": 16 * W + 5, "full": 32 * W}.get(length, length)
    return np.array([n, 32 * W - n][:B], dtype=np.int32)


@pytest.mark.parametrize("length", [None, 0, 1, 31, 32, 33, "mid", "full"])
@pytest.mark.parametrize("B,HKV,G,L,K,W", SCAN_CASES)
def test_collision_words_match_both_pallas_scans(B, HKV, G, L, K, W, length):
    """The plain scan against both Pallas scans bit for bit; with a length,
    against their words ANDed with JAX's `valid_words`, as the JAX callers
    apply it right after the scan."""
    q_bits, planes, j_words, j_words2 = _scan_case(B, HKV, G, L, K, W)
    lens = None if length is None else _scan_lengths(length, B, W)
    before = dict(LAUNCHES)
    got = _np(collision_words(_t(q_bits), _t(planes),
                              None if lens is None else _t(lens)))
    assert LAUNCHES == before                  # the CPU takes the plain version
    if lens is not None:
        valid = np.asarray(jbits.valid_words(jnp.asarray(lens), W))[:, None]
        j_words, j_words2 = j_words & valid, j_words2 & valid
    np.testing.assert_array_equal(got, j_words)
    np.testing.assert_array_equal(got, j_words2)
    if L > 1 and length not in (0, 1):
        assert got.any()
    if L == 1:
        assert not got.any()


@pytest.mark.parametrize("length", [0, 33, "mid"])
@pytest.mark.parametrize("B,HKV,G,L,K,W", SCAN_CASES[:3])
def test_collision_words_ignore_planes_past_the_length(B, HKV, G, L, K, W,
                                                       length):
    """Plane bits at or past each length (whole words and the tail of the
    word that holds it) poisoned with the first query head of each group's
    own bits, which would make that head collide with every key if read:
    the words with the length do not change (both Pallas scans on the clean
    planes, ANDed with JAX's `valid_words`)."""
    q_bits, planes, j_words, _ = _scan_case(B, HKV, G, L, K, W)
    lens = _scan_lengths(length, B, W)
    keep = _np(tbits.valid_words(_t(lens), W))[:, None, None, None]
    poisoned = (planes & keep) | (-q_bits[:, ::G, :, :, None] & ~keep)
    seen = _np(collision_words(_t(q_bits), _t(poisoned)))
    past = lens <= 32 * (W - 1)                # the last word is poisoned
    assert past.any() and (seen[past][:, ::G, -1] == -1).all()
    got = _np(collision_words(_t(q_bits), _t(poisoned), _t(lens)))
    valid = np.asarray(jbits.valid_words(jnp.asarray(lens), W))[:, None]
    np.testing.assert_array_equal(got, j_words & valid)


# -- the masked attend from words (B4) --------------------------------------------


def _lsh_inputs(seed, B, HKV, G, S, D, K, L, quant):
    """Keys planted near each group's first query (a non-empty sample);
    norms and signatures of the keys as stored (dequantized for int8);
    the collision words of the valid tokens."""
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
    planes = torch.stack([tbits.build_planes(_t(x).transpose(0, 1), _t(proj), K)
                          for x in kd])
    qb = tbits.hash_bits(_t(q), _t(proj), K)
    words = (tbits.collision_words(qb, planes)
             & tbits.valid_words(_t(length), S // 32)[:, None])
    return dict(q=q, k=k, v=v, ks=ks, vs=vs, kd=kd,
                knorm=np.linalg.norm(kd, axis=-1), length=length,
                planes=planes, qb=qb, words=words)


@pytest.mark.parametrize("quant,debias,D,G", [
    *(pytest.param(quant, debias, d, g, id=f"{quant}-{debias}" + (
        "" if d == 64 else f"-d{d}-g{g}"))
      for d, g in ((64, 4), (128, 3))      # 128, 3: Llama-3.2-3B's heads
      for quant in (False, True) for debias in ("exact", "poly", "none")),
    # The general tile's group sizes and the small head dims, exact debias.
    *(pytest.param(quant, "exact", d, g, id=f"{quant}-exact-d{d}-g{g}")
      for d, g in ((64, 3), (128, 5), (64, 6), (128, 7), (128, 16), (16, 4),
                   (32, 6))
      for quant in (False, True))])
def test_lsh_masked_attention_plain_matches_pallas(quant, debias, D, G):
    B, HKV, K, L = 2, 2, 6, 21
    S = 512 if D == 16 else 256      # JAX's d = 16 layout folds 8 tokens a row
    x = _lsh_inputs(3, B, HKV, G, S, D, K, L, quant)
    mask = tbits.unpack_words(x["words"], S)
    as_j = (lambda t: jnp.asarray(_np(t)) if quant
            else jnp.asarray(t.float().numpy(), jnp.bfloat16))
    jo, jl, jc = j_masked(
        jnp.asarray(x["q"]), as_j(x["k"]), as_j(x["v"]),
        jnp.asarray(x["knorm"]), jnp.asarray(_np(mask).astype(np.int8)), K, L,
        block_tokens=max(128, 32 * max(128 // D, 1)), interpret=True,
        k_scale=jnp.asarray(_fold_major(x["ks"], D)) if quant else None,
        v_scale=jnp.asarray(_fold_major(x["vs"], D)) if quant else None,
        debias=debias)
    to, tl, tc = lsh_masked_attention(
        _t(x["q"]), x["k"], x["v"], _t(x["knorm"]), x["words"],
        _t(x["length"]), K, L, x["ks"], x["vs"], debias)
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    assert _np(tc).reshape(B, HKV, G)[:, :, 0].min() > 0     # the planted heads
    if (D, G) in ((64, 4), (128, 3)):
        np.testing.assert_allclose(_np(to), np.asarray(jo), atol=KERNEL_TOL,
                                   rtol=KERNEL_TOL)
    else:
        mag = lsh_masked_attention(
            _t(x["q"]), x["k"], x["v"].abs(), _t(x["knorm"]), x["words"],
            _t(x["length"]), K, L, x["ks"], x["vs"], debias)[0]
        bound = (KERNEL_TOL * (1 + np.abs(np.asarray(jo)))
                 + ROUNDING_ULPS * _np(mag))
        assert (np.abs(_np(to) - np.asarray(jo)) <= bound).all()
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=KERNEL_TOL,
                               rtol=KERNEL_TOL)


@pytest.mark.parametrize("L", [21, 20, 1])
def test_lsh_decode_routes_equal_the_fused_plain_version(L):
    """Both routes of the dispatcher compute the fused kernel's function:
    odd L (and L = 1) through the words, even L through the fused form;
    words past the length are ignored by the masked attend."""
    B, HKV, G, S, D, K = 2, 2, 4, 256, 64, 6
    x = _lsh_inputs(5, B, HKV, G, S, D, K, L, quant=False)
    args = (_t(x["q"]), x["k"], x["v"], _t(x["knorm"]), x["planes"], x["qb"],
            _t(x["length"]), K, L)
    got = lsh_decode(*args)
    want = lsh_fused_decode_plain(*args)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    all_words = tbits.collision_words(x["qb"], x["planes"])  # not length-masked
    masked = lsh_masked_attention(*args[:4], all_words, *args[6:])
    for a, b in zip(masked, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


# -- the sampled mode: budget, ids, gathered decode --------------------------------


@pytest.mark.parametrize("n", [0, 100, 492, 512, 2048, 16316, 16384, 98304])
@pytest.mark.parametrize("frac,floor", [(0.06, 128), (0.02, 64)])
def test_sample_budget_matches_jax(n, frac, floor):
    kw = dict(sample_budget_frac=frac, min_sample_budget=floor)
    got = LSHConfig(decode_mode="sampled", **kw).sample_budget(n)
    assert got == JLSHConfig(decode_mode="sampled", **kw).sample_budget(n)
    assert got == min(n, -(-max(floor, -(-n * frac // 1)) // 128) * 128)


@pytest.mark.parametrize("density,budget", [
    (0.05, 128),    # fewer set bits than the budget: clear ids fill it
    (0.6, 128),     # truncated: the highest set ids dropped
    (0.0, 64),      # nothing set
    (1.0, 256),     # everything set, the budget is S
])
def test_mask_to_budget_ids_equal_jax(density, budget):
    rng = np.random.default_rng(int(density * 100) + budget)
    mask = rng.random((2, 8, 256)) < density
    ids, valid = tatt.mask_to_budget_ids(_t(mask), budget)
    jids, jvalid = jatt.mask_to_budget_ids(jnp.asarray(mask), budget)
    assert ids.dtype == torch.int32 and valid.dtype == torch.bool
    np.testing.assert_array_equal(_np(ids), np.asarray(jids))
    np.testing.assert_array_equal(_np(valid), np.asarray(jvalid))
    nnz = mask.sum(-1)
    np.testing.assert_array_equal(_np(valid).sum(-1), np.minimum(nnz, budget))


@pytest.mark.parametrize("quant", [False, True])
def test_lsh_sampled_decode_matches_jax(quant):
    """Planted keys, budget 64 (every sampled key fits): the port against
    JAX's `lsh_sampled_decode` over the dequantized cache, and against the
    port's own masked decode."""
    B, HKV, G, S, D, K, L = 2, 2, 4, 256, 64, 6, 20
    x = _lsh_inputs(7, B, HKV, G, S, D, K, L, quant)
    mask = tbits.unpack_words(x["words"], S)
    assert int(mask.sum(-1).max()) <= 64
    ids, valid = tatt.mask_to_budget_ids(mask, 64)
    kd, vd = x["kd"], x["v"].float().numpy()
    if quant:   # JAX gathers from its cache dequantized to bf16
        kd = _np(dequantize_rows(x["k"], x["ks"]).float())
        vd = _np(dequantize_rows(x["v"], x["vs"]).float())
    jo, jl = jatt.lsh_sampled_decode(
        jnp.asarray(x["q"]), jnp.asarray(kd, jnp.bfloat16),
        jnp.asarray(vd, jnp.bfloat16), jnp.asarray(x["knorm"]),
        jnp.asarray(_np(ids)), jnp.asarray(_np(valid)), K, L)
    to, tl = tatt.lsh_sampled_decode(
        _t(x["q"]), x["k"], x["v"], _t(x["knorm"]), ids, valid, K, L,
        x["ks"], x["vs"])
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=SAMPLED_TOL,
                               rtol=SAMPLED_TOL)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=SAMPLED_TOL,
                               rtol=SAMPLED_TOL)
    if not quant:   # gathered == masked where the budget covers the sample
        mo, ml = tatt.lsh_masked_decode(
            _t(x["q"]), x["k"], x["v"], _t(x["knorm"]), mask, _t(x["length"]),
            K, L)
        torch.testing.assert_close(to, mo, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(tl, ml, atol=1e-5, rtol=1e-5)


# -- one sparse layer against the JAX server ------------------------------------------

_jfill_sparse = jax.jit(jserver.fill_sparse_layer, static_argnums=(1, 7))
_jdecode_sparse = jax.jit(jserver.decode_sparse_layer, static_argnums=(1, 6))


@pytest.mark.parametrize("kw", [
    dict(K=10, L=150, decode_mode="sampled"),
    dict(K=10, L=150, decode_mode="sampled", offload_quant="int8"),
    dict(K=1, L=32, decode_mode="sampled"),          # the budget truncates
    dict(K=6, L=21, use_pallas="on"),                # odd L: two stages
    dict(K=6, L=21, use_pallas="on", offload_quant="int8",
         lsh_debias="poly"),
], ids=["sampled", "sampled-int8", "sampled-truncated", "odd-L",
        "odd-L-int8-poly"])
def test_sparse_layer_matches_jax(kw):
    """llama-tiny widths (d 16); two requests of 300 and 120 tokens, fill
    and two decode steps. JAX's sampled mode runs in XLA; its masked mode
    with use_pallas="on" runs its two-stage Pallas route for odd L (the
    collision scan, then `lsh_masked_attention` in interpret mode). Both
    packages give these requests an offload capacity of 512, so the
    sampled budgets (128) agree."""
    kw = dict(kw, num_sink_tokens=4, num_local_tokens=16, generation_buffer=32)
    jl = JLSHConfig(**kw)
    tl = LSHConfig(**{k: v for k, v in kw.items() if k != "use_pallas"})
    js = jstate.init_state(JCFG, jl, 2, MAX_LEN)
    ts = tstate.init_state(TCFG, tl, 2, MAX_LEN, "cpu")
    assert ts.off_k[1].shape[2] == 512
    rng = np.random.default_rng(31)
    bank = rng.standard_normal((TCFG.head_dim, tl.K * tl.L)).astype(np.float32)
    for req, p in enumerate((300, 120)):
        k, v = _bf16_values(rng, (p, 2, 16)), _bf16_values(rng, (p, 2, 16))
        pad = np.zeros((320 - p, 2, 16), np.float32)
        js = _jfill_sparse(js, 1, jnp.int32(req),
                           jnp.asarray(np.concatenate([k, pad])),
                           jnp.asarray(np.concatenate([v, pad])),
                           jnp.int32(p), jnp.asarray(bank), jl)
        tserver.fill_sparse_layer(ts, 1, req, _t(k), _t(v), _t(bank), tl)
    for _ in range(2):
        q = _bf16_values(rng, (2, 8, 16))
        kn, vn = _bf16_values(rng, (2, 2, 16)), _bf16_values(rng, (2, 2, 16))
        jo, js, jfrac = _jdecode_sparse(js, 1, jnp.asarray(q), jnp.asarray(kn),
                                        jnp.asarray(vn), jnp.asarray(bank), jl)
        to, tfrac = tserver.decode_sparse_layer(ts, 1, _t(q), _t(kn), _t(vn),
                                                _t(bank), tl)
        ts.hot_len += 1
        js = js.replace(hot_len=js.hot_len + 1)
        assert 0 < float(tfrac) <= 1
        assert float(tfrac) == pytest.approx(float(jfrac), abs=2e-3)
        np.testing.assert_allclose(_np(to), np.asarray(jo), atol=JAX_DEBIAS_TOL,
                                   rtol=JAX_DEBIAS_TOL)
    if tl.K == 1:
        # Nearly every key sampled: over 0.9 of the 280 + 100 offloaded
        # tokens, so request 0's heads sample more than the 128-id budget.
        assert float(tfrac) > 0.9


# -- the engine ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(JCFG, jax.random.key(0), MAX_LEN)
    tree = dataclasses.asdict(jax.tree_util.tree_map(np.asarray, jp))
    return jp, params_from_numpy(tree, device="cpu")


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(1, TCFG.vocab_size, n).astype(np.int32)


ENGINE_MODES = {
    "sampled": dict(K=10, L=150, decode_mode="sampled"),
    "odd-L": dict(K=8, L=75),
}


@pytest.fixture(scope="module", params=sorted(ENGINE_MODES))
def engine_runs(request, weights):
    """Prefill + 6 greedy steps in both engines (JAX's default route on the
    CPU: XLA, the collision scan and the masked or sampled decode)."""
    kw = dict(ENGINE_MODES[request.param], num_sink_tokens=4,
              num_local_tokens=16, generation_buffer=32)
    jp, tp = weights
    bank = np.random.default_rng(42).standard_normal(
        (TCFG.head_dim, kw["K"] * kw["L"])).astype(np.float32)
    jl = JLLM(JCFG, max_length=MAX_LEN, chunk_size=64, params=jp,
              lsh=JLSHConfig(**kw))
    jl.projections = jnp.asarray(bank)
    tl = LLM(TCFG, max_length=MAX_LEN, params=tp, lsh=LSHConfig(**kw),
             projections=_t(bank), device="cpu")
    prompt = _prompt(0, 300)
    jt = [int(np.asarray(jl.prefill(prompt))[0].argmax())]
    tt = [int(_np(tl.prefill(prompt))[0].argmax())]
    for _ in range(6):
        jt.append(int(np.asarray(jl.inference(np.asarray([jt[-1]])))[0].argmax()))
        tt.append(int(_np(tl.inference(torch.tensor([tt[-1]])))[0].argmax()))
    return dict(j_tokens=jt, t_tokens=tt, j_sparsity=jl.avg_sparsity,
                t_sparsity=tl.avg_sparsity)


def test_engine_greedy_tokens_match_jax(engine_runs):
    assert engine_runs["t_tokens"] == engine_runs["j_tokens"]


def test_engine_avg_sparsity_matches_jax(engine_runs):
    assert 0 < engine_runs["t_sparsity"] < 1
    assert engine_runs["t_sparsity"] == pytest.approx(
        engine_runs["j_sparsity"], abs=2e-3)


@pytest.mark.parametrize("kw", [
    dict(decode_mode="sampled"),
    dict(decode_mode="sampled", offload_quant="int8"),
    dict(decode_mode="sampled", offload_quant="int4"),
    dict(K=8, L=75),
    dict(K=8, L=75, offload_quant="int4", lsh_debias="none"),
], ids=["sampled", "sampled-int8", "sampled-int4", "odd-L", "odd-L-int4-none"])
def test_llm_runs_the_new_modes_on_the_cpu(kw):
    """bf16 llama-tiny: generate() and decode_steps() run, the sparsity
    counters take the sampled fraction, and no kernel is launched."""
    before = dict(LAUNCHES)
    llm = LLM("llama-tiny", max_length=MAX_LEN, device="cpu", seed=0,
              lsh=LSHConfig(num_local_tokens=16, generation_buffer=32, **kw))
    toks = llm.generate(_prompt(1, 300), max_tokens=3)
    assert len(toks) == 3 and 0 < llm.avg_sparsity < 1
    first = int(_np(llm.prefill(_prompt(2, 200)))[0].argmax())
    out = llm.decode_steps([first], 2)
    assert out.shape[0] == 2 and LAUNCHES == before


# -- the scorer's exact_scores (B7's last entries) --------------------------------------


@pytest.mark.parametrize("quant", [False, True])
def test_exact_scores_plain_matches_pallas(quant):
    B, HKV, G, S, D = 2, 2, 4, 512, 64
    rng = np.random.default_rng(17)
    q = torch.from_numpy(rng.standard_normal((B, HKV * G, D)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, HKV, S, D)).astype(np.float32))
    q, k = q.to(torch.bfloat16), k.to(torch.bfloat16)
    if quant:
        kq, ks = quantize_rows(k)
        jgot = j_exact_scores(jnp.asarray(q.float().numpy(), jnp.bfloat16),
                              jnp.asarray(_np(kq)),
                              jnp.asarray(_fold_major(ks, D)),
                              block_tokens=256, interpret=True)
        got = exact_scores(q, kq, ks)
    else:
        jgot = j_exact_scores(jnp.asarray(q.float().numpy(), jnp.bfloat16),
                              jnp.asarray(k.float().numpy(), jnp.bfloat16),
                              None, block_tokens=256, interpret=True)
        got = exact_scores(q, k, None)
    assert got.shape == (B, HKV, G, S) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(jgot), atol=SCORE_TOL,
                               rtol=SCORE_TOL)
    assert torch.isfinite(got).all()     # unmasked: every token scored
    torch.testing.assert_close(got, exact_scores_plain(q, *((kq, ks) if quant
                                                            else (k, None))),
                               atol=0, rtol=0)


# -- wrappers refuse devices other than the CPU and the card -----------------------------


@pytest.mark.parametrize("which", ["collision_words", "lsh_masked_attention",
                                   "lsh_masked_attention_int8",
                                   "exact_scores"])
def test_new_wrappers_raise_for_other_devices(which):
    m = torch.device("meta")
    i32 = dict(dtype=torch.int32, device=m)
    q = torch.empty((1, 4, 64), dtype=torch.bfloat16, device=m)
    k = torch.empty((1, 2, 64, 64), dtype=torch.bfloat16, device=m)
    k8 = torch.empty((1, 2, 64, 64), dtype=torch.int8, device=m)
    sc = torch.empty((1, 2, 64), device=m)
    length = torch.empty((1,), **i32)
    words = torch.empty((1, 4, 2), **i32)
    with pytest.raises(ValueError):
        if which == "collision_words":
            collision_words(torch.empty((1, 4, 3, 2), **i32),
                            torch.empty((1, 2, 3, 2, 2), **i32))
        elif which == "lsh_masked_attention":
            lsh_masked_attention(q, k, k, sc, words, length, 2, 3)
        elif which == "lsh_masked_attention_int8":
            lsh_masked_attention(q, k8, k8, sc, words, length, 2, 3, sc, sc)
        else:
            exact_scores(q, k, None)

"""The plain versions of the port's three kernels against the JAX package's
Pallas kernels (interpret mode, as the JAX tests run them on the CPU). The
CUDA kernels themselves are held against these plain versions in
tests/test_torch_kernels_cuda.py (card only).

Tolerances: float32 inputs, 1e-4 for prefill and dense decode (the same
online-softmax math in another order). The LSH partial 3e-3, as in the JAX
package's own fused-kernel tests: the Pallas kernel evaluates arccos with a
2e-4 rad polynomial and the collision weight as 1 - x with x near 1, the
port with libm arccos and without that cancellation. Sampled counts exactly:
both sides scan the same signatures of the same keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicpig_tpu.ops import attention as jatt
from magicpig_tpu.ops import bitcodes as jbits
from magicpig_tpu.ops.pallas.decode import flash_decode as j_flash_decode
from magicpig_tpu.ops.pallas.lsh_decode import lsh_fused_decode as j_lsh_fused_decode
from magicpig_tpu.ops.pallas.prefill import flash_prefill_pallas
from magicpig_tpu_torch.ops import attention as tatt
from magicpig_tpu_torch.ops import bitcodes as tbits
from magicpig_tpu_torch.ops.kernels import (
    LAUNCHES,
    _lib,
    block_attend,
    block_rank,
    exact_scores_ranked,
    flash_decode,
    flash_prefill,
    lsh_fused_decode,
    rescore_attend,
    w4_matmul,
)
from magicpig_tpu_torch.ops.kernels.block_attend import (
    chunk_plan,
    launch_block_attend,
)
from magicpig_tpu_torch.ops.kernels.flash_decode import split_tokens
from magicpig_tpu_torch.ops.kernels.lsh_fused import lsh_fused_decode_plain
from magicpig_tpu_torch.ops.kernels.rescore_attend import launch_rescore_attend
from magicpig_tpu_torch.ops.kernels.w4_matmul import split_groups, w4_plan

F32 = 1e-4
LSH_TOL = 3e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- flash prefill ---------------------------------------------------------------


@pytest.mark.parametrize("B,HKV,G,SQ,SKV,D,lengths,offsets,window", [
    (1, 2, 4, 256, 256, 64, [256], [0], None),
    (2, 2, 2, 256, 256, 16, [256, 100], [0, 0], None),   # ragged length
    (1, 2, 4, 256, 256, 64, [200], [0], 64),             # sliding window
    (1, 2, 4, 128, 384, 64, [256], [128], None),         # query offset
    (1, 2, 1, 256, 256, 32, [256], [0], None),           # GQA group of 1
    (2, 2, 4, 256, 256, 128, [256, 150], [0, 0], None),  # d = 128 (8B)
    (1, 2, 6, 128, 384, 32, [300], [128], 100),          # d = 32, G = 6
    (1, 1, 16, 128, 256, 16, [200], [0], None),          # d = 16, G = 16
])
def test_flash_prefill_plain_matches_pallas(B, HKV, G, SQ, SKV, D, lengths,
                                            offsets, window):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, SQ, HKV * G, D)).astype(np.float32)
    k = rng.standard_normal((B, SKV, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, SKV, HKV, D)).astype(np.float32)
    length = np.asarray(lengths, np.int32)
    offset = np.asarray(offsets, np.int32)
    jo, jl = flash_prefill_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(length),
        q_offset=jnp.asarray(offset), q_tile=128, chunk_tokens=128,
        window=window, interpret=True, return_lse=True)
    to, tl = flash_prefill(_t(q), _t(k), _t(v), _t(length), _t(offset),
                           window=window, return_lse=True)
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=F32, rtol=F32)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=F32, rtol=F32)


# -- flash decode ----------------------------------------------------------------


@pytest.mark.parametrize("B,HKV,G,S,D", [
    (3, 2, 4, 256, 64),
    (2, 2, 2, 256, 128),
    (2, 2, 4, 512, 16),
    # The kernels' general tile (every group size but 1, 2, 4, 8, and 3 at
    # d = 128) and the small head dims, as the card runs them.
    (2, 2, 3, 256, 64),
    (2, 2, 5, 256, 128),
    (2, 2, 6, 256, 64),
    (2, 1, 7, 256, 128),
    (2, 1, 16, 256, 128),
    (2, 2, 4, 256, 32),
    (2, 2, 6, 256, 16),
])
def test_flash_decode_plain_matches_pallas(B, HKV, G, S, D):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, HKV * G, D)).astype(np.float32)
    k = rng.standard_normal((B, HKV, S, D)).astype(np.float32)
    v = rng.standard_normal((B, HKV, S, D)).astype(np.float32)
    length = np.asarray(([S, 37, 0] * B)[:B], np.int32)   # last row: empty
    jo, jl = j_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(length), block_tokens=128,
                            interpret=True)
    to, tl = flash_decode(_t(q), _t(k), _t(v), _t(length))
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=F32, rtol=F32)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=F32, rtol=F32)
    if B == 3:   # a request with no valid token: out 0, lse -inf
        assert (_np(to)[2] == 0).all() and np.isneginf(_np(tl)[2]).all()


# -- fused LSH decode --------------------------------------------------------------


def _lsh_inputs(seed, B, HKV, G, S, D, K, L):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, HKV * G, D)).astype(np.float32)
    kc = rng.standard_normal((B, HKV, S, D)).astype(np.float32)
    # Plant keys near each query so that the sample is not empty.
    kc[:, :, 5:40] = (q.reshape(B, HKV, G, D)[:, :, :1]
                      + 0.3 * kc[:, :, 5:40])
    v = rng.standard_normal((B, HKV, S, D)).astype(np.float32)
    proj = rng.standard_normal((D, K * L)).astype(np.float32)
    length = np.asarray(([S, S // 2 + 17] * B)[:B], np.int32)
    return q, kc, v, proj, length


def _port_planes(kc, proj, K):
    return torch.stack([tbits.build_planes(_t(kc[b]).transpose(0, 1),
                                           _t(proj), K)
                        for b in range(kc.shape[0])])


@pytest.mark.parametrize("B,HKV,G,S,D,K,L", [
    (2, 2, 4, 256, 64, 6, 20),      # even L: the one-kernel Pallas form
    (1, 2, 2, 512, 16, 10, 30),
    (1, 2, 4, 256, 64, 6, 21),      # odd L: the two-stage Pallas form
    (2, 2, 4, 256, 128, 6, 20),     # d = 128 (8B), even L: one kernel
    # The general tile's group sizes and the small head dims.
    (1, 2, 3, 256, 64, 6, 20),      # SmolLM2-360M's group of 3 at d = 64
    (1, 2, 5, 256, 128, 6, 21),
    (1, 1, 6, 256, 128, 6, 20),     # Mistral-Small-2409's group of 6
    (1, 1, 7, 256, 64, 6, 21),
    (1, 1, 16, 256, 128, 6, 20),    # Llama-3.1-405B's group of 16
    (1, 2, 4, 256, 32, 6, 20),
    (1, 2, 4, 512, 16, 6, 21),      # llama-tiny's head shape, odd L
])
def test_lsh_plain_matches_pallas_fused_decode(B, HKV, G, S, D, K, L):
    q, kc, v, proj, length = _lsh_inputs(3, B, HKV, G, S, D, K, L)
    knorm = np.linalg.norm(kc, axis=-1)
    fold = max(128 // D, 1)
    blk = jbits.plane_block(S, fold)
    jplanes = jax.vmap(lambda kb: jbits.build_planes_blocked(
        kb.transpose(1, 0, 2), jnp.asarray(proj), K, blk, fold))(jnp.asarray(kc))
    jqb = jbits.hash_bits(jnp.asarray(q), jnp.asarray(proj), K)
    jo, jl, jc = j_lsh_fused_decode(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(v), jnp.asarray(knorm),
        jplanes, jqb, jnp.asarray(length), K, L,
        block_tokens=max(128, 32 * fold), interpret=True)
    qb = tbits.hash_bits(_t(q), _t(proj), K)
    to, tl, tc = lsh_fused_decode(_t(q), _t(kc), _t(v), _t(knorm),
                                  _port_planes(kc, proj, K), qb, _t(length),
                                  K, L)
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    assert _np(tc).min() > 0
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=LSH_TOL, rtol=LSH_TOL)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LSH_TOL, rtol=LSH_TOL)


@pytest.mark.parametrize("K,L", [(6, 20), (10, 150)])
def test_lsh_plain_matches_xla_masked_decode(K, L):
    """Same mask into both: the port's masked decode against the JAX oracle
    `lsh_masked_decode` (the XLA form the JAX engine runs on the CPU)."""
    B, HKV, G, S, D = 2, 2, 4, 256, 64
    q, kc, v, proj, length = _lsh_inputs(4, B, HKV, G, S, D, K, L)
    knorm = np.linalg.norm(kc, axis=-1)
    qb = tbits.hash_bits(_t(q), _t(proj), K)
    mask = tbits.sampled_mask(qb, _port_planes(kc, proj, K), _t(length))
    jo, jl = jatt.lsh_masked_decode(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(v), jnp.asarray(knorm),
        jnp.asarray(_np(mask)), jnp.asarray(length), K, L)
    to, tl = tatt.lsh_masked_decode(_t(q), _t(kc), _t(v), _t(knorm), mask,
                                    _t(length), K, L)
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=LSH_TOL, rtol=LSH_TOL)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LSH_TOL, rtol=LSH_TOL)


def test_lsh_masked_decode_matches_float64_evaluation():
    """The port's masked decode against the same formula in float64 numpy,
    with random keys (most sampled keys collided by chance, so small
    collision weights get the largest debias weights)."""
    from magicpig_tpu.ops.debias import exact_log_weight
    B, HKV, G, S, D, K, L = 2, 2, 4, 512, 64, 10, 150
    rng = np.random.default_rng(14)
    q = rng.standard_normal((B, HKV * G, D)).astype(np.float32)
    kc = rng.standard_normal((B, HKV, S, D)).astype(np.float32)
    v = rng.standard_normal((B, HKV, S, D)).astype(np.float32)
    knorm = np.linalg.norm(kc, axis=-1)
    proj = rng.standard_normal((D, K * L)).astype(np.float32)
    length = np.asarray([S, 300], np.int32)
    qb = tbits.hash_bits(_t(q), _t(proj), K)
    mask = _np(tbits.sampled_mask(qb, _port_planes(kc, proj, K), _t(length)))
    assert mask.sum() > 0
    to, tl = tatt.lsh_masked_decode(_t(q), _t(kc), _t(v), _t(knorm), _t(mask),
                                    _t(length), K, L)

    qh = q.astype(np.float64).reshape(B, HKV, G, D)
    raw = np.einsum("bhgd,bhsd->bhgs", qh, kc.astype(np.float64))
    cos = raw / (np.linalg.norm(qh, axis=-1)[..., None] * knorm[:, :, None])
    s = raw / np.sqrt(D) - exact_log_weight(cos, K, L)
    s = np.where(mask.reshape(B, HKV, G, S), s, -np.inf)
    m = s.max(-1, keepdims=True)
    p = np.exp(s - m)
    out = np.einsum("bhgs,bhsd->bhgd", p, v.astype(np.float64)) / p.sum(-1)[..., None]
    lse = (m[..., 0] + np.log(p.sum(-1))).reshape(B, HKV * G)
    np.testing.assert_allclose(_np(to), out.reshape(B, HKV * G, D), atol=F32, rtol=F32)
    np.testing.assert_allclose(_np(tl), lse, atol=F32, rtol=F32)


# -- wrappers: dispatch, checks, counting, build key ---------------------------------


def test_cpu_tensors_take_the_plain_versions_without_counting():
    before = dict(LAUNCHES)
    rng = np.random.default_rng(5)
    q = _t(rng.standard_normal((1, 4, 64)).astype(np.float32))
    k = _t(rng.standard_normal((1, 2, 64, 64)).astype(np.float32))
    length = torch.tensor([50], dtype=torch.int32)
    o, l = flash_decode(q, k, k, length)
    po, pl = tatt.full_decode(q, k, k, length)
    assert torch.equal(o, po) and torch.equal(l, pl)
    assert LAUNCHES == before


@pytest.mark.parametrize("which", ["prefill", "decode", "lsh", "block_rank",
                                   "exact_scores_ranked", "rescore_attend",
                                   "block_attend", "decode_int8", "lsh_int8",
                                   "w4_matmul"])
def test_wrappers_raise_for_other_devices(which):
    """A tensor neither on the CPU nor on a card is refused, not run."""
    m = torch.device("meta")
    i32 = dict(dtype=torch.int32, device=m)
    q = torch.empty((1, 4, 64), dtype=torch.bfloat16, device=m)
    k = torch.empty((1, 2, 64, 64), dtype=torch.bfloat16, device=m)
    length = torch.empty((1,), **i32)
    ids = torch.empty((1, 2, 1), **i32)
    with pytest.raises(ValueError):
        if which == "prefill":
            x = torch.empty((1, 64, 4, 64), dtype=torch.bfloat16, device=m)
            flash_prefill(x, x[:, :, :2], x[:, :, :2], length)
        elif which == "decode":
            flash_decode(q, k, k, length)
        elif which == "lsh":
            lsh_fused_decode(q, k, k, torch.empty((1, 2, 64), device=m),
                             torch.empty((1, 2, 3, 2, 2), **i32),
                             torch.empty((1, 4, 3, 2), **i32), length, 2, 3)
        elif which == "block_rank":
            block_rank(q, k, None, length, 64)
        elif which == "exact_scores_ranked":
            exact_scores_ranked(q, k, None, length, 64)
        elif which == "rescore_attend":
            rescore_attend(q, ids, k, None, k, None, length, 64)
        elif which == "decode_int8":
            k8 = torch.empty((1, 2, 64, 64), dtype=torch.int8, device=m)
            sc = torch.empty((1, 2, 64), device=m)
            flash_decode(q, k8, k8, length, sc, sc)
        elif which == "lsh_int8":
            k8 = torch.empty((1, 2, 64, 64), dtype=torch.int8, device=m)
            sc = torch.empty((1, 2, 64), device=m)
            lsh_fused_decode(q, k8, k8, sc, torch.empty((1, 2, 3, 2, 2), **i32),
                             torch.empty((1, 4, 3, 2), **i32), length, 2, 3,
                             sc, sc)
        elif which == "w4_matmul":
            w4_matmul(torch.empty((2, 128), dtype=torch.bfloat16, device=m),
                      torch.empty((64, 128), dtype=torch.int8, device=m),
                      torch.empty((1, 128), device=m))
        else:
            block_attend(torch.empty((1, 2, 2, 64), device=m), ids, k, None, 64)


@pytest.mark.parametrize("capacity,batch,hkv,sms,want", [
    (16384, 2, 8, 132, 1024),    # the dense layer of the 1B serve
    (384, 2, 8, 132, 256),       # its hot caches: one split with tokens
    (16384, 9, 2, 132, 1024),
    (1500, 3, 8, 132, 320),      # 5 splits a pair, 120 blocks
    (4096, 2, 8, 132, 512),      # 128 blocks
    (65, 1, 1, 1, 256),
])
def test_decode_split_size(capacity, batch, hkv, sms, want):
    """flash_decode's split: whole 64-token tiles, 256 to 1024 tokens, and
    below 1024 about one block per SM over all (request, kv head) pairs: no
    more than one per SM plus one split a pair, and, above 256, one tile
    less would give more than one per SM."""
    chunk = split_tokens(capacity, batch, hkv, sms)
    assert chunk == want
    assert chunk % 64 == 0 and 256 <= chunk <= 1024
    pairs = batch * hkv
    if chunk < 1024:
        assert -(-capacity // chunk) * pairs <= sms + pairs
    if 256 < chunk < 1024:
        assert (chunk - 64) * sms < capacity * pairs


@pytest.mark.parametrize("block_size,chunk,nsel,g,want", [
    (512, None, 3, 4, (128, 4)),     # the serves: 12 partials, one batch
    (512, None, 11, 4, (256, 2)),    # 44 at 128 tokens: over a batch of 31
    (512, None, 11, 8, (512, 1)),    # a batch of 15
    (512, None, 40, 4, (512, 1)),    # never past 512
    (512, 64, 3, 4, (64, 8)),
    (512, 512, 3, 4, (512, 1)),
    (64, 256, 3, 4, (64, 1)),        # a block smaller than the chunk
    (192, 128, 3, 4, (128, 2)),      # the last chunk shorter (64 tokens)
    (1024, 256, 3, 4, (256, 4)),
])
def test_attend_chunk_plan(block_size, chunk, nsel, g, want):
    """The attends' chunks cover each selected block: chunk x count >= the
    block size, less than one chunk over it; by default the smallest
    chunk from 128 whose partials fit one merge batch."""
    got = chunk_plan(block_size, chunk, nsel, g)
    assert got == want
    c, n = got
    assert (n - 1) * c < block_size <= n * c


@pytest.mark.parametrize("nsel,g,rows,want", [
    (3, 4, (128, 128, True, True), (128, 4)),     # int8 rescore, the serves
    (11, 4, (128, 128, True, True), (256, 2)),    # 22 partials: one batch
    (11, 4, (64, 128, True, True), (256, 2)),     # packed int4 K, int8 V
    (11, 4, (0, 256, False, False), (256, 2)),    # bf16 block-attend
    (11, 8, (0, 256, False, False), (512, 1)),    # a batch of 15 at G = 8
    (40, 8, (256, 256, False, False), (256, 2)),  # bf16 rescore: no 512
    (3, 3, (128, 128, True, True), (128, 4)),     # the 3B's serves, G = 3
    (11, 3, (64, 128, True, True), (256, 2)),     # 44 partials: over 42
    (21, 3, (0, 256, False, False), (256, 2)),    # 42: one batch exactly
    (22, 3, (0, 256, False, False), (512, 1)),    # 44 at 256: 512 fits
])
def test_attend_chunk_plan_d128(nsel, g, rows, want):
    """At head dim 128 the merge takes as many partials a batch as at 64
    (31 at G = 4, 15 at G = 8; 42 at G = 3, the 3B's group, which has no
    d = 64 form), and a chunk's rows must fit a CUDA block's
    227 KB: bf16 K and V of 512 tokens (256 KB) do not, so the plan stops
    at 256 and an explicit 512 raises."""
    assert chunk_plan(512, None, nsel, g, 128, rows) == want
    if rows == (256, 256, False, False):
        with pytest.raises(ValueError):
            chunk_plan(512, 512, nsel, g, 128, rows)


@pytest.mark.parametrize("chunk", [0, 32, 96, 1024])
def test_attend_chunk_plan_refuses_other_chunks(chunk):
    with pytest.raises(ValueError):
        chunk_plan(512, chunk, 3, 4)


@pytest.mark.parametrize("which", ["rescore_attend", "block_attend"])
def test_attend_launchers_refuse_cpu_tensors(which):
    """The launchers that take a chunk are the card's path only: the
    wrappers send CPU tensors to the plain versions, the launchers refuse
    them and count nothing."""
    before = dict(LAUNCHES)
    q = torch.zeros((1, 4, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 2, 64, 64), dtype=torch.bfloat16)
    ids = torch.zeros((1, 2, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        if which == "rescore_attend":
            launch_rescore_attend(q, ids, k, None, k, None,
                                  torch.ones((1,), dtype=torch.int32), 64, 64)
        else:
            launch_block_attend(torch.zeros((1, 2, 2, 64)), ids, k, None, 64,
                                64)
    assert LAUNCHES == before


def test_reset_launches_clears_the_w4_shape_counts():
    _lib.W4_SHAPE_LAUNCHES["2048x3072"] = 3
    _lib.LAUNCHES["w4_matmul"] += 3
    _lib.reset_launches()
    assert _lib.W4_SHAPE_LAUNCHES == {} and set(LAUNCHES.values()) == {0}


@pytest.mark.parametrize("groups,want,expect", [
    (16, 16, (16, 1)), (16, 5, (4, 4)), (16, 1, (1, 16)), (64, 16, (16, 4)),
    (64, 5, (5, 13)), (16, 32, (16, 1)), (7, 3, (3, 3)),
])
def test_w4_split_groups(groups, want, expect):
    """At most `want` splits of whole groups, the groups per split rounded
    up, none empty."""
    ks, per = split_groups(groups, want)
    assert (ks, per) == expect
    assert ks <= max(1, min(want, groups))
    assert (ks - 1) * per < groups <= ks * per


@pytest.mark.parametrize("kin,out,m,want", [
    (2048, 128256, 2, (16, 1, 16)),     # the lm_head: 251 wide tiles
    (2048, 128256, 64, (16, 1, 16)),
    (2048, 16384, 2, (8, 4, 4)),        # gate|up: 64 tiles of 256
    (2048, 3072, 2, (8, 16, 1)),
    (8192, 2048, 2, (8, 16, 4)),
    # Llama-3.1-8B's products at B=2 (bench.py's full_int8 mode with W4):
    (4096, 6144, 2, (8, 11, 3)),        # q|k|v: 24 tiles of 256
    (4096, 4096, 2, (8, 16, 2)),        # o
    (4096, 28672, 2, (8, 3, 11)),       # gate|up: 112 tiles
    (14336, 4096, 2, (8, 16, 7)),       # down: 112 groups
    (4096, 128256, 2, (16, 2, 16)),     # the untied lm_head
])
def test_w4_plan(kin, out, m, want):
    """16 columns a lane and the fewest splits where the 512-column tiles
    alone fill 132 SMs, else 8 columns and `split_k`; never more than 16
    splits or 16 groups a split."""
    got = w4_plan(kin, out, m, 132)
    assert got == want
    lane_cols, ks, per = got
    assert ks <= 16 and per <= 16 and (ks - 1) * per < kin // 128 <= ks * per


def test_build_is_keyed_on_the_sources(tmp_path, monkeypatch):
    """The library name changes with any source byte, so a stale build is
    never loaded; every .cu and .cuh of csrc/ is covered."""
    names = {p.name for p in _lib.sources()}
    assert {"flash_prefill.cu", "flash_decode.cu", "lsh_fused.cu",
            "block_score.cu", "rescore_attend.cu", "block_attend.cu",
            "block_common.cuh", "chunk_attend.cuh", "lsh_common.cuh",
            "hopper_common.cuh", "w4_matmul.cu"} <= names
    key = _lib.source_hash()
    for p in _lib.sources():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_lib, "CSRC_DIR", tmp_path)
    assert _lib.source_hash() == key
    (tmp_path / "common.cuh").write_bytes(
        (tmp_path / "common.cuh").read_bytes() + b"\n")
    assert _lib.source_hash() != key

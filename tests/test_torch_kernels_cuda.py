"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Each test takes the `cuda` fixture and skips without a card. This file
imports no JAX, so it also runs on the card machine, which has none:

    python3 -m pytest --noconftest tests/test_torch_kernels_cuda.py

Tolerances follow the rule `chip_smoke.py` holds the kernels to at full
size (its `TOL`, where each is explained): |kernel - plain| <= atol + rtol
* |plain| + rms_share * rms(plain). bf16 prefill outputs atol 4e-3, rtol
1e-2; f32 decode, LSH and block-attend outputs 0.015 of the plain output's
rms; lse atol 1e-4, rtol 1e-5; sampled counts exactly; block scores and
block maxes `SCORE_TOL` (f32 sums of the same products in another order),
and the top-k block ids from them exactly. The int8 decode and LSH kernels
like their bf16 forms (0.015 of the rms; lse 1e-4, 1e-5). The int4 matmul
`W4_TOL`, 1e-5 of the output's rms: f32 sums of the same exact products
(bf16 times a nibble) in another order. The W8A8 linear on the card equals
the same function on the CPU exactly (an exact integer product between the
same float32 steps). The packed int4 forms of the block scorer and the
rescore-attend are held to their plain versions like the int8 forms, and
equal the int8 kernels on the unpacked rows bit for bit (the same products
summed in the same order); the poly and none debias forms of the fused LSH
kernel like its exact form. The collision scan bit for bit; the masked
attend from words, each of its six forms, like the fused kernel, and the
two-stage route of `lsh_decode` against the fused kernel on the same
inputs to the same limits; `exact_scores` like the block scores. The
prefill, decode and block scorer edge cases poison the cache rows past each
length with NaN and hold the kernels to the plain versions on the
tail-zeroed cache, to the same limits; the LSH edge cases poison every row
that no head samples (the attends gather only sampled rows). The rescore
pipeline equals the store pipeline bit for bit (the scorer's routine and
one attend), at every chunk; the int4 matmul runs one kernel a call,
counted as the kernel nodes of a captured CUDA graph. The training
backward's dq, dk and dv (f32, from bf16 inputs, p and dS rounded to bf16
for their products) within `BWD_TOL` = 1e-2 of each plain gradient's
largest |value|, and bit-equal from run to run (no atomics).
"""

import numpy as np
import pytest
import torch

from magicpig_tpu_torch.ops import attention as tatt
from magicpig_tpu_torch.ops import bitcodes as tbits
from magicpig_tpu_torch.models import llama as tllama
from magicpig_tpu_torch.ops.kernels import (
    LAUNCHES,
    _lib,
    block_attend,
    block_rank,
    collision_words,
    exact_scores,
    exact_scores_ranked,
    flash_decode,
    flash_prefill,
    flash_prefill_bwd,
    flash_prefill_train,
    lsh_decode,
    lsh_fused_decode,
    lsh_masked_attention,
    rescore_attend,
    w4_matmul,
)
from magicpig_tpu_torch.ops.kernels.block_attend import (
    block_attend_plain,
    launch_block_attend,
)
from magicpig_tpu_torch.ops.kernels.block_score import (
    block_scores_plain,
    exact_scores_plain,
)
from magicpig_tpu_torch.ops.kernels.flash_decode import head_suffix
from magicpig_tpu_torch.ops.kernels.flash_prefill import (
    bwd_launch_name,
    launch_name as prefill_launch_name,
)
from magicpig_tpu_torch.ops.kernels.flash_decode import (
    launch_name as decode_launch_name,
)
from magicpig_tpu_torch.ops.kernels.lsh_fused import (
    launch_name as fused_launch_name,
)
from magicpig_tpu_torch.ops.kernels.lsh_fused import lsh_fused_decode_plain
from magicpig_tpu_torch.ops.kernels.lsh_masked import (
    launch_attend,
    lsh_masked_attention_plain,
)
from magicpig_tpu_torch.ops.kernels.lsh_masked import (
    launch_name as masked_launch_name,
)
from magicpig_tpu_torch.ops.kernels.rescore_attend import (
    launch_rescore_attend,
    rescore_attend_plain,
)
from magicpig_tpu_torch.ops.kernels.w4_matmul import w4_matmul_plain
from magicpig_tpu_torch.ops.pack4 import pack_k4
from magicpig_tpu_torch.ops.quant import dequantize_rows, quantize_rows
from magicpig_tpu_torch.runtime.engine import graph_kernel_nodes

SCORE_TOL = (1e-5, 1e-5, 0.0)
W4_TOL = (0.0, 0.0, 1e-5)
# The group sizes of the d = 128 forms (3: Llama-3.2-3B's 24 query heads
# over 8) and of the collision scan, which has no head dim.
G128 = [1, 2, 3, 4, 8]
# The forms of the kernels' general tile and of the small head dims, as
# (head dim, group size): the group sizes with no exact instance at head
# dims 64 and 128 (SmolLM2-360M's 3 at 64; 5; Mistral-Small-2409's 6;
# Yi-34B's 7; Llama-3.1-405B's 16: one block of the decode and LSH
# kernels' 16-head tile, two of the block kernels' 8-head one;
# StarCoder-15B's multi-query 48 heads of 128 over one: three 16-head
# blocks) and head dims 16 and 32 (llama-tiny: 4 at 16), each at a group
# size of one block and one of two or more.
NEW_FORMS = [(64, 3), (64, 5), (64, 6), (64, 7), (64, 16), (128, 5),
             (128, 6), (128, 7), (128, 16), (128, 48), (16, 1), (16, 4),
             (16, 6), (32, 4), (32, 16)]
NEW_FORM_IDS = [f"d{d}-g{g}" for d, g in NEW_FORMS]
# The group sizes of the general tile in the collision scan (no head dim).
SCAN_NEW_GROUPS = [5, 6, 7, 16]


@pytest.fixture
def cuda():
    """The card; the kernel tests skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _assert_within(got, want, atol=0.0, rtol=0.0, rms_share=0.0):
    """|got - want| <= atol + rtol * |want| + rms_share * rms(want), the
    rms over want's finite entries; equal infinities agree."""
    finite = want[torch.isfinite(want)].float()
    rms = float(finite.square().mean().sqrt()) if finite.numel() else 0.0
    torch.testing.assert_close(got.float(), want.float(),
                               atol=atol + rms_share * rms, rtol=rtol)


# The bf16 rounding of a sampled attend's P.V operand, p times the V scale:
# the kernel rounds each split's p against the split's running max, the
# plain version against the head's, so each term of the sum may round an
# ulp apart (2^-9 of it each way). The new forms' LSH tests add this
# bound, 2^-8 of sum(p |v|) / sum(p), to 0.015 of the rms
# (`_output_check`): with few sampled keys in a head one key can carry a
# whole output value, and where a request's last split holds one token
# (513 tokens) the rms limit alone was passed by 1.04-1.06x on 1 of
# 5376-12288 values (G = 7 int8, G = 16 bf16, d = 64).
ROUNDING_ULPS = 2.0 ** -8


def _output_check(plain, args, rounding: bool, v_at: int = 2):
    """The check of a sampled attend's output against its plain version
    `plain(*args)`: within 0.015 of the rms, plus (with `rounding`)
    ROUNDING_ULPS times the plain attend over |V| (the same p, the same
    scales), elementwise."""
    if not rounding:
        return lambda got, want: _assert_within(got, want, rms_share=0.015)
    args = list(args)
    args[v_at] = args[v_at].abs()
    bound = ROUNDING_ULPS * plain(*args)[0].float()

    def check(got, want):
        finite = want[torch.isfinite(want)].float()
        rms = float(finite.square().mean().sqrt()) if finite.numel() else 0.0
        excess = (got.float() - want.float()).abs() - 0.015 * rms - bound
        assert not torch.isnan(excess).any() and float(excess.max()) <= 0.0
    return check


def _bf16(rng, *shape, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        device, torch.bfloat16)


def test_cuda_flash_prefill_matches_plain(cuda):
    rng = np.random.default_rng(6)
    q = _bf16(rng, 2, 300, 32, 64, device=cuda)
    k = _bf16(rng, 2, 420, 8, 64, device=cuda)
    v = _bf16(rng, 2, 420, 8, 64, device=cuda)
    length = torch.tensor([420, 200], dtype=torch.int32, device=cuda)
    offset = torch.tensor([120, 0], dtype=torch.int32, device=cuda)
    for window in (None, 100):
        o, l = flash_prefill(q, k, v, length, offset, window=window,
                             return_lse=True)
        po, pl = tatt.flash_prefill(q, k, v, length, offset, window=window,
                                    return_lse=True)
        _assert_within(o, po, atol=4e-3, rtol=1e-2)
        _assert_within(l, pl, atol=1e-4, rtol=1e-5)


def test_cuda_flash_decode_matches_plain(cuda):
    rng = np.random.default_rng(7)
    q = _bf16(rng, 3, 32, 64, device=cuda)
    k = _bf16(rng, 3, 8, 1500, 64, device=cuda)
    v = _bf16(rng, 3, 8, 1500, 64, device=cuda)
    length = torch.tensor([1500, 513, 0], dtype=torch.int32, device=cuda)
    before = LAUNCHES["flash_decode"]
    o, l = flash_decode(q, k, v, length)
    assert LAUNCHES["flash_decode"] == before + 1
    po, pl = tatt.full_decode(q, k, v, length)
    _assert_within(o, po, rms_share=0.015)
    _assert_within(l, pl, atol=1e-4, rtol=1e-5)
    assert (o[2] == 0).all() and torch.isneginf(l[2]).all()


def test_cuda_flash_decode_int8_matches_plain(cuda):
    """int8 K/V with per-token scales; request 1 ends mid-split, request 2
    is empty."""
    rng = np.random.default_rng(12)
    q = _bf16(rng, 3, 32, 64, device=cuda)
    k, ks = quantize_rows(_bf16(rng, 3, 8, 1500, 64, device=cuda))
    v, vs = quantize_rows(_bf16(rng, 3, 8, 1500, 64, device=cuda))
    length = torch.tensor([1500, 700, 0], dtype=torch.int32, device=cuda)
    before = dict(LAUNCHES)
    o, l = flash_decode(q, k, v, length, ks, vs)
    assert LAUNCHES["flash_decode_int8"] == before["flash_decode_int8"] + 1
    assert LAUNCHES["flash_decode"] == before["flash_decode"]
    po, pl = tatt.full_decode(q, k, v, length, ks, vs)
    _assert_within(o, po, rms_share=0.015)
    _assert_within(l, pl, atol=1e-4, rtol=1e-5)
    assert (o[2] == 0).all() and torch.isneginf(l[2]).all()


def _kernel_launches(fn, calls: int = 3) -> int:
    """CUDA kernels that `calls` calls of `fn` launch: the kernel nodes of a
    CUDA graph captured from them (`fn` has run once already, so that its
    kernel attributes are set). Not torch.profiler: it drops kernels late
    in a long session, and a run of the whole file saw too few in tests
    that pass alone."""
    return _graph_kernel_nodes(lambda: [fn() for _ in range(calls)])


@pytest.mark.parametrize("sq", [1, 63, 129, 300, 1000])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_cuda_flash_prefill_edges(cuda, g, sq):
    """Query spans off every tile size, a q_offset, length < Skv (request 1
    ends inside its own span), a window and the LSE; cache rows past each
    length hold NaN, which the kernel must never let through: it is held
    to the plain version on the same inputs with that tail zeroed."""
    rng = np.random.default_rng(21)
    hkv, offs = 2, [200, 50]
    skv = sq + 237
    lens = [200 + sq, 50 + max(sq - 3, 1)]
    q = _bf16(rng, 2, sq, g * hkv, 64, device=cuda)
    k = _bf16(rng, 2, skv, hkv, 64, device=cuda)
    v = _bf16(rng, 2, skv, hkv, 64, device=cuda)
    kz, vz = k.clone(), v.clone()
    for b, n in enumerate(lens):
        k[b, n:] = float("nan")
        v[b, n:] = float("nan")
        kz[b, n:] = 0
        vz[b, n:] = 0
    length = torch.tensor(lens, dtype=torch.int32, device=cuda)
    offset = torch.tensor(offs, dtype=torch.int32, device=cuda)
    for window in (None, 77):
        before = LAUNCHES["flash_prefill"]
        o, l = flash_prefill(q, k, v, length, offset, window=window,
                             return_lse=True)
        assert LAUNCHES["flash_prefill"] == before + 1
        po, pl = tatt.flash_prefill(q, kz, vz, length, offset, window=window,
                                    return_lse=True)
        assert torch.isfinite(o).all() and not torch.isnan(l).any()
        _assert_within(o, po, atol=4e-3, rtol=1e-2)
        _assert_within(l, pl, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("capacity", [384, 16384])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("int8", [False, True])
def test_cuda_flash_decode_edges(cuda, int8, g, capacity):
    """Ragged and zero lengths around every tile and split edge; cache rows
    past each length hold NaN (bf16) or NaN scales (int8), held to the
    plain version on the tail-zeroed cache. One launch per call, counted
    by the wrapper and by a captured graph's kernel nodes, and a second
    call equal to the
    first (the merge tickets were reset)."""
    rng = np.random.default_rng(22)
    hkv = 2
    lens = [min(n, capacity) for n in (0, 1, 63, 64, 65, 511, 512, 513, capacity)]
    b = len(lens)
    q = _bf16(rng, b, g * hkv, 64, device=cuda)
    k = _bf16(rng, b, hkv, capacity, 64, device=cuda)
    v = _bf16(rng, b, hkv, capacity, 64, device=cuda)
    ks = vs = None
    if int8:
        k, ks = quantize_rows(k)
        v, vs = quantize_rows(v)
    zeroed = [x.clone() if x is not None else None for x in (k, v, ks, vs)]
    for i, n in enumerate(lens):
        for x in zeroed:
            if x is not None:
                x[i, :, n:] = 0
        if int8:
            ks[i, :, n:] = float("nan")
            vs[i, :, n:] = float("nan")
        else:
            k[i, :, n:] = float("nan")
            v[i, :, n:] = float("nan")
    length = torch.tensor(lens, dtype=torch.int32, device=cuda)
    name = "flash_decode_int8" if int8 else "flash_decode"
    before = dict(LAUNCHES)
    o, l = flash_decode(q, k, v, length, ks, vs)
    assert LAUNCHES[name] == before[name] + 1
    assert sum(LAUNCHES.values()) == sum(before.values()) + 1
    kz, vz, ksz, vsz = zeroed
    po, pl = tatt.full_decode(q, kz, vz, length, ksz, vsz)
    assert torch.isfinite(o).all() and not torch.isnan(l).any()
    _assert_within(o, po, rms_share=0.015)
    _assert_within(l, pl, atol=1e-4, rtol=1e-5)
    assert (o[0] == 0).all() and torch.isneginf(l[0]).all()
    o2, l2 = flash_decode(q, k, v, length, ks, vs)
    assert torch.equal(o, o2) and torch.equal(l, l2)
    assert _kernel_launches(lambda: flash_decode(q, k, v, length, ks, vs)) == 3


# flash_decode's `start` forms: (head dim, group size), the exact
# instances, then the general tile's and the small head dims' forms.
START_FORMS = ([(64, g) for g in (1, 2, 4, 8)] + [(128, g) for g in G128]
               + NEW_FORMS)


@pytest.mark.parametrize("d,g", START_FORMS)
@pytest.mark.parametrize("int8", [False, True])
def test_cuda_flash_decode_start_matches_plain(cuda, int8, d, g):
    """Each request attends rows [start, length) of a 16384-token cache
    (1024-token splits at this batch): starts past whole splits (11905:
    the 11 splits before it wholly masked, as a sliding window's dense
    decode at 16000 tokens; 8999 in the split that holds the last row),
    inside the first tile, on a tile and a split edge, at 0, and empty
    ranges (start = length, start past it). Rows before each start and
    past each length hold NaN (bf16) or NaN scales (int8), which the
    kernel must never read: held to the plain version on the zeroed
    cache. A start of zeros equals no start bit for bit; one launch a
    call, counted by the wrapper and a captured graph's kernel nodes, and
    a second call equal to the first (the tickets were reset)."""
    rng = np.random.default_rng(31 + g + d)
    hkv, cap = 2, 16384
    lens = [16001, 9000, 5000, 700, 300, 64, 4096, 2048, 700, 16384]
    starts = [11905, 8999, 0, 700, 1, 63, 1024, 64, 900, 12288]
    b = len(lens)
    q = _bf16(rng, b, g * hkv, d, device=cuda)
    k = _bf16(rng, b, hkv, cap, d, device=cuda)
    v = _bf16(rng, b, hkv, cap, d, device=cuda)
    ks = vs = None
    if int8:
        k, ks = quantize_rows(k)
        v, vs = quantize_rows(v)
    zeroed = [x.clone() if x is not None else None for x in (k, v, ks, vs)]
    for i, (lo, n) in enumerate(zip(starts, lens)):
        for rows in (slice(0, lo), slice(n, cap)):
            for x in zeroed:
                if x is not None:
                    x[i, :, rows] = 0
            for x in ((ks, vs) if int8 else (k, v)):
                x[i, :, rows] = float("nan")
    length = torch.tensor(lens, dtype=torch.int32, device=cuda)
    start = torch.tensor(starts, dtype=torch.int32, device=cuda)
    name = decode_launch_name(int8, d, g)
    before = dict(LAUNCHES)
    o, l = flash_decode(q, k, v, length, ks, vs, start)
    assert LAUNCHES[name] == before.get(name, 0) + 1
    assert sum(LAUNCHES.values()) == sum(before.values()) + 1
    kz, vz, ksz, vsz = zeroed
    po, pl = tatt.full_decode(q, kz, vz, length, ksz, vsz, start)
    assert torch.isfinite(o).all() and not torch.isnan(l).any()
    _assert_within(o, po, rms_share=0.015)
    _assert_within(l, pl, atol=1e-4, rtol=1e-5)
    empty = [i for i, (lo, n) in enumerate(zip(starts, lens)) if lo >= n]
    assert empty and (o[empty] == 0).all() and torch.isneginf(l[empty]).all()
    o2, l2 = flash_decode(q, k, v, length, ks, vs, start)
    assert torch.equal(o, o2) and torch.equal(l, l2)
    assert _kernel_launches(
        lambda: flash_decode(q, k, v, length, ks, vs, start)) == 3
    # A start of zeros is no start at all (on the cache without NaN).
    zero = torch.zeros_like(start)
    assert all(torch.equal(a, b) for a, b in zip(
        flash_decode(q, kz, vz, length, ksz, vsz, zero),
        flash_decode(q, kz, vz, length, ksz, vsz)))
    with pytest.raises(ValueError, match="start"):
        flash_decode(q, k, v, length, ks, vs, start.long())
    with pytest.raises(ValueError, match="start"):
        flash_decode(q, k, v, length, ks, vs, start[:3])


@pytest.mark.parametrize("K,L", [(10, 150), (6, 41)])
def test_cuda_lsh_fused_int8_matches_plain(cuda, K, L):
    """int8 centered keys and values, norms of the dequantized keys."""
    rng = np.random.default_rng(13)
    B, S = 2, 2048
    q = _bf16(rng, B, 32, 64, device=cuda)
    kq, ks = quantize_rows(_bf16(rng, B, 8, S, 64, device=cuda))
    vq, vs = quantize_rows(_bf16(rng, B, 8, S, 64, device=cuda))
    kd = dequantize_rows(kq, ks, torch.float32)
    proj = torch.from_numpy(rng.standard_normal((64, K * L)).astype(np.float32)).to(cuda)
    planes = torch.stack([tbits.build_planes(kd[b].transpose(0, 1), proj, K)
                          for b in range(B)])
    qb = tbits.hash_bits(q, proj, K)
    length = torch.tensor([S, 1337], dtype=torch.int32, device=cuda)
    args = (q, kq, vq, kd.norm(dim=-1), planes, qb, length, K, L, ks, vs)
    before = dict(LAUNCHES)
    o, l, c = lsh_fused_decode(*args)
    assert LAUNCHES["lsh_fused_decode_int8"] == before["lsh_fused_decode_int8"] + 1
    po, pl, pc = lsh_fused_decode_plain(*args)
    assert torch.equal(c, pc) and c.min() > 0
    _assert_within(o, po, rms_share=0.015)
    _assert_within(l, pl, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("M,KIN,OUT", [
    (2, 2048, 3072),     # wqkv of Llama-3.2-1B, fused
    (2, 8192, 2048),     # w_down: 32 K-splits
    (1, 2048, 384),      # a half-empty last column tile
    (7, 1024, 256),      # two 4-row slices, the second ragged
    (64, 4096, 512),     # the largest M the kernel takes
])
def test_cuda_w4_matmul_matches_plain(cuda, M, KIN, OUT):
    rng = np.random.default_rng(14)
    x = _bf16(rng, M, KIN, device=cuda)
    w = tllama.quantize_weight4(_bf16(rng, KIN, OUT, device=cuda) * 0.02)
    before = LAUNCHES["w4_matmul"]
    y = w4_matmul(x, w.q, w.scale)
    assert LAUNCHES["w4_matmul"] == before + 1
    atol, rtol, rms_share = W4_TOL
    _assert_within(y, w4_matmul_plain(x, w.q, w.scale), atol=atol, rtol=rtol,
                   rms_share=rms_share)


@pytest.mark.parametrize("M", [2, 40])
def test_cuda_int8_linear_equals_cpu(cuda, M):
    """W8A8 on the card (the integer GEMM, M padded past 16 where it is
    smaller) gives the CPU's numbers exactly."""
    rng = np.random.default_rng(15)
    x = _bf16(rng, M, 2048, device=cuda)
    w = tllama.quantize_weight(_bf16(rng, 2048, 1024, device=cuda) * 0.02)
    got = tllama.linear(x, w)
    want = tllama.linear(x.cpu(), tllama.QuantWeight(q=w.q.cpu(),
                                                     scale=w.scale.cpu()))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("K,L", [(10, 150), (6, 41)])
def test_cuda_lsh_fused_matches_plain(cuda, K, L):
    rng = np.random.default_rng(8)
    B, S = 2, 2048
    q = _bf16(rng, B, 32, 64, device=cuda)
    kc = _bf16(rng, B, 8, S, 64, device=cuda)
    v = _bf16(rng, B, 8, S, 64, device=cuda)
    knorm = kc.float().norm(dim=-1)
    proj = torch.from_numpy(rng.standard_normal((64, K * L)).astype(np.float32)).to(cuda)
    planes = torch.stack([tbits.build_planes(kc[b].transpose(0, 1), proj, K)
                          for b in range(B)])
    qb = tbits.hash_bits(q, proj, K)
    length = torch.tensor([S, 1337], dtype=torch.int32, device=cuda)
    o, l, c = lsh_fused_decode(q, kc, v, knorm, planes, qb, length, K, L)
    po, pl, pc = lsh_fused_decode_plain(q, kc, v, knorm, planes, qb, length, K, L)
    assert torch.equal(c, pc)
    _assert_within(o, po, rms_share=0.015)
    _assert_within(l, pl, atol=1e-4, rtol=1e-5)


def _block_inputs(cuda, int8, seed):
    """B=2 over 4096 tokens in 512-token blocks, request 1 ragged (1500)."""
    rng = np.random.default_rng(seed)
    q = _bf16(rng, 2, 32, 64, device=cuda)
    k = _bf16(rng, 2, 8, 4096, 64, device=cuda)
    v = _bf16(rng, 2, 8, 4096, 64, device=cuda)
    length = torch.tensor([4096, 1500], dtype=torch.int32, device=cuda)
    if not int8:
        return q, k, None, v, None, length
    kq, ks = quantize_rows(k)
    vq, vs = quantize_rows(v)
    return q, kq, ks, vq, vs, length


@pytest.mark.parametrize("int8", [True, False])
def test_cuda_block_scorer_matches_plain(cuda, int8):
    q, k, ks, _, _, length = _block_inputs(cuda, int8, 9)
    want_s, want_m = block_scores_plain(q, k, ks, length, 512)
    before = dict(LAUNCHES)
    got_m = block_rank(q, k, ks, length, 512)
    got_s, got_m2 = exact_scores_ranked(q, k, ks, length, 512)
    assert LAUNCHES["block_rank"] == before["block_rank"] + 1
    assert LAUNCHES["exact_scores_ranked"] == before["exact_scores_ranked"] + 1
    atol, rtol, _ = SCORE_TOL
    for got, want in ((got_s, want_s), (got_m, want_m), (got_m2, want_m)):
        assert torch.equal(torch.isneginf(got), torch.isneginf(want))
        _assert_within(got, want, atol=atol, rtol=rtol)
    assert torch.equal(got_m, got_m2)     # one arithmetic, both variants
    assert torch.equal(torch.topk(got_m, 3).indices.sort().values,
                       torch.topk(want_m, 3).indices.sort().values)


@pytest.mark.parametrize("int8", [True, False])
def test_cuda_rescore_attend_matches_plain(cuda, int8):
    """Request 1's selection includes blocks past its length (3 to 7)."""
    q, k, ks, v, vs, length = _block_inputs(cuda, int8, 10)
    ids = torch.topk(block_rank(q, k, ks, length, 512), 5).indices.to(torch.int32)
    o, l = rescore_attend(q, ids, k, ks, v, vs, length, 512)
    po, pl = rescore_attend_plain(q, ids, k, ks, v, vs, length, 512)
    _assert_within(o, po, rms_share=0.015)
    _assert_within(l, pl, atol=1e-4, rtol=1e-5)
    empty = torch.zeros_like(length)
    o, l = rescore_attend(q, ids, k, ks, v, vs, empty, 512)
    assert (o == 0).all() and torch.isneginf(l).all()


@pytest.mark.parametrize("int8", [True, False])
def test_cuda_block_attend_matches_plain(cuda, int8):
    q, k, ks, v, vs, length = _block_inputs(cuda, int8, 11)
    scores, bmax = exact_scores_ranked(q, k, ks, length, 512)
    ids = torch.topk(bmax, 5).indices.to(torch.int32)
    o, l = block_attend(scores, ids, v, vs, 512)
    po, pl = block_attend_plain(scores, ids, v, vs, 512)
    _assert_within(o, po, rms_share=0.015)
    _assert_within(l, pl, atol=1e-4, rtol=1e-5)
    # The two pipelines agree bit for bit: the rescore recomputes the stored
    # scores with the scorer's own routine.
    ro, rl = rescore_attend(q, ids, k, ks, v, vs, length, 512)
    assert torch.equal(ro, o) and torch.equal(rl, l)


@pytest.mark.parametrize("debias", ["poly", "none"])
@pytest.mark.parametrize("int8", [False, True])
def test_cuda_lsh_fused_debias_forms_match_plain(cuda, debias, int8):
    rng = np.random.default_rng(16)
    B, S, K, L = 2, 2048, 10, 150
    q = _bf16(rng, B, 32, 64, device=cuda)
    k = _bf16(rng, B, 8, S, 64, device=cuda)
    v = _bf16(rng, B, 8, S, 64, device=cuda)
    ks = vs = None
    kd = k.float()
    if int8:
        k, ks = quantize_rows(k)
        v, vs = quantize_rows(v)
        kd = dequantize_rows(k, ks, torch.float32)
    proj = torch.from_numpy(rng.standard_normal((64, K * L)).astype(np.float32)).to(cuda)
    planes = torch.stack([tbits.build_planes(kd[b].transpose(0, 1), proj, K)
                          for b in range(B)])
    qb = tbits.hash_bits(q, proj, K)
    length = torch.tensor([S, 1337], dtype=torch.int32, device=cuda)
    args = (q, k, v, kd.norm(dim=-1), planes, qb, length, K, L, ks, vs, debias)
    name = "lsh_fused_decode" + ("_int8" if int8 else "") + "_" + debias
    before = dict(LAUNCHES)
    o, l, c = lsh_fused_decode(*args)
    assert LAUNCHES[name] == before[name] + 1
    assert sum(LAUNCHES.values()) == sum(before.values()) + 1
    po, pl, pc = lsh_fused_decode_plain(*args)
    assert torch.equal(c, pc) and c.min() > 0
    _assert_within(o, po, rms_share=0.015)
    _assert_within(l, pl, atol=1e-4, rtol=1e-5)
    exact = lsh_fused_decode(*args[:-1])[0]
    assert (exact - o).abs().max() > 1e-3          # the form does something


def _int4_inputs(cuda, seed):
    """B=2 over 4096 tokens, request 1 ragged: K on the 4-bit grid, as the
    port stores it (packed) and in the int8 layout; int8 V."""
    q, k, _, v, _, length = _block_inputs(cuda, False, seed)
    k4, ks = quantize_rows(k, bits=4)
    vq, vs = quantize_rows(v)
    return q, pack_k4(k4), k4, ks, vq, vs, length


def test_cuda_packed_block_scorer_matches_plain_and_int8(cuda):
    q, kp, k4, ks, _, _, length = _int4_inputs(cuda, 17)
    want_s, want_m = block_scores_plain(q, kp, ks, length, 512)
    before = dict(LAUNCHES)
    got_m = block_rank(q, kp, ks, length, 512)
    got_s, got_m2 = exact_scores_ranked(q, kp, ks, length, 512)
    assert LAUNCHES["block_rank_int4"] == before["block_rank_int4"] + 1
    assert (LAUNCHES["exact_scores_ranked_int4"]
            == before["exact_scores_ranked_int4"] + 1)
    assert sum(LAUNCHES.values()) == sum(before.values()) + 2
    atol, rtol, _ = SCORE_TOL
    for got, want in ((got_s, want_s), (got_m, want_m), (got_m2, want_m)):
        assert torch.equal(torch.isneginf(got), torch.isneginf(want))
        _assert_within(got, want, atol=atol, rtol=rtol)
    # Bit for bit the int8 kernel's numbers on the unpacked 4-bit rows.
    int8_s, int8_m = exact_scores_ranked(q, k4, ks, length, 512)
    assert torch.equal(got_s, int8_s) and torch.equal(got_m2, int8_m)
    assert torch.equal(got_m, block_rank(q, k4, ks, length, 512))
    assert torch.equal(torch.topk(got_m, 3).indices.sort().values,
                       torch.topk(want_m, 3).indices.sort().values)


def test_cuda_packed_rescore_attend_matches_plain_and_int8(cuda):
    """Request 1's selection includes blocks past its length; the store
    pipeline (packed scores, the unchanged block_attend) agrees."""
    q, kp, k4, ks, vq, vs, length = _int4_inputs(cuda, 18)
    scores, bmax = exact_scores_ranked(q, kp, ks, length, 512)
    ids = torch.topk(bmax, 5).indices.to(torch.int32)
    before = dict(LAUNCHES)
    o, l = rescore_attend(q, ids, kp, ks, vq, vs, length, 512)
    assert LAUNCHES["rescore_attend_int4"] == before["rescore_attend_int4"] + 1
    po, pl = rescore_attend_plain(q, ids, kp, ks, vq, vs, length, 512)
    _assert_within(o, po, rms_share=0.015)
    _assert_within(l, pl, atol=1e-4, rtol=1e-5)
    io, il = rescore_attend(q, ids, k4, ks, vq, vs, length, 512)
    assert torch.equal(o, io) and torch.equal(l, il)
    bo, bl = block_attend(scores, ids, vq, vs, 512)
    assert torch.equal(bo, o) and torch.equal(bl, l)


def plant_collisions(planes, q_bits, b, h, w):
    """A copy of planes in which the 32 keys of word w of request b match
    query head h in tables 0 and 1 (their plane words set to the head's
    bits): the head's word w then has every bit set."""
    g = q_bits.shape[1] // planes.shape[1]
    planes = planes.clone()
    planes[b, h // g, :2, :, w] = -q_bits[b, h, :2]   # 1 -> all ones, 0 -> 0
    return planes


@pytest.mark.parametrize("K,L", [(10, 150), (8, 75), (3, 1)])
def test_cuda_collision_words_bit_exact(cuda, K, L):
    """Random planes (any bit pattern), W not a multiple of the kernel's
    32-word block; planted collisions in one word change the result."""
    rng = np.random.default_rng(17)
    B, HQ, HKV, W = 2, 32, 8, 77
    qb = torch.from_numpy(rng.integers(0, 2, (B, HQ, L, K)).astype(np.int32)).to(cuda)
    planes = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (B, HKV, L, K, W))
                              .astype(np.int32)).to(cuda)
    before = LAUNCHES["collision_words"]
    got = collision_words(qb, planes)
    assert LAUNCHES["collision_words"] == before + 1
    want = tbits.collision_words(qb.cpu(), planes.cpu())
    assert torch.equal(got.cpu(), want)
    if L > 1:
        faulty = collision_words(qb, plant_collisions(planes, qb, 1, 13, 40))
        assert int(faulty[1, 13, 40]) == -1
        assert not torch.equal(faulty.cpu(), want)


def _poison_past_length(planes, qb, length):
    """A copy of planes whose bits at or past each request's length (whole
    words, and the tail of the word that holds it) carry the first query
    head of each group's own bits (all ones where its bit is 1): read, they
    would make that head collide with every key in every table."""
    g = qb.shape[1] // planes.shape[1]
    keep = tbits.valid_words(length, planes.shape[-1])[:, None, None, None]
    pattern = -qb[:, ::g, :, :, None]                  # [B, Hkv, L, K, 1]
    return (planes & keep) | (pattern & ~keep)


@pytest.mark.parametrize("W", [77, 100])
@pytest.mark.parametrize("g", G128 + SCAN_NEW_GROUPS)
def test_cuda_collision_words_lengths_and_poison(cuda, g, W):
    """K 1, 10, 16 by L 1, 2, 3, 75, 150; lengths 0, 1, 31, 32, 33, a mid
    value and the full capacity. W = 77 takes cp.async for every tile (TMA
    cannot stride its rows), W = 100 TMA for whole tiles and cp.async for
    the ragged last one and each tile that holds a length; blocks of 1, 4,
    16 (the default) and 64 words. Without a length the kernel equals the
    plain scan bit for bit; with one it equals the plain scan ANDed with the
    valid words, on planes poisoned past each length (which the plain scan
    without a length shows would collide: request 0, of length 0, would be
    all ones in each group's first head), one launch a call."""
    from magicpig_tpu_torch.ops.kernels.collision_words import launch_scan

    rng = np.random.default_rng(26)
    hkv = 2
    lens = [0, 1, 31, 32, 33, 16 * W + 5, 32 * W]
    length = torch.tensor(lens, dtype=torch.int32, device=cuda)
    for K in (1, 10, 16):
        for L in (1, 2, 3, 75, 150):
            qb = torch.from_numpy(rng.integers(0, 2, (len(lens), g * hkv, L, K))
                                  .astype(np.int32)).to(cuda)
            planes = torch.from_numpy(rng.integers(
                -2**31, 2**31 - 1, (len(lens), hkv, L, K, W)).astype(np.int32)).to(cuda)
            poisoned = _poison_past_length(planes, qb, length)
            want = tbits.collision_words(qb.cpu(), planes.cpu())
            want_len = tbits.collision_words(qb.cpu(), planes.cpu(), length.cpu())
            assert torch.equal(want_len, want & tbits.valid_words(length.cpu(), W)[:, None])
            if L > 1:    # read, the poison collides (request 0: every word)
                seen = tbits.collision_words(qb.cpu(), poisoned.cpu())
                assert (seen[0, ::g] == -1).all() and not want_len[0].any()
            name = "collision_words" + ("" if g in G128 else f"_g{g}")
            before = LAUNCHES.get(name, 0)
            assert torch.equal(collision_words(qb, poisoned, length).cpu(), want_len)
            assert LAUNCHES[name] == before + 1
            for bw in (1, 4, 16, 64):
                assert torch.equal(launch_scan(qb, planes, None, bw).cpu(), want)
                assert torch.equal(launch_scan(qb, poisoned, length, bw).cpu(),
                                   want_len)


def _lsh_case(cuda, rng, int8, K, L, S=2048):
    q = _bf16(rng, 2, 32, 64, device=cuda)
    k = _bf16(rng, 2, 8, S, 64, device=cuda)
    v = _bf16(rng, 2, 8, S, 64, device=cuda)
    ks = vs = None
    kd = k.float()
    if int8:
        k, ks = quantize_rows(k)
        v, vs = quantize_rows(v)
        kd = dequantize_rows(k, ks, torch.float32)
    proj = torch.from_numpy(rng.standard_normal((64, K * L)).astype(np.float32)).to(cuda)
    planes = torch.stack([tbits.build_planes(kd[b].transpose(0, 1), proj, K)
                          for b in range(2)])
    qb = tbits.hash_bits(q, proj, K)
    length = torch.tensor([S, 1337], dtype=torch.int32, device=cuda)
    return q, k, v, kd.norm(dim=-1), planes, qb, length, ks, vs


@pytest.mark.parametrize("debias", ["exact", "poly", "none"])
@pytest.mark.parametrize("int8", [False, True])
def test_cuda_lsh_masked_attention_matches_plain(cuda, debias, int8):
    """Each form from the words of the whole capacity (the kernel ignores
    bits past the length), K=8, L=75."""
    rng = np.random.default_rng(18)
    K, L = 8, 75
    q, k, v, kn, planes, qb, length, ks, vs = _lsh_case(cuda, rng, int8, K, L)
    words = collision_words(qb, planes)
    args = (q, k, v, kn, words, length, K, L, ks, vs, debias)
    name = masked_launch_name(int8, debias)
    before = dict(LAUNCHES)
    o, l, c = lsh_masked_attention(*args)
    assert LAUNCHES[name] == before[name] + 1
    assert sum(LAUNCHES.values()) == sum(before.values()) + 1
    po, pl, pc = lsh_masked_attention_plain(*args)
    assert torch.equal(c, pc) and c.min() > 0
    _assert_within(o, po, rms_share=0.015)
    _assert_within(l, pl, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("int8", [False, True])
def test_cuda_two_stage_route_matches_fused_kernel(cuda, int8):
    """Odd L: lsh_decode takes the scan and the masked attend, whose
    counts equal the fused kernel's on the same inputs and whose outputs
    agree with it to the kernels' limits."""
    rng = np.random.default_rng(19)
    K, L = 8, 75
    q, k, v, kn, planes, qb, length, ks, vs = _lsh_case(cuda, rng, int8, K, L)
    args = (q, k, v, kn, planes, qb, length, K, L, ks, vs)
    before = dict(LAUNCHES)
    o, l, c = lsh_decode(*args)
    name = masked_launch_name(int8, "exact")
    assert LAUNCHES[name] == before[name] + 1
    assert LAUNCHES["collision_words"] == before["collision_words"] + 1
    assert sum(LAUNCHES.values()) == sum(before.values()) + 2
    fo, fl, fc = lsh_fused_decode(*args)
    assert torch.equal(c, fc)
    _assert_within(o, fo, rms_share=0.015)
    _assert_within(l, fl, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("int8", [True, False])
def test_cuda_exact_scores_matches_plain(cuda, int8):
    """Every token scored (no length mask, S not a multiple of 512)."""
    rng = np.random.default_rng(20)
    q = _bf16(rng, 2, 32, 64, device=cuda)
    k = _bf16(rng, 2, 8, 4032, 64, device=cuda)
    ks = None
    if int8:
        k, ks = quantize_rows(k)
    before = LAUNCHES["exact_scores"]
    got = exact_scores(q, k, ks)
    assert LAUNCHES["exact_scores"] == before + 1
    want = exact_scores_plain(q, k, ks)
    assert torch.isfinite(got).all()
    atol, rtol, _ = SCORE_TOL
    _assert_within(got, want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_cuda_block_scorer_edges(cuda, kind, g):
    """Lengths around every tile and block edge (0 included) over a
    2048-token capacity in 512-token blocks; K rows past each length hold
    NaN (bf16) or NaN scales (int8, packed int4), held to the plain version
    on the tail-zeroed cache. Both masked variants agree on the block max
    bit for bit, and the packed kernel equals the int8 one on the unpacked
    rows; the scores-only form matches on the zeroed cache (bf16, int8)."""
    _block_scorer_edges(cuda, kind, g, 64)


def _block_scorer_edges(cuda, kind, g, d):
    """`test_cuda_block_scorer_edges` at head dim d; each call counted
    under its form's name ("_d128" at d = 128)."""
    rng = np.random.default_rng(23)
    hkv, cap, bs = 2, 2048, 512
    lens = [0, 1, 63, 64, 65, 511, 512, 513, cap]
    q = _bf16(rng, len(lens), g * hkv, d, device=cuda)
    k = _bf16(rng, len(lens), hkv, cap, d, device=cuda)
    ks = None
    if kind != "bf16":
        k, ks = quantize_rows(k, bits=4 if kind == "int4" else 8)
    kz = k.clone()
    ksz = None if ks is None else ks.clone()
    for i, n in enumerate(lens):
        kz[i, :, n:] = 0
        if ks is None:
            k[i, :, n:] = float("nan")
        else:
            ksz[i, :, n:] = 0
            ks[i, :, n:] = float("nan")
    pk = pack_k4 if kind == "int4" else (lambda x: x)
    length = torch.tensor(lens, dtype=torch.int32, device=cuda)
    want_s, want_m = block_scores_plain(q, pk(kz), ksz, length, bs)
    suffix = ("_int4" if kind == "int4" else "") + head_suffix(d, g)
    before = dict(LAUNCHES)
    got_m = block_rank(q, pk(k), ks, length, bs)
    got_s, got_m2 = exact_scores_ranked(q, pk(k), ks, length, bs)
    assert LAUNCHES["block_rank" + suffix] == before.get("block_rank" + suffix, 0) + 1
    assert (LAUNCHES["exact_scores_ranked" + suffix]
            == before.get("exact_scores_ranked" + suffix, 0) + 1)
    atol, rtol, _ = SCORE_TOL
    for got, want in ((got_s, want_s), (got_m, want_m), (got_m2, want_m)):
        assert not torch.isnan(got).any()
        assert torch.equal(torch.isneginf(got), torch.isneginf(want))
        _assert_within(got, want, atol=atol, rtol=rtol)
    assert torch.equal(got_m, got_m2)
    if kind == "int4":
        int8_s, int8_m = exact_scores_ranked(q, k, ks, length, bs)
        assert torch.equal(got_s, int8_s) and torch.equal(got_m2, int8_m)
    else:
        _assert_within(exact_scores(q, kz, ksz), exact_scores_plain(q, kz, ksz),
                       atol=atol, rtol=rtol)


def _masked_edge_case(cuda, int8, g, seed=24, d=64):
    """B=6 over 2048 tokens, G heads a kv head (Hkv 2), head dim d, K=8,
    L=75: lengths not multiples of 32, one (33) ending before the second
    split and one 0; request 0 samples from its collision words with head 1
    sampling none, request 2 every key (more rows than a pass holds),
    request 3 none."""
    rng = np.random.default_rng(seed)
    B, S, HKV, K, L = 6, 2048, 2, 8, 75
    lens = [2048, 1337, 1000, 33, 0, 513]
    q = _bf16(rng, B, g * HKV, d, device=cuda)
    k = _bf16(rng, B, HKV, S, d, device=cuda)
    v = _bf16(rng, B, HKV, S, d, device=cuda)
    ks = vs = None
    kd = k.float()
    if int8:
        k, ks = quantize_rows(k)
        v, vs = quantize_rows(v)
        kd = dequantize_rows(k, ks, torch.float32)
    proj = torch.from_numpy(rng.standard_normal((d, K * L)).astype(np.float32)).to(cuda)
    planes = torch.stack([tbits.build_planes(kd[i].transpose(0, 1), proj, K)
                          for i in range(B)])
    qb = tbits.hash_bits(q, proj, K)
    words = collision_words(qb, planes)
    words[0, 1] = 0
    words[2] = -1
    words[3] = 0
    length = torch.tensor(lens, dtype=torch.int32, device=cuda)
    return (q, k, v, kd.norm(dim=-1), words, length, K, L, ks, vs), planes, qb


def _poison_unsampled(args, mask):
    """(poisoned args, zeroed args): every K/V row and norm that no head of
    its group samples (mask [B, Hq, S], valid tokens only) set to NaN (for
    int8 the scales and norms; the rows keep their bytes), and the same
    rows zeroed for the plain version."""
    q, k, v, kn, sel, length, K, L, ks, vs = args
    b, hkv, s = k.shape[:3]
    unsampled = ~mask.reshape(b, hkv, -1, s).any(dim=2)      # [B, Hkv, S]
    poisoned, zeroed = list(args), list(args)
    for i, x in ((1, k), (2, v), (3, kn), (8, ks), (9, vs)):
        if x is None:
            continue
        z = x.clone()
        z[unsampled] = 0
        zeroed[i] = z
        if x.dtype != torch.int8:
            p = x.clone()
            p[unsampled] = float("nan")
            poisoned[i] = p
    return tuple(poisoned), tuple(zeroed)


@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("debias", ["exact", "none"])
def test_cuda_lsh_masked_attention_edges(cuda, debias, int8, g):
    """The masked attend reads only the sampled rows: every unsampled K/V
    row and norm is NaN (int8: scales and norms), and the kernel is held to
    the plain version on the same inputs with those rows zeroed; counts
    exact, a head with no sample (0, -inf, 0). One launch per call, counted
    by the wrapper and by a captured graph's kernel nodes; a second call
    equal to the first
    (the merge tickets were reset); other split sizes give the same counts
    and outputs within the same limits."""
    _masked_edges(cuda, debias, int8, g, 64, _kernel_launches)


def _masked_edges(cuda, debias, int8, g, d, kernels_of,
                  splits=(32, 1024, 2048), rounding=False):
    """`test_cuda_lsh_masked_attention_edges` at head dim d, one kernel a
    call counted by `kernels_of` (three calls), at each of `splits`; with
    `rounding`, the outputs within the P.V operand's rounding bound too
    (`_output_check`)."""
    args, _, _ = _masked_edge_case(cuda, int8, g, d=d)
    args = (*args, debias)
    q, k, v, kn, words, length, K, L, ks, vs, _ = args
    s = k.shape[2]
    mask = tbits.unpack_words(words & tbits.valid_words(length, s // 32)[:, None], s)
    poisoned, zeroed = _poison_unsampled(args[:-1], mask)
    poisoned, zeroed = (*poisoned, debias), (*zeroed, debias)
    name = masked_launch_name(int8, debias, d, g)
    before = dict(LAUNCHES)
    o, l, c = lsh_masked_attention(*poisoned)
    assert LAUNCHES[name] == before.get(name, 0) + 1
    assert sum(LAUNCHES.values()) == sum(before.values()) + 1
    po, pl, pc = lsh_masked_attention_plain(*zeroed)
    check = _output_check(lsh_masked_attention_plain, zeroed, rounding)
    assert torch.equal(c, pc)
    assert torch.isfinite(o).all() and not torch.isnan(l).any()
    check(o, po)
    _assert_within(l, pl, atol=1e-4, rtol=1e-5)
    empty = pc == 0
    assert empty[0, 1] and empty[3].all() and empty[4].all()
    assert (o[empty] == 0).all() and torch.isneginf(l[empty]).all()
    assert (pc[2] == float(min(int(length[2]), s))).all()
    o2, l2, c2 = lsh_masked_attention(*poisoned)
    assert torch.equal(o, o2) and torch.equal(l, l2) and torch.equal(c, c2)
    assert kernels_of(lambda: lsh_masked_attention(*poisoned)) == 3
    for split in splits:
        so, sl, sc = launch_attend(name, "mp_lsh_masked_attention", q,
                                   poisoned[1], poisoned[2], poisoned[8],
                                   poisoned[9], poisoned[3], (words,), length,
                                   K, L, debias, split=split)
        assert torch.equal(sc, pc)
        check(so, po)
        _assert_within(sl, pl, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("int8", [False, True])
def test_cuda_lsh_fused_overflow_and_poison(cuda, int8):
    """The fused kernel at K=1, L=32 (nearly every key sampled: more rows
    than a pass holds) over ragged lengths, every unsampled row and norm
    poisoned, against the plain version on the zeroed rows; one launch per
    call; split sizes 32 to 2048 scan to the same counts."""
    rng = np.random.default_rng(25)
    B, S, K, L = 3, 2048, 1, 32
    q, k, v, kn, planes, qb, _, ks, vs = _lsh_case(cuda, rng, int8, K, L, S=S)
    first = lambda x: None if x is None else x[:1]  # noqa: E731
    rep = lambda x: None if x is None else x.repeat(B, *([1] * (x.dim() - 1)))  # noqa: E731
    q, k, v, kn, planes, qb, ks, vs = map(first, (q, k, v, kn, planes, qb, ks, vs))
    q, k, v, kn, planes, qb, ks, vs = map(rep, (q, k, v, kn, planes, qb, ks, vs))
    length = torch.tensor([2048, 1000, 31], dtype=torch.int32, device=cuda)
    mask = tbits.sampled_mask(qb, planes, length)
    assert mask.float().mean() > 0.4
    poisoned, zeroed = _poison_unsampled(
        (q, k, v, kn, None, length, K, L, ks, vs), mask)
    pick = lambda a: (*a[:4], planes, qb, length, K, L, a[8], a[9])  # noqa: E731
    name = "lsh_fused_decode" + ("_int8" if int8 else "")
    before = dict(LAUNCHES)
    o, l, c = lsh_fused_decode(*pick(poisoned))
    assert LAUNCHES[name] == before[name] + 1
    po, pl, pc = lsh_fused_decode_plain(*pick(zeroed))
    assert torch.equal(c, pc)
    assert torch.isfinite(o).all()
    _assert_within(o, po, rms_share=0.015)
    _assert_within(l, pl, atol=1e-4, rtol=1e-5)
    assert _kernel_launches(lambda: lsh_fused_decode(*pick(poisoned))) == 3
    p = pick(poisoned)
    for split in (32, 1024, 2048):
        so, sl, sc = launch_attend(name, "mp_lsh_fused_decode", p[0], p[1],
                                   p[2], p[9], p[10], p[3], (planes, qb),
                                   length, K, L, "exact", split=split)
        assert torch.equal(sc, pc)
        _assert_within(so, po, rms_share=0.015)


@pytest.mark.parametrize("int8", [False, True])
def test_cuda_lsh_fused_lengths(cuda, int8):
    """G = 8, K = 16, L = 40 over a 2048-token capacity at lengths 0, 1, 31,
    33, 1017 (inside the tail word of the second 512-token split) and 2048,
    keys planted near each head's query around every length so that the
    sample is not empty; the plane bits past each length poisoned (the
    scan's tile that holds a length reads only its valid words). Counts
    exact and outputs within the limits against the plain version on the
    clean planes, at the default split and at 32 (one-word tiles) and 1024
    tokens."""
    rng = np.random.default_rng(27)
    hkv, g, S, K, L = 2, 8, 2048, 16, 40
    lens = [0, 1, 31, 33, 1017, 2048]
    B = len(lens)
    q = _bf16(rng, B, g * hkv, 64, device=cuda)
    kc = rng.standard_normal((B, hkv, S, 64)).astype(np.float32)
    qg = q.float().cpu().numpy().reshape(B, hkv, g, 64)
    for t in [*range(0, 40), *range(990, 1030), *range(2000, 2048)]:
        kc[:, :, t] = qg[:, :, t % g] + 0.2 * kc[:, :, t]
    k = torch.from_numpy(kc).to(cuda, torch.bfloat16)
    v = _bf16(rng, B, hkv, S, 64, device=cuda)
    ks = vs = None
    kd = k.float()
    if int8:
        k, ks = quantize_rows(k)
        v, vs = quantize_rows(v)
        kd = dequantize_rows(k, ks, torch.float32)
    proj = torch.from_numpy(rng.standard_normal((64, K * L)).astype(np.float32)).to(cuda)
    planes = torch.stack([tbits.build_planes(kd[i].transpose(0, 1), proj, K)
                          for i in range(B)])
    qb = tbits.hash_bits(q, proj, K)
    length = torch.tensor(lens, dtype=torch.int32, device=cuda)
    poisoned = _poison_past_length(planes, qb, length)
    kn = kd.norm(dim=-1)
    args = (q, k, v, kn, poisoned, qb, length, K, L, ks, vs)
    name = "lsh_fused_decode" + ("_int8" if int8 else "")
    before = dict(LAUNCHES)
    o, l, c = lsh_fused_decode(*args)
    assert LAUNCHES[name] == before[name] + 1
    assert sum(LAUNCHES.values()) == sum(before.values()) + 1
    po, pl, pc = lsh_fused_decode_plain(q, k, v, kn, planes, qb, length, K, L,
                                        ks, vs)
    assert torch.equal(c, pc)
    assert (pc[0] == 0).all() and (pc[4:] > 0).any(dim=-1).all()
    _assert_within(o, po, rms_share=0.015)
    _assert_within(l, pl, atol=1e-4, rtol=1e-5)
    for split in (32, 1024):
        so, sl, sc = launch_attend(name, "mp_lsh_fused_decode", q, k, v, ks, vs,
                                   kn, (poisoned, qb), length, K, L, "exact",
                                   split=split)
        assert torch.equal(sc, pc)
        _assert_within(so, po, rms_share=0.015)
        _assert_within(sl, pl, atol=1e-4, rtol=1e-5)


def _poison_past(x, lens, dim=2):
    """(x with the entries at or past each request's length along `dim`
    NaN, x with them 0); int8 entries are left as they are (their scales
    carry the poison)."""
    zeroed, poisoned = x.clone(), x.clone()
    for i, n in enumerate(lens):
        zeroed[i].narrow(dim - 1, n, x.shape[dim] - n).zero_()
        if x.is_floating_point():
            poisoned[i].narrow(dim - 1, n, x.shape[dim] - n).fill_(float("nan"))
    return poisoned, zeroed


@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_cuda_attend_chunk_edges(cuda, kind, g):
    """The rescore-attend and the block-attend at lengths around every
    chunk and block edge (0 included) over a 2048-token capacity in
    512-token blocks; each request selects all four blocks (those wholly
    past its length too) in a random order, then an id of -1 and one past
    the last block, which select nothing. K/V rows and scales past each
    length hold NaN (scales only, for int8 and packed int4 rows), held to
    the plain versions on the zeroed cache and the valid ids; at chunks of
    64 to 512 tokens, the rescore equals the block-attend on the scorer's
    stored scores bit for bit, packed int4 equals int8 on the unpacked rows
    bit for bit, a call launches one kernel, and a second call equals the
    first (the merge tickets were reset)."""
    _attend_chunk_edges(cuda, kind, g, 64, _kernel_launches)


def _attend_chunk_edges(cuda, kind, g, d, kernels_of):
    """`test_cuda_attend_chunk_edges` at head dim d, one kernel a call
    counted by `kernels_of` (three calls). bf16 K and V rows of a 512-token
    chunk at d = 128 do not fit a CUDA block of an exact instance: that
    rescore raises ValueError, and the block-attend at that chunk is held
    to the plain version alone. The general tile reads `chunk` as the
    tokens a CUDA block takes of the selected blocks (`tile_plan`)."""
    rng = np.random.default_rng(25)
    hkv, cap, bs = 2, 2048, 512
    lens = [0, 1, 63, 64, 65, 127, 128, 129, 511, 512, 513, 1337]
    b = len(lens)
    q = _bf16(rng, b, g * hkv, d, device=cuda)
    k = _bf16(rng, b, hkv, cap, d, device=cuda)
    v = _bf16(rng, b, hkv, cap, d, device=cuda)
    length = torch.tensor(lens, dtype=torch.int32, device=cuda)
    ks = vs = ks_z = vs_z = None
    if kind != "bf16":
        k, ks = quantize_rows(k, bits=4 if kind == "int4" else 8)
        v, vs = quantize_rows(v)
        ks, ks_z = _poison_past(ks, lens)
        vs, vs_z = _poison_past(vs, lens)
    k, k_z = _poison_past(k, lens)
    v, v_z = _poison_past(v, lens)
    pk = pack_k4 if kind == "int4" else (lambda x: x)
    perm = np.stack([rng.permutation(4) for _ in range(b * hkv)]).reshape(b, hkv, 4)
    extra = np.broadcast_to(np.array([-1, 4]), (b, hkv, 2))
    ids = torch.from_numpy(np.concatenate([perm, extra], axis=-1).astype(np.int32)).to(cuda)
    valid = ids[..., :4].contiguous()
    want, want_l = rescore_attend_plain(q, valid, pk(k_z), ks_z, v_z, vs_z,
                                        length, bs)
    scores, _ = exact_scores_ranked(q, pk(k), ks, length, bs)
    assert not torch.isnan(scores).any()
    args = (q, ids, pk(k), ks, v, vs, length, bs)
    # (The general tile takes any multiple of 64 tokens a CUDA block.)
    exact = _lib.exact_group(g, d)
    for chunk in (64, 128, 256, 512):
        if kind == "bf16" and d == 128 and chunk == 512 and exact:
            with pytest.raises(ValueError):
                launch_rescore_attend(*args, chunk)
            bo, bl = launch_block_attend(scores, ids, v, vs, bs, chunk)
            _assert_within(bo, want, rms_share=0.015)
            _assert_within(bl, want_l, atol=1e-4, rtol=1e-5)
            continue
        o, l = launch_rescore_attend(*args, chunk)
        assert torch.isfinite(o).all() and not torch.isnan(l).any()
        _assert_within(o, want, rms_share=0.015)
        _assert_within(l, want_l, atol=1e-4, rtol=1e-5)
        assert torch.equal(torch.isneginf(l), torch.isneginf(want_l))
        o2, l2 = launch_rescore_attend(*args, chunk)
        assert torch.equal(o2, o) and torch.equal(l2, l)
        bo, bl = launch_block_attend(scores, ids, v, vs, bs, chunk)
        assert torch.equal(bo, o) and torch.equal(bl, l)
        if kind == "int4":
            io, il = launch_rescore_attend(q, ids, k, ks, v, vs, length, bs,
                                           chunk)
            assert torch.equal(io, o) and torch.equal(il, l)
    suffix = head_suffix(d, g)
    name = "rescore_attend" + ("_int4" if kind == "int4" else "") + suffix
    before = dict(LAUNCHES)
    rescore_attend(*args)
    block_attend(scores, ids, v, vs, bs)
    assert LAUNCHES[name] == before.get(name, 0) + 1
    assert (LAUNCHES["block_attend" + suffix]
            == before.get("block_attend" + suffix, 0) + 1)
    assert sum(LAUNCHES.values()) == sum(before.values()) + 2
    assert kernels_of(lambda: rescore_attend(*args)) == 3
    assert kernels_of(lambda: block_attend(scores, ids, v, vs, bs)) == 3


# The int4 products of the 1B's decode step with fused weights (q|k|v, o,
# gate|up, down, lm_head), as (kin, out).
SERVED_W4 = [(2048, 3072), (2048, 2048), (2048, 16384), (8192, 2048),
             (2048, 128256)]


# The same unfused products at a model rank's shapes at 2 model ranks (q,
# k, v, gate and up at half their columns, o and down at half their input
# rows, the lm_head at half the vocabulary), as (kin, out).
RANK_W4 = [(2048, 1024), (2048, 256), (1024, 2048), (2048, 4096),
           (4096, 2048), (2048, 64128)]


@pytest.mark.parametrize("kin,out", SERVED_W4 + RANK_W4)
@pytest.mark.parametrize("M", [1, 2, 3, 7, 8, 9, 64])
def test_cuda_w4_matmul_served_shapes(cuda, M, kin, out):
    """Each served shape at M from 1 to 64 (one 8-row slice ragged, two,
    eight): within `W4_TOL` of the plain version, and a second call equal
    to the first bit for bit (the K-splits summed in a fixed order)."""
    rng = np.random.default_rng(26)
    x = _bf16(rng, M, kin, device=cuda)
    w = tllama.quantize_weight4(_bf16(rng, kin, out, device=cuda) * kin ** -0.5)
    y = w4_matmul(x, w.q, w.scale)
    atol, rtol, rms_share = W4_TOL
    _assert_within(y, w4_matmul_plain(x, w.q, w.scale), atol=atol, rtol=rtol,
                   rms_share=rms_share)
    assert torch.equal(w4_matmul(x, w.q, w.scale), y)


def _graph_kernel_nodes(fn) -> int:
    """Kernel nodes of a CUDA graph captured from one call of `fn` (read
    through the driver API; the profiler drops kernels when it records
    many)."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    return graph_kernel_nodes(graph)


@pytest.mark.parametrize("kin,out", SERVED_W4)
def test_cuda_w4_matmul_one_kernel_a_call(cuda, kin, out):
    """One kernel a call at each served shape and M of 1, 2, 9 and 64 (the
    K-splits summed in the same launch): the kernel nodes of a CUDA graph
    captured from the calls."""
    rng = np.random.default_rng(27)
    w = tllama.quantize_weight4(_bf16(rng, kin, out, device=cuda) * kin ** -0.5)
    xs = [_bf16(rng, m, kin, device=cuda) for m in (1, 2, 9, 64)]
    for x in xs:                           # first calls set kernel attributes
        w4_matmul(x, w.q, w.scale)
    assert _graph_kernel_nodes(lambda: [w4_matmul(x, w.q, w.scale)
                                        for x in xs]) == len(xs)


# -- head dim 128 (Llama-3.1-8B): prefill, bf16 decode, the fused LSH kernel's
# bf16 exact form, at every group size the forms take -------------------------


@pytest.mark.parametrize("sq", [1, 129, 1000])
@pytest.mark.parametrize("g", G128)
def test_cuda_d128_flash_prefill_edges(cuda, g, sq):
    """The prefill edges at d = 128 (two column halves a tile): a q_offset,
    length < Skv, a window, the LSE; cache rows past each length NaN, held
    to the plain version on the tail-zeroed cache; counted as
    "flash_prefill_d128"."""
    _prefill_edges(cuda, g, sq, 128)


@pytest.mark.parametrize("sq", [1, 129, 1000])
@pytest.mark.parametrize("g", [1, 4, 6])
@pytest.mark.parametrize("d", [16, 32])
def test_cuda_small_d_flash_prefill_edges(cuda, d, g, sq):
    """The prefill edges at head dims 16 and 32 (one 64-column TMA box a
    tile, its columns past d zero-filled; S over d / 16 k-steps), counted
    as "flash_prefill_d16" / "_d32"."""
    _prefill_edges(cuda, g, sq, d)


def _prefill_edges(cuda, g, sq, d):
    rng = np.random.default_rng(31)
    hkv, offs = 2, [200, 50]
    skv = sq + 237
    lens = [200 + sq, 50 + max(sq - 3, 1)]
    q = _bf16(rng, 2, sq, g * hkv, d, device=cuda)
    k = _bf16(rng, 2, skv, hkv, d, device=cuda)
    v = _bf16(rng, 2, skv, hkv, d, device=cuda)
    kz, vz = k.clone(), v.clone()
    for b, n in enumerate(lens):
        k[b, n:] = float("nan")
        v[b, n:] = float("nan")
        kz[b, n:] = 0
        vz[b, n:] = 0
    length = torch.tensor(lens, dtype=torch.int32, device=cuda)
    offset = torch.tensor(offs, dtype=torch.int32, device=cuda)
    name = f"flash_prefill_d{d}"
    for window in (None, 77):
        before = dict(LAUNCHES)
        o, l = flash_prefill(q, k, v, length, offset, window=window,
                             return_lse=True)
        assert LAUNCHES[name] == before[name] + 1
        assert sum(LAUNCHES.values()) == sum(before.values()) + 1
        po, pl = tatt.flash_prefill(q, kz, vz, length, offset, window=window,
                                    return_lse=True)
        assert torch.isfinite(o).all() and not torch.isnan(l).any()
        _assert_within(o, po, atol=4e-3, rtol=1e-2)
        _assert_within(l, pl, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("capacity", [384, 16384])
@pytest.mark.parametrize("g", G128)
def test_cuda_d128_flash_decode_edges(cuda, g, capacity):
    """bf16 decode at d = 128: ragged and zero lengths around every tile
    and split edge, rows past each length NaN, held to the plain version on
    the tail-zeroed cache; one kernel a call (a captured graph's kernel
    nodes), counted as "flash_decode_d128", and a second call equal to the
    first."""
    rng = np.random.default_rng(32)
    hkv, d = 2, 128
    lens = [min(n, capacity) for n in (0, 1, 63, 64, 65, 511, 512, 513, capacity)]
    b = len(lens)
    q = _bf16(rng, b, g * hkv, d, device=cuda)
    k = _bf16(rng, b, hkv, capacity, d, device=cuda)
    v = _bf16(rng, b, hkv, capacity, d, device=cuda)
    kz, vz = k.clone(), v.clone()
    for i, n in enumerate(lens):
        kz[i, :, n:] = 0
        vz[i, :, n:] = 0
        k[i, :, n:] = float("nan")
        v[i, :, n:] = float("nan")
    length = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = dict(LAUNCHES)
    o, l = flash_decode(q, k, v, length)
    assert LAUNCHES["flash_decode_d128"] == before["flash_decode_d128"] + 1
    assert sum(LAUNCHES.values()) == sum(before.values()) + 1
    po, pl = tatt.full_decode(q, kz, vz, length)
    assert torch.isfinite(o).all() and not torch.isnan(l).any()
    _assert_within(o, po, rms_share=0.015)
    _assert_within(l, pl, atol=1e-4, rtol=1e-5)
    assert (o[0] == 0).all() and torch.isneginf(l[0]).all()
    o2, l2 = flash_decode(q, k, v, length)
    assert torch.equal(o, o2) and torch.equal(l, l2)
    assert _graph_kernel_nodes(
        lambda: [flash_decode(q, k, v, length) for _ in range(3)]) == 3


@pytest.mark.parametrize("K,L", [(10, 150), (1, 32)])
@pytest.mark.parametrize("g", G128)
def test_cuda_d128_lsh_fused_matches_plain(cuda, g, K, L):
    """The fused kernel's bf16 exact form at d = 128 over 2048 tokens at
    lengths 2048, 1337 and 0, keys planted near each head's query; at K=1,
    L=32 nearly every key is sampled (more rows than a pass holds). Every
    row and norm that no head samples is NaN; held to the plain version on
    the zeroed rows, counts exact, counted as "lsh_fused_decode_d128", one
    kernel a call (the kernel nodes of a captured CUDA graph: the profiler
    drops kernels late in a long session); splits of 32 and 2048 tokens
    give the same counts."""
    _lsh_fused_d128_case(cuda, g, K, L, False, "exact", planted=True)


@pytest.mark.parametrize("form", [(False, "poly"), (False, "none"),
                                  (True, "exact"), (True, "poly"),
                                  (True, "none")])
@pytest.mark.parametrize("g", G128)
def test_cuda_d128_lsh_fused_forms_match_plain(cuda, g, form):
    """The fused kernel's other forms at d = 128 (bf16 poly and none; int8
    K/V with the exact, poly and none debias: `bench.py`'s lsh mode runs
    int8 exact), K=10, L=150, as the bf16 exact case: every unsampled row's
    norm and V (bf16) or scales (int8) NaN, counts exact, one kernel a
    call, splits of 2048 tokens and the default; the poly and none forms
    move the output away from the exact form's. Random keys, as the d = 64
    forms
    test takes: the exact case's planted keys (cosine ~0.96 with their
    head's query) make the none form coincide with the exact one, and sit
    where the float32 Horner evaluation of the poly fit (coefficients up to
    3.2e4) moves by up to 2.2e-3 between neighbouring floats of the cosine,
    which the kernel and the plain version compute an ulp apart (their
    dots are summed in another order). At 32-token splits each split
    rounds its P.V operand against its own max, where the plain version
    rounds against the head's: a dominant key's bf16 p then moves by up
    to an ulp, and with ~40 sampled keys a head (2% of 2048) one output
    value came to 1.08x its limit of 0.015 of the rms (1 of 3072 values,
    int8 poly, G = 4); the planted bf16 exact case, whose many samples
    average that out, runs the 32-token split at d = 128 for every form
    (one template)."""
    int8, debias = form
    _lsh_fused_d128_case(cuda, g, 10, 150, int8, debias, planted=False,
                         splits=(2048,))


def _lsh_fused_d128_case(cuda, g, K, L, int8, debias, planted,
                         splits=(32, 2048), d=128, rounding=False,
                         heads=None, repeat=False):
    """The fused kernel at head dim d against its plain version (with
    `rounding`, within the P.V operand's rounding bound too); `planted`
    keys near the queries of every head, or of `heads` only; with
    `repeat`, a second call equal to the first."""
    rng = np.random.default_rng(33)
    hkv, S = 2, 2048
    lens = [S, 1337, 0]
    B = len(lens)
    q = _bf16(rng, B, g * hkv, d, device=cuda)
    kc = rng.standard_normal((B, hkv, S, d)).astype(np.float32)
    qg = q.float().cpu().numpy().reshape(B, hkv, g, d)
    heads = list(range(g)) if heads is None else heads
    for i, t in enumerate(range(0, S, 7)) if planted else ():
        kc[:, :, t] = qg[:, :, heads[i % len(heads)]] + 0.3 * kc[:, :, t]
    k = torch.from_numpy(kc).to(cuda, torch.bfloat16)
    v = _bf16(rng, B, hkv, S, d, device=cuda)
    ks = vs = None
    kd = k.float()
    if int8:
        k, ks = quantize_rows(k)
        v, vs = quantize_rows(v)
        kd = dequantize_rows(k, ks, torch.float32)
    kn = kd.norm(dim=-1)
    proj = torch.from_numpy(rng.standard_normal((d, K * L)).astype(np.float32)).to(cuda)
    planes = torch.stack([tbits.build_planes(kd[i].transpose(0, 1), proj, K)
                          for i in range(B)])
    qb = tbits.hash_bits(q, proj, K)
    length = torch.tensor(lens, dtype=torch.int32, device=cuda)
    mask = tbits.sampled_mask(qb, planes, length)
    poisoned, zeroed = _poison_unsampled(
        (q, k, v, kn, None, length, K, L, ks, vs), mask)
    pick = lambda a: (*a[:4], planes, qb, length, K, L, a[8], a[9],  # noqa: E731
                      debias)
    name = fused_launch_name(int8, debias, d, g)
    before = dict(LAUNCHES)
    o, l, c = lsh_fused_decode(*pick(poisoned))
    assert LAUNCHES[name] == before.get(name, 0) + 1
    assert sum(LAUNCHES.values()) == sum(before.values()) + 1
    po, pl, pc = lsh_fused_decode_plain(*pick(zeroed))
    check = _output_check(lsh_fused_decode_plain, pick(zeroed), rounding)
    assert torch.equal(c, pc) and (pc[:2] > 0).all() and (pc[2] == 0).all()
    assert torch.isfinite(o).all()
    check(o, po)
    _assert_within(l, pl, atol=1e-4, rtol=1e-5)
    if repeat:
        assert all(torch.equal(x, y) for x, y in zip(
            (o, l, c), lsh_fused_decode(*pick(poisoned))))
    if debias != "exact":
        exact = lsh_fused_decode(*pick(poisoned)[:-1])[0]
        assert (exact - o).abs().max() > 1e-3      # the form does something
    assert _graph_kernel_nodes(
        lambda: [lsh_fused_decode(*pick(poisoned)) for _ in range(3)]) == 3
    p = pick(poisoned)
    for split in splits:
        so, sl, sc = launch_attend(name, "mp_lsh_fused_decode", p[0], p[1],
                                   p[2], p[9], p[10], p[3], (planes, qb),
                                   length, K, L, debias, split=split)
        assert torch.equal(sc, pc)
        check(so, po)
        _assert_within(sl, pl, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("capacity", [384, 16384])
@pytest.mark.parametrize("g", G128)
def test_cuda_d128_flash_decode_int8_edges(cuda, g, capacity):
    """int8 decode at d = 128 (full_int8's and block_topk4's dense layers):
    ragged and zero lengths around every tile and split edge, the scales
    past each length NaN, held to the plain version on the tail-zeroed
    cache; one kernel a call (a captured graph's kernel nodes), counted as
    "flash_decode_int8_d128", and a second call equal to the first."""
    rng = np.random.default_rng(35)
    hkv, d = 2, 128
    lens = [min(n, capacity) for n in (0, 1, 63, 64, 65, 511, 512, 513, capacity)]
    b = len(lens)
    q = _bf16(rng, b, g * hkv, d, device=cuda)
    k, ks = quantize_rows(_bf16(rng, b, hkv, capacity, d, device=cuda))
    v, vs = quantize_rows(_bf16(rng, b, hkv, capacity, d, device=cuda))
    kz, vz, ksz, vsz = k.clone(), v.clone(), ks.clone(), vs.clone()
    for i, n in enumerate(lens):
        for x in (kz, vz, ksz, vsz):
            x[i, :, n:] = 0
        ks[i, :, n:] = float("nan")
        vs[i, :, n:] = float("nan")
    length = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = dict(LAUNCHES)
    o, l = flash_decode(q, k, v, length, ks, vs)
    assert (LAUNCHES["flash_decode_int8_d128"]
            == before["flash_decode_int8_d128"] + 1)
    assert sum(LAUNCHES.values()) == sum(before.values()) + 1
    po, pl = tatt.full_decode(q, kz, vz, length, ksz, vsz)
    assert torch.isfinite(o).all() and not torch.isnan(l).any()
    _assert_within(o, po, rms_share=0.015)
    _assert_within(l, pl, atol=1e-4, rtol=1e-5)
    assert (o[0] == 0).all() and torch.isneginf(l[0]).all()
    o2, l2 = flash_decode(q, k, v, length, ks, vs)
    assert torch.equal(o, o2) and torch.equal(l, l2)
    assert _graph_kernel_nodes(
        lambda: [flash_decode(q, k, v, length, ks, vs) for _ in range(3)]) == 3


@pytest.mark.parametrize("g", G128)
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_cuda_d128_block_scorer_edges(cuda, kind, g):
    """`test_cuda_block_scorer_edges` at d = 128: bf16 (256-byte rows, two
    ring stages in dynamic shared memory), int8 and packed int4 K (byte j
    holding channels j and j + 64), each counted under its "_d128" name;
    packed int4 equals int8 on the unpacked rows bit for bit."""
    _block_scorer_edges(cuda, kind, g, 128)


@pytest.mark.parametrize("g", G128)
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_cuda_d128_attend_chunk_edges(cuda, kind, g):
    """`test_cuda_attend_chunk_edges` at d = 128 (two P.V m-tiles a warp,
    a merge batch of half the partials): the lengths, ids of -1 and past
    the last block, NaN past each length, chunks of 64 to 512 tokens, the
    two pipelines bit for bit, packed int4 equal to int8; one kernel a call
    by a captured graph's kernel nodes."""
    _attend_chunk_edges(cuda, kind, g, 128, _kernel_launches)


@pytest.mark.parametrize("g", G128)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("debias", ["exact", "poly", "none"])
def test_cuda_d128_lsh_masked_attention_edges(cuda, debias, int8, g):
    """`test_cuda_lsh_masked_attention_edges` at d = 128 (the odd-L route of
    Llama-3.1-8B and Llama-3.2-3B), each of the six forms, counted as
    "lsh_masked_attention[_int8][_poly|_none]_d128": every unsampled row
    and norm NaN, counts exact, empty heads (0, -inf, 0), one kernel a call
    (a captured graph's kernel nodes), a second call equal to the first,
    splits of 32 (bf16), 1024 and 2048 tokens besides the default. int8 at
    32-token splits: each split rounds its P.V operand, p times the V
    scale, against its own max where the plain version rounds against the
    head's (the fused kernel's d = 128 forms test states the same), and
    the outputs came to 1.09-1.57x the limit of 0.015 of the rms on 1 to
    8 of their 1536-12288 values in 9 of the 15 int8 cases, the largest
    each time in request 5 (513 tokens: 17 splits, the last of one token);
    the split the wrapper uses (512 for int8 at d = 128), 1024 and 2048
    hold."""
    _masked_edges(cuda, debias, int8, g, 128, lambda fn: _graph_kernel_nodes(
        lambda: [fn() for _ in range(3)]),
        splits=(1024, 2048) if int8 else (32, 1024, 2048))


@pytest.mark.parametrize("capacity", [384, 16384])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("d,g", NEW_FORMS, ids=NEW_FORM_IDS)
def test_cuda_new_forms_flash_decode_edges(cuda, d, g, int8, capacity):
    """The decode edges (`test_cuda_flash_decode_edges`) in the general
    tile's forms and at head dims 16 and 32: ragged and zero lengths around
    every tile and split edge, rows (bf16) or scales (int8) past each
    length NaN, held to the plain version on the tail-zeroed cache; one
    kernel a call (a captured graph's kernel nodes), counted under the
    form's name ("_d16", "_g6", ...), and a second call equal to the first
    (every sub-group's ticket was reset)."""
    rng = np.random.default_rng(36)
    hkv = 2
    lens = [min(n, capacity) for n in (0, 1, 63, 64, 65, 511, 512, 513, capacity)]
    b = len(lens)
    q = _bf16(rng, b, g * hkv, d, device=cuda)
    k = _bf16(rng, b, hkv, capacity, d, device=cuda)
    v = _bf16(rng, b, hkv, capacity, d, device=cuda)
    ks = vs = None
    if int8:
        k, ks = quantize_rows(k)
        v, vs = quantize_rows(v)
    zeroed = [x.clone() if x is not None else None for x in (k, v, ks, vs)]
    for i, n in enumerate(lens):
        for x in zeroed:
            if x is not None:
                x[i, :, n:] = 0
        for x in ((ks, vs) if int8 else (k, v)):
            x[i, :, n:] = float("nan")
    length = torch.tensor(lens, dtype=torch.int32, device=cuda)
    name = decode_launch_name(int8, d, g)
    before = dict(LAUNCHES)
    o, l = flash_decode(q, k, v, length, ks, vs)
    assert LAUNCHES[name] == before.get(name, 0) + 1
    assert sum(LAUNCHES.values()) == sum(before.values()) + 1
    kz, vz, ksz, vsz = zeroed
    po, pl = tatt.full_decode(q, kz, vz, length, ksz, vsz)
    assert torch.isfinite(o).all() and not torch.isnan(l).any()
    _assert_within(o, po, rms_share=0.015)
    _assert_within(l, pl, atol=1e-4, rtol=1e-5)
    assert (o[0] == 0).all() and torch.isneginf(l[0]).all()
    o2, l2 = flash_decode(q, k, v, length, ks, vs)
    assert torch.equal(o, o2) and torch.equal(l, l2)
    assert _kernel_launches(lambda: flash_decode(q, k, v, length, ks, vs)) == 3


@pytest.mark.parametrize("K,L", [(10, 150), (1, 32)])
@pytest.mark.parametrize("d,g", NEW_FORMS, ids=NEW_FORM_IDS)
def test_cuda_new_forms_lsh_fused_matches_plain(cuda, d, g, K, L):
    """`test_cuda_d128_lsh_fused_matches_plain` in the general tile's forms
    and at head dims 16 and 32: keys planted near each head's query, every
    unsampled row and norm NaN, counts exact, one kernel a call, a second
    call equal to the first, splits of 32 and 2048 tokens; at K=1, L=32
    more rows than a pass holds."""
    _lsh_fused_d128_case(cuda, g, K, L, False, "exact", planted=True, d=d,
                         rounding=True, repeat=True)


# The fused kernel's other forms: at one new group size a head dim and at
# each small head dim (the general tile's instances read the debias form
# from their arguments, one instance a K/V type and head dim).
FUSED_FORM_CASES = [(64, 6), (128, 16), (16, 4), (32, 4)]


@pytest.mark.parametrize("form", [(False, "poly"), (False, "none"),
                                  (True, "exact"), (True, "poly"),
                                  (True, "none")])
@pytest.mark.parametrize("d,g", FUSED_FORM_CASES,
                         ids=[f"d{d}-g{g}" for d, g in FUSED_FORM_CASES])
def test_cuda_new_forms_lsh_fused_forms_match_plain(cuda, d, g, form):
    """`test_cuda_d128_lsh_fused_forms_match_plain` in new forms: random
    keys, K=10, L=150, each of the five other forms."""
    int8, debias = form
    _lsh_fused_d128_case(cuda, g, 10, 150, int8, debias, planted=False,
                         splits=(2048,), d=d, rounding=True)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("debias", ["exact", "poly", "none"])
@pytest.mark.parametrize("d,g", NEW_FORMS, ids=NEW_FORM_IDS)
def test_cuda_new_forms_lsh_masked_attention_edges(cuda, d, g, debias, int8):
    """`test_cuda_lsh_masked_attention_edges` in the general tile's forms
    and at head dims 16 and 32, each of the six forms (the wrapper's split
    and 1024 and 2048 tokens besides; 32 for bf16), the outputs within 0.015
    of the rms plus the P.V operand's rounding bound (`_output_check`)."""
    _masked_edges(cuda, debias, int8, g, d, _kernel_launches,
                  splits=(1024, 2048) if int8 else (32, 1024, 2048),
                  rounding=True)


# (head dim, group size, K kind) of the block kernels' new forms: packed
# int4 K at head dims 64 and 128 only, where the JAX package packs K.
BLOCK_NEW_CASES = [(d, g, kind) for d, g in NEW_FORMS
                   for kind in ("bf16", "int8", "int4")
                   if kind != "int4" or d >= 64]
BLOCK_NEW_IDS = [f"d{d}-g{g}-{kind}" for d, g, kind in BLOCK_NEW_CASES]


@pytest.mark.parametrize("d,g,kind", BLOCK_NEW_CASES, ids=BLOCK_NEW_IDS)
def test_cuda_new_forms_block_scorer_edges(cuda, d, g, kind):
    """`test_cuda_block_scorer_edges` in the general tile's forms (a block
    scores up to 16 heads of its kv head; above 16 the blocks of heads
    combine their block maxes, which span the group) and at head dims 16
    and 32 (rows read as 64 channels, zero past d)."""
    _block_scorer_edges(cuda, kind, g, d)


@pytest.mark.parametrize("d,g,kind", BLOCK_NEW_CASES, ids=BLOCK_NEW_IDS)
def test_cuda_new_forms_attend_chunk_edges(cuda, d, g, kind):
    """`test_cuda_attend_chunk_edges` in the general tile's forms (a block
    attends up to 16 heads over its share of the selected blocks, `chunk`
    tokens of them, and the blocks merge by tickets) and at head dims 16
    and 32: lengths, ids of -1 and past the last block, NaN past each
    length, 64 to 512 tokens a CUDA block, the two pipelines bit for bit,
    packed int4 equal to int8; one kernel a call."""
    _attend_chunk_edges(cuda, kind, g, d, _kernel_launches)


# The edges of the decode and LSH kernels' 16-head tile: the last head of
# a whole block (Llama-3.1-405B's 16), of the third block (StarCoder-15B's
# 48), and of a block of 4 after a block of 16 (20 heads).
TILE_EDGE_FORMS = [(128, 16), (128, 48), (64, 20)]
TILE_EDGE_IDS = [f"d{d}-g{g}" for d, g in TILE_EDGE_FORMS]


def _tile_last_heads(g: int) -> list:
    """The last head of each 16-head block of a group of g."""
    return [h for h in range(g) if h % 16 == 15 or h == g - 1]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("d,g", TILE_EDGE_FORMS, ids=TILE_EDGE_IDS)
def test_cuda_head_tile_last_heads_flash_decode(cuda, d, g, int8):
    """flash_decode's general tile at the last head of each block: a key
    equal to that head's query (and a V row of 4s) inside each request's
    rows [start, length), so that those heads' outputs lean on one row of
    one block's last M row; rows before each start and past each length
    NaN (bf16) or NaN scales (int8). Held to the plain version on the
    zeroed cache; the planted heads' outputs show the planted row; a second
    call equals the first."""
    rng = np.random.default_rng(40 + g)
    hkv, cap = 2, 4096
    lens = [4096, 3001, 700, 65]
    starts = [1000, 0, 64, 1]
    b = len(lens)
    q = _bf16(rng, b, g * hkv, d, device=cuda)
    kc = rng.standard_normal((b, hkv, cap, d)).astype(np.float32)
    vc = rng.standard_normal((b, hkv, cap, d)).astype(np.float32)
    qn = q.float().cpu().numpy().reshape(b, hkv, g, d)
    last = _tile_last_heads(g)
    for i, (lo, n) in enumerate(zip(starts, lens)):
        for j, h in enumerate(last):
            t = lo + (37 * (j + 1)) % (n - lo)
            kc[i, :, t] = 2.0 * qn[i, :, h]
            vc[i, :, t] = 4.0
    k = torch.from_numpy(kc).to(cuda, torch.bfloat16)
    v = torch.from_numpy(vc).to(cuda, torch.bfloat16)
    ks = vs = None
    if int8:
        k, ks = quantize_rows(k)
        v, vs = quantize_rows(v)
    zeroed = [x.clone() if x is not None else None for x in (k, v, ks, vs)]
    for i, (lo, n) in enumerate(zip(starts, lens)):
        for rows in (slice(0, lo), slice(n, cap)):
            for x in zeroed:
                if x is not None:
                    x[i, :, rows] = 0
            for x in ((ks, vs) if int8 else (k, v)):
                x[i, :, rows] = float("nan")
    length = torch.tensor(lens, dtype=torch.int32, device=cuda)
    start = torch.tensor(starts, dtype=torch.int32, device=cuda)
    name = decode_launch_name(int8, d, g)
    before = dict(LAUNCHES)
    o, l = flash_decode(q, k, v, length, ks, vs, start)
    assert LAUNCHES[name] == before.get(name, 0) + 1
    assert sum(LAUNCHES.values()) == sum(before.values()) + 1
    po, pl = tatt.full_decode(q, *zeroed[:2], length, *zeroed[2:], start)
    assert torch.isfinite(o).all() and not torch.isnan(l).any()
    _assert_within(o, po, rms_share=0.015)
    _assert_within(l, pl, atol=1e-4, rtol=1e-5)
    heads = [kh * g + h for kh in range(hkv) for h in last]
    assert (po[:, heads].mean(dim=-1) > 2.0).all()     # the planted row
    o2, l2 = flash_decode(q, k, v, length, ks, vs, start)
    assert torch.equal(o, o2) and torch.equal(l, l2)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("d,g", TILE_EDGE_FORMS, ids=TILE_EDGE_IDS)
def test_cuda_head_tile_last_heads_lsh_fused(cuda, d, g, int8):
    """The fused LSH kernel's general tile with keys planted near the
    queries of the last head of each block only (`_tile_last_heads`):
    those heads sample many rows, their neighbours few; every unsampled row
    and norm NaN, counts exact, a second call equal to the first, splits
    of 32 and 2048 tokens besides the wrapper's."""
    _lsh_fused_d128_case(cuda, g, 10, 150, int8, "exact", planted=True,
                         d=d, rounding=True, heads=_tile_last_heads(g),
                         repeat=True)


# The block kernels' 16-head tile at the same edges, int8 and packed int4 K.
BLOCK_TILE_CASES = [(d, g, kind) for d, g in TILE_EDGE_FORMS
                    for kind in ("int8", "int4")]
BLOCK_TILE_IDS = [f"d{d}-g{g}-{kind}" for d, g, kind in BLOCK_TILE_CASES]


def _head_block_faults(want, hkv: int, g: int) -> list:
    """Planted faults of the block kernels' 16-head tile on a [B, Hq, ...]
    output: the second block of heads given the first block's output (a
    block that read the wrong heads), or with one block the last head given
    its neighbour's."""
    w = want.unflatten(1, (hkv, g))
    f = w.clone()
    if g > 16:
        n = min(16, g - 16)
        f[:, :, 16:16 + n] = w[:, :, :n]
    else:
        f[:, :, g - 1] = w[:, :, g - 2]
    return f.flatten(1, 2)


@pytest.mark.parametrize("d,g,kind", BLOCK_TILE_CASES, ids=BLOCK_TILE_IDS)
def test_cuda_head_tile_last_heads_block_kernels(cuda, d, g, kind):
    """The block scorer's and both attends' 16-head tile at the last head
    of each block: a key of 4 times that head's query in a ranking block of
    its own, so that the block ranks first for that head alone; K rows past
    each length NaN (NaN scales for int8 and packed int4 K) and V scales
    past it NaN. The scorer's block maxes and scores, the rescore's (out,
    lse) over the block_rank's top blocks and the block-attend's from the
    scorer's stored scores held to the plain versions on the zeroed cache;
    the block-attend equals the rescore bit for bit, a second call the
    first; the planted fault of `_head_block_faults` fails each tolerance."""
    rng = np.random.default_rng(50 + g)
    hkv, cap, bs, n_sel = 2, 4096, 512, 4
    lens = [4096, 2900]
    b = len(lens)
    q = _bf16(rng, b, g * hkv, d, device=cuda)
    kc = rng.standard_normal((b, hkv, cap, d)).astype(np.float32)
    qn = q.float().cpu().numpy().reshape(b, hkv, g, d)
    last = _tile_last_heads(g)
    for j, h in enumerate(last):
        for i, n in enumerate(lens):          # ranking block 1 + j, in range
            t = (1 + j) * bs + (97 * (j + 1)) % bs
            assert t < n
            kc[i, :, t] = 4.0 * qn[i, :, h] * np.sqrt(d)
    k = torch.from_numpy(kc).to(cuda, torch.bfloat16)
    v = _bf16(rng, b, hkv, cap, d, device=cuda)
    kq, ks = quantize_rows(k, bits=4 if kind == "int4" else 8)
    vq, vs = quantize_rows(v)
    ks, ks_z = _poison_past(ks, lens)
    vs, vs_z = _poison_past(vs, lens)
    kq_z = _poison_past(kq, lens)[1]
    vq_z = _poison_past(vq, lens)[1]
    pk = pack_k4 if kind == "int4" else (lambda x: x)
    length = torch.tensor(lens, dtype=torch.int32, device=cuda)
    atol, rtol, _ = SCORE_TOL

    # The scorer: block maxes and scores; the planted blocks rank first for
    # the last heads (their block maxes are theirs).
    want_s, want_m = block_scores_plain(q, pk(kq_z), ks_z, length, bs)
    got_m = block_rank(q, pk(kq), ks, length, bs)
    got_s, got_m2 = exact_scores_ranked(q, pk(kq), ks, length, bs)
    for got, want in ((got_s, want_s), (got_m, want_m), (got_m2, want_m)):
        assert not torch.isnan(got).any()
        assert torch.equal(torch.isneginf(got), torch.isneginf(want))
        _assert_within(got, want, atol=atol, rtol=rtol)
    assert torch.equal(got_m, got_m2)
    top = want_s.amax(dim=-1)                     # [B, Hkv, G]: each head's max
    for j, h in enumerate(last):
        assert (want_m[:, :, 1 + j] == top[:, :, h]).all()    # head h's own
    faulty_s = _head_block_faults(want_s.flatten(1, 2), hkv, g)
    with pytest.raises(AssertionError):
        _assert_within(faulty_s, want_s.flatten(1, 2), atol=atol, rtol=rtol)
    s2, m2 = exact_scores_ranked(q, pk(kq), ks, length, bs)
    assert torch.equal(s2, got_s) and torch.equal(m2, got_m2)

    # Both attends over the blocks block_rank picked (the planted ones).
    ids = torch.topk(got_m, n_sel, dim=-1).indices.to(torch.int32)
    for j in range(min(n_sel, len(last))):
        assert (ids == 1 + j).any(dim=-1).all()
    want, want_l = rescore_attend_plain(q, ids, pk(kq_z), ks_z, vq_z, vs_z,
                                        length, bs)
    o, l = rescore_attend(q, ids, pk(kq), ks, vq, vs, length, bs)
    assert torch.isfinite(o).all() and not torch.isnan(l).any()
    _assert_within(o, want, rms_share=0.015)
    _assert_within(l, want_l, atol=1e-4, rtol=1e-5)
    with pytest.raises(AssertionError):
        _assert_within(_head_block_faults(want, hkv, g), want, rms_share=0.015)
    bo, bl = block_attend(got_s, ids, vq, vs, bs)
    assert torch.equal(bo, o) and torch.equal(bl, l)
    bwant, bwant_l = block_attend_plain(got_s, ids, vq_z, vs_z, bs)
    _assert_within(bo, bwant, rms_share=0.015)
    _assert_within(bl, bwant_l, atol=1e-4, rtol=1e-5)
    o2, l2 = rescore_attend(q, ids, pk(kq), ks, vq, vs, length, bs)
    bo2, bl2 = block_attend(got_s, ids, vq, vs, bs)
    assert torch.equal(o2, o) and torch.equal(l2, l)
    assert torch.equal(bo2, bo) and torch.equal(bl2, bl)


def test_cuda_d128_other_forms_raise(cuda):
    """What the kernels still refuse raises ValueError before any launch: a
    head dim that does not divide 128 (96, as the JAX package's prefill
    refuses it) or is above 128 (256), in every kernel with a head dim (the
    prefill, the decode in bf16 and int8, both LSH kernels, the scorer and
    both attends), packed int4 K below head dim 64 in the scorer and the
    rescore, and query heads that are not a multiple of the kv heads (6
    over 4) in those and in the collision scan."""
    rng = np.random.default_rng(34)
    S, K, L, bs = 512, 4, 9, 512
    length = torch.tensor([S], dtype=torch.int32, device=cuda)
    before = dict(LAUNCHES)
    for d, hq, hkv in ((96, 8, 2), (256, 8, 2), (64, 6, 4), (128, 6, 4)):
        ids = torch.zeros((1, hkv, 1), dtype=torch.int32, device=cuda)
        q = _bf16(rng, 1, hq, d, device=cuda)
        k = _bf16(rng, 1, hkv, S, d, device=cuda)
        v = _bf16(rng, 1, hkv, S, d, device=cuda)
        kq, ks = quantize_rows(k)
        vq, vs = quantize_rows(v)
        kn = k.float().norm(dim=-1)
        proj = torch.from_numpy(rng.standard_normal((d, K * L))
                                .astype(np.float32)).to(cuda)
        planes = tbits.build_planes(k[0].float().transpose(0, 1), proj, K)[None]
        qb = tbits.hash_bits(q, proj, K)
        words = torch.zeros((1, hq, S // 32), dtype=torch.int32, device=cuda)
        for kk, vv, ksc, vsc in ((k, v, None, None), (kq, vq, ks, vs)):
            with pytest.raises(ValueError):
                lsh_masked_attention(q, kk, vv, kn, words, length, K, L, ksc,
                                     vsc)
            with pytest.raises(ValueError):
                flash_decode(q, kk, vv, length, ksc, vsc)
            with pytest.raises(ValueError):
                lsh_fused_decode(q, kk, vv, kn, planes, qb, length, K, L + 1,
                                 ksc, vsc)
        with pytest.raises(ValueError):
            flash_prefill(q[:, None], k.transpose(1, 2).contiguous(),
                          v.transpose(1, 2).contiguous(), length)
        with pytest.raises(ValueError):
            block_rank(q, kq, ks, length, bs)
        with pytest.raises(ValueError):
            exact_scores_ranked(q, k, None, length, bs)
        with pytest.raises(ValueError):
            rescore_attend(q, ids, kq, ks, vq, vs, length, bs)
        if hq % hkv:         # the stored scores' shape gives the group
            with pytest.raises(ValueError):
                collision_words(qb, planes)
        else:
            scores = torch.zeros((1, hkv, hq // hkv, S), device=cuda)
            with pytest.raises(ValueError):
                block_attend(scores, ids, v, None, bs)
    for d in (16, 32):       # packed int4 K below head dim 64
        q = _bf16(rng, 1, 8, d, device=cuda)
        k4, ks4 = quantize_rows(_bf16(rng, 1, 2, S, d, device=cuda), bits=4)
        vq, vs = quantize_rows(_bf16(rng, 1, 2, S, d, device=cuda))
        ids = torch.zeros((1, 2, 1), dtype=torch.int32, device=cuda)
        with pytest.raises(ValueError, match="int4"):
            block_rank(q, pack_k4(k4), ks4, length, bs)
        with pytest.raises(ValueError, match="int4"):
            rescore_attend(q, ids, pack_k4(k4), ks4, vq, vs, length, bs)
    assert LAUNCHES == before


BWD_TOL = 1e-2   # of each gradient's largest |value|: bf16 p and dS
# (name, batch, sq, skv, q_offset, kv_len, window, (hq, hkv, d)): the
# needle trainer's shape, a window, and a ragged query span at offsets (one
# request sees no key at all) with and without a window, at 8/4 heads of
# 64; then the other forms the kernel takes, at small spans: Llama-3.2-3B's
# 24/8 heads of 128 (G = 3), Llama-3.1-405B's 128/8 (G = 16), SmolLM2-360M's
# 15/5 of 64 (G = 3), llama-tiny's 8/2 heads at d 16 and 32, and the ragged
# windowed span at d 16 and at the 3B's heads.
_RAGGED = (4, 300, 1024, [700, 0, 500, 10], [1000, 300, 777, 0])
BWD_FORMS = [
    ("needle", 32, 1024, 1024, [0], [1024], None, (8, 4, 64)),
    ("window", 4, 1024, 1024, [0], [1024], 200, (8, 4, 64)),
    ("offset", *_RAGGED, None, (8, 4, 64)),
    ("offset_window", *_RAGGED, 150, (8, 4, 64)),
    ("d128_g3", 2, 512, 512, [0], [512], None, (24, 8, 128)),
    ("d128_g16", 1, 256, 256, [0], [256], None, (128, 8, 128)),
    ("d64_g3", 2, 384, 384, [0], [384], None, (15, 5, 64)),
    ("d16", 4, 256, 256, [0], [256], None, (8, 2, 16)),
    ("d32", 4, 256, 256, [0], [256], None, (8, 2, 32)),
    ("d16_offset_window", *_RAGGED, 150, (8, 2, 16)),
    ("d128_g3_offset_window", *_RAGGED, 150, (24, 8, 128)),
]


@pytest.mark.parametrize("form", BWD_FORMS, ids=[f[0] for f in BWD_FORMS])
def test_cuda_flash_prefill_bwd_matches_plain(cuda, form):
    """The kernel against the plain backward on the same bf16 inputs, K and
    V rows past each length NaN for the kernel (zeros for the plain
    version); bit-equal repeats; dK and dV rows past each length 0."""
    _, b, sq, skv, off, kvl, window, (hq, hkv, d) = form
    rng = np.random.default_rng(21)
    q, do = (_bf16(rng, b, sq, hq, d, device=cuda) for _ in range(2))
    k, v = (_bf16(rng, b, skv, hkv, d, device=cuda) for _ in range(2))
    off = torch.tensor(off * (b // len(off)), dtype=torch.int32, device=cuda)
    kvl = torch.tensor(kvl * (b // len(kvl)), dtype=torch.int32, device=cuda)
    past = torch.arange(skv, device=cuda)[None, :] >= kvl[:, None].long()
    k0, v0 = (x.masked_fill(past[..., None, None], 0.0) for x in (k, v))
    kn, vn = (x.masked_fill(past[..., None, None], float("nan"))
              for x in (k, v))
    out, lse = flash_prefill(q, k0, v0, kvl, off, window=window,
                             return_lse=True)
    before = dict(LAUNCHES)
    got = flash_prefill_bwd(q, kn, vn, out, lse, do, off, kvl, window=window)
    again = flash_prefill_bwd(q, kn, vn, out, lse, do, off, kvl, window=window)
    torch.cuda.synchronize()
    name = bwd_launch_name(d)
    assert LAUNCHES == {**before, name: before[name] + 2}
    want = tatt.flash_prefill_train_backward(q, k0, v0, out, lse, do, off,
                                             kvl, 128, window=window)
    for name, g, a, w in zip("qkv", got, again, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert torch.equal(g, a), f"d{name} differs between runs"
        w = w.float()
        err = float((g - w).abs().max())
        assert err <= BWD_TOL * float(w.abs().max()), (name, err)
    # Keys past each length get no gradient.
    for i, n in enumerate(kvl.tolist()):
        assert not got[1][i, n:].any() and not got[2][i, n:].any()


@pytest.mark.parametrize("heads", [(8, 4, 64), (24, 8, 128)],
                         ids=["d64_g2", "d128_g3"])
def test_cuda_flash_prefill_train_autograd(cuda, heads):
    """The Function on f32 leaves: forward by the prefill kernel, backward
    by flash_prefill_bwd (one launch each), gradients in f32 against the
    plain Function on the CPU; at 8/4 heads of 64 and at Llama-3.2-3B's
    24/8 heads of 128."""
    hq, hkv, d = heads
    rng = np.random.default_rng(22)
    leaves = [rng.standard_normal(s).astype(np.float32)
              for s in ((2, 256, hq, d), (2, 256, hkv, d), (2, 256, hkv, d))]
    fwd_name, bwd_name = prefill_launch_name(d), bwd_launch_name(d)
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        q, k, v = (torch.from_numpy(x).to(dev).requires_grad_()
                   for x in leaves)
        bwd, fwd = LAUNCHES[bwd_name], LAUNCHES[fwd_name]
        out = flash_prefill_train(q, k, v, 0, 256, block_k=128)
        assert out.dtype == torch.float32
        out.square().sum().backward()
        if dev.type == "cuda":
            assert LAUNCHES[bwd_name] == bwd + 1
            assert LAUNCHES[fwd_name] == fwd + 1
        grads[dev.type] = [x.grad.cpu() for x in (q, k, v)]
    for g, w in zip(grads["cuda"], grads["cpu"]):
        assert g.dtype == torch.float32
        assert float((g - w).abs().max()) <= 2e-2 * float(w.abs().max())


def test_cuda_flash_prefill_bwd_other_forms_raise(cuda):
    """Head dims 96 and 256 (not dividing 128, or above it), query heads not
    a multiple of the kv heads, and f32 inputs raise ValueError before any
    launch; the forms that raised before (8/4 heads of 128, 6/2 and 5/1 of
    64) now run."""
    rng = np.random.default_rng(23)
    before = dict(LAUNCHES)
    for hq, hkv, d in ((8, 4, 96), (8, 4, 256), (6, 4, 64), (5, 2, 128)):
        q = _bf16(rng, 1, 64, hq, d, device=cuda)
        k = _bf16(rng, 1, 64, hkv, d, device=cuda)
        lse = torch.zeros((1, 64, hq), device=cuda)
        with pytest.raises(ValueError):
            flash_prefill_bwd(q, k, k, q, lse, q, 0, 64)
    q = _bf16(rng, 1, 64, 8, 64, device=cuda)
    k = _bf16(rng, 1, 64, 4, 64, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_prefill_bwd(q.float(), k, k, q, torch.zeros((1, 64, 8),
                                                          device=cuda),
                          q, 0, 64)
    assert LAUNCHES == before
    for hq, hkv, d in ((8, 4, 128), (6, 2, 64), (5, 1, 64)):
        q = _bf16(rng, 1, 64, hq, d, device=cuda)
        k = _bf16(rng, 1, 64, hkv, d, device=cuda)
        out, lse = flash_prefill(q, k, k, torch.full((1,), 64, dtype=torch.int32,
                                                     device=cuda),
                                 return_lse=True)
        grads = flash_prefill_bwd(q, k, k, out, lse, q, 0, 64)
        assert all(bool(torch.isfinite(g).all()) for g in grads)

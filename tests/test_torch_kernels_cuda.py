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
and the top-k block ids from them exactly.
"""

import numpy as np
import pytest
import torch

from magicpig_tpu_torch.ops import attention as tatt
from magicpig_tpu_torch.ops import bitcodes as tbits
from magicpig_tpu_torch.ops.kernels import (
    LAUNCHES,
    block_attend,
    block_rank,
    exact_scores_ranked,
    flash_decode,
    flash_prefill,
    lsh_fused_decode,
    rescore_attend,
)
from magicpig_tpu_torch.ops.kernels.block_attend import block_attend_plain
from magicpig_tpu_torch.ops.kernels.block_score import block_scores_plain
from magicpig_tpu_torch.ops.kernels.lsh_fused import lsh_fused_decode_plain
from magicpig_tpu_torch.ops.kernels.rescore_attend import rescore_attend_plain
from magicpig_tpu_torch.ops.quant import quantize_rows

SCORE_TOL = (1e-5, 1e-5, 0.0)


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
    # The two pipelines agree: the rescore sees the stored scores' numbers.
    ro, rl = rescore_attend(q, ids, k, ks, v, vs, length, 512)
    torch.testing.assert_close(ro, o, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(rl, l, atol=1e-6, rtol=1e-6)

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Each test takes the `cuda` fixture and skips without a card. This file
imports no JAX, so it also runs on the card machine, which has none:

    python3 -m pytest --noconftest tests/test_torch_kernels_cuda.py

Tolerances follow the rule `chip_smoke.py` holds the kernels to at full
size (its `TOL`, where each is explained): |kernel - plain| <= atol + rtol
* |plain| + rms_share * rms(plain). bf16 prefill outputs atol 4e-3, rtol
1e-2; f32 decode and LSH outputs 0.015 of the plain output's rms; lse atol
1e-4, rtol 1e-5; sampled counts exactly.
"""

import numpy as np
import pytest
import torch

from magicpig_tpu_torch.ops import attention as tatt
from magicpig_tpu_torch.ops import bitcodes as tbits
from magicpig_tpu_torch.ops.kernels import (
    LAUNCHES,
    flash_decode,
    flash_prefill,
    lsh_fused_decode,
)
from magicpig_tpu_torch.ops.kernels.lsh_fused import lsh_fused_decode_plain


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

"""The port's ring prefill (`parallel/ring.py`) against the JAX package's
`ring_prefill` and its single-device `flash_prefill` oracle, in both
layouts, over rings of 2 and 4 ranks (`parallel/launch.py`: gloo on the
CPU, one spawn for the file), with B = 2 and grouped heads. Each rank
holds its tokens in the layout's order; their outputs, put back in global
order, must match to 2e-3 (`tests/test_ring.py`'s tolerance).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from magicpig_tpu_torch.parallel.launch import launch
from magicpig_tpu_torch.parallel.ring import (
    chunk_order,
    shard_tokens,
    unshard_tokens,
)

TOL = 2e-3
B, S, HQ, HKV, D = 2, 256, 8, 2, 32
CASES = [(layout, n) for layout in ("contiguous", "zigzag") for n in (2, 4)]


def _qkv():
    rng = np.random.default_rng(3)
    return tuple(rng.standard_normal((B, S, h, D)).astype(np.float32)
                 for h in (HQ, HKV, HKV))


def _ring_ranks(rank: int, qkv, cases):
    """Every case's local output of this rank (None outside its ring)."""
    from magicpig_tpu_torch.parallel.mesh import make_mesh
    from magicpig_tpu_torch.parallel.ring import ring_prefill

    out = {}
    q, k, v = (torch.from_numpy(a) for a in qkv)
    for layout, n in cases:
        mesh = make_mesh(n, 1)
        if mesh.get_coordinate() is None:
            out[(layout, n)] = None
            continue
        local = [shard_tokens(a, n, rank, layout) for a in (q, k, v)]
        out[(layout, n)] = ring_prefill(*local, mesh, "data", layout).numpy()
    return out


def _jax_outputs():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from magicpig_tpu.ops.attention import flash_prefill
    from magicpig_tpu.parallel.ring import ring_prefill

    q, k, v = (jnp.asarray(a) for a in _qkv())
    out = {"oracle": np.asarray(flash_prefill(
        q, k, v, q_offset=jnp.int32(0), kv_len=jnp.int32(S), block_k=128))}
    for layout, n in CASES:
        mesh = Mesh(np.asarray(jax.devices()[:n]), ("seq",))
        out[(layout, n)] = np.asarray(ring_prefill(q, k, v, mesh, block_k=64,
                                                   layout=layout))
    return out


@pytest.fixture(scope="module")
def outputs():
    """(the port's outputs in global order, the JAX outputs); the ranks
    run while JAX computes."""
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch, _ring_ranks, 4, _qkv(), CASES,
                            device="cpu")
        jax_out = _jax_outputs()
        ranks = ranks.result()
    port = {case: unshard_tokens(
        [torch.from_numpy(r[case]) for r in ranks[:case[1]]],
        case[0]).numpy() for case in CASES}
    return port, jax_out


@pytest.mark.parametrize("layout,n", CASES)
def test_ring_prefill_matches_jax(outputs, layout, n):
    ring_outputs, jax_outputs = outputs
    got = ring_outputs[(layout, n)]
    np.testing.assert_allclose(got, jax_outputs[(layout, n)], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, jax_outputs["oracle"], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("layout,n", CASES)
def test_layout_round_trip(layout, n):
    x = torch.arange(2 * 4 * n * 3).reshape(2, 4 * n, 3)
    parts = [shard_tokens(x, n, r, layout) for r in range(n)]
    assert torch.equal(unshard_tokens(parts, layout), x)
    order = chunk_order(n, layout)
    assert sorted(order) == list(range(len(order)))
    if layout == "zigzag":      # rank r holds chunks r and 2n - 1 - r
        assert order[:2] == [0, 2 * n - 1]

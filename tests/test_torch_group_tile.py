"""The decode-side kernels' general tile on the CPU: how many blocks of query
heads a kv head takes and how many merge tickets the wrappers hand each
kernel family, and the plain versions of the two kernels whose tile holds 16
heads (flash decode, the fused LSH decode) against the JAX package's Pallas
kernels (interpret mode) at group sizes of one and three 16-head blocks.

Blocks: the decode, both LSH kernels, the block scorer and both attends of
the selected blocks take up to 16 query heads of a kv head a block
(`_lib.HEAD_TILE`, `kHeadTile` in csrc/common.cuh), the collision scan up
to 8 (`_lib.GROUP_TILE`, `kGroupTile`); the exact instances one block a kv
head. Each block of heads merges its splits by its own ticket, so a
family's tickets must number B * Hkv * blocks. The attends' general tile
splits each (request, kv head, block of heads)'s selected blocks by the SM
count (`tile_plan`).

Parity: Llama-3.1-405B's 16 query heads over one kv head and StarCoder-15B's
48 (three 16-head blocks), head dim 128, small caches. Tolerances those of
the JAX package's own kernel tests (`ROADMAP.md`): bf16 inputs 2e-3 (flash
decode) and 3e-3 (the LSH attend: the Pallas kernel's arccos polynomial and
collision weight, `tests/test_torch_kernels.py`), int8 K/V 5e-3, sampled
counts exactly.
"""

import importlib
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicpig_tpu.ops import bitcodes as jbits
from magicpig_tpu.ops.pallas.decode import flash_decode as j_flash_decode
from magicpig_tpu.ops.pallas.lsh_decode import lsh_fused_decode as j_lsh_fused_decode
from magicpig_tpu.ops.pallas.lsh_fused import lsh_fused_attention2
from magicpig_tpu_torch.ops import bitcodes as tbits
from magicpig_tpu_torch.ops.kernels import (
    LAUNCHES,
    _lib,
    flash_decode,
    lsh_fused_decode,
)
from magicpig_tpu_torch.ops.kernels.block_attend import (
    ATTEND_STAGE,
    FILL_STAGES,
    merge_buffers,
    tile_plan,
)
from magicpig_tpu_torch.ops.quant import dequantize_rows, quantize_rows

# The wrapper modules (the package exports their functions under the same
# names).
decode_mod = importlib.import_module("magicpig_tpu_torch.ops.kernels.flash_decode")
masked_mod = importlib.import_module("magicpig_tpu_torch.ops.kernels.lsh_masked")

CSRC = pathlib.Path(decode_mod.__file__).resolve().parents[2] / "csrc"
BF16_DECODE_TOL = 2e-3
BF16_LSH_TOL = 3e-3
INT8_TOL = 5e-3
# (group size, head dim, blocks of the 16-head tile, of the 8-head tile).
BLOCK_CASES = [(1, 64, 1, 1), (2, 128, 1, 1), (3, 128, 1, 1), (4, 64, 1, 1),
               (8, 128, 1, 1), (3, 64, 1, 1), (5, 128, 1, 1), (7, 64, 1, 1),
               (16, 128, 1, 2), (20, 64, 2, 3), (48, 128, 3, 6),
               (4, 16, 1, 1), (16, 32, 1, 2), (17, 32, 2, 3)]


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


def _cxx_constant(name: str, source: str = "common.cuh") -> int:
    text = (CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


# -- blocks of heads and tickets ------------------------------------------------


def test_tiles_match_the_cuda_sources():
    """The Python tiles are the C++ ones, and each kernel family's general
    tile is instantiated at its own: the decode, LSH and block kernels at
    kHeadTile (the block kernels' tiles in block_score.cuh and
    chunk_attend.cuh, launched from their *_part.cu sources), the scan at
    kGroupTile; the attends' stage is the Python plan's."""
    assert _lib.HEAD_TILE == _cxx_constant("kHeadTile") == 16
    assert _lib.GROUP_TILE == _cxx_constant("kGroupTile") == 8
    assert "MP_DECODE_TYPES(mp::kHeadTile," in (CSRC / "flash_decode.cu").read_text()
    assert "launch_lsh<kHeadTile," in (CSRC / "lsh_common.cuh").read_text()
    for src in ("block_score.cuh", "chunk_attend.cuh"):
        assert "Heads<kHeadTile, true>" in (CSRC / src).read_text()
    assert "launch_tile<" in (CSRC / "block_score_part.cu").read_text()
    assert "launch_chunk_tile<" in (CSRC / "chunk_attend_part.cu").read_text()
    assert "mp::kGroupTile" in (CSRC / "collision_words.cu").read_text()
    text = (CSRC / "chunk_attend.cuh").read_text()
    assert "constexpr int kAttTile = 16 * kAttRT;" in text
    assert "constexpr int kAttFill = kAttWarps * kAttTile;" in text
    assert ATTEND_STAGE == 16 * _cxx_constant("kAttRT", "chunk_attend.cuh")
    assert FILL_STAGES == _cxx_constant("kAttWarps", "chunk_attend.cuh")


@pytest.mark.parametrize("g,d,head_blocks,group_blocks", BLOCK_CASES)
def test_head_blocks_per_family(g, d, head_blocks, group_blocks):
    assert _lib.head_blocks(g, d, _lib.HEAD_TILE) == head_blocks
    assert _lib.head_blocks(g, d, _lib.GROUP_TILE) == group_blocks
    exact = _lib.exact_group(g, d)
    assert decode_mod.tile_heads(g, d) == (0 if exact else min(g, 16))


@pytest.fixture
def fresh_tickets(monkeypatch):
    """Empty ticket and SM-count tables (the SM count of a device that is
    not a card set by hand), so that the next call allocates exactly what
    it asks for."""
    monkeypatch.setattr(decode_mod, "_tickets", {})
    monkeypatch.setattr(decode_mod, "_outgrown", [])
    monkeypatch.setattr(decode_mod, "_num_sms", {})

    def seed(device):
        decode_mod._num_sms[torch.device(device)] = 132
    return seed


@pytest.mark.parametrize("g,d,head_blocks,group_blocks", BLOCK_CASES)
def test_tickets_for_per_family(fresh_tickets, g, d, head_blocks,
                                group_blocks):
    fresh_tickets("cpu")
    b, hkv = 3, 2
    tickets, sms = decode_mod.tickets_for(torch.device("cpu"), b, g * hkv,
                                          hkv, d, _lib.HEAD_TILE)
    assert sms == 132 and tickets.numel() == b * hkv * head_blocks
    assert (tickets == 0).all()
    more, _ = decode_mod.tickets_for(torch.device("cpu"), b, g * hkv, hkv, d,
                                     _lib.GROUP_TILE)
    assert more.numel() >= b * hkv * group_blocks


def _launched(monkeypatch):
    """Stub `_lib.launch`: record each call's arguments, launch nothing."""
    calls = []
    monkeypatch.setattr(_lib, "launch",
                        lambda name, entry, device, *args: calls.append(
                            (name, entry, args)))
    return calls


@pytest.mark.parametrize("g", [16, 48, 20])
def test_wrappers_take_their_familys_tickets(monkeypatch, fresh_tickets, g):
    """flash_decode, the LSH launcher and the block attends hand their
    kernel B * Hkv * ceil(G / 16) tickets (meta tensors: the wrappers'
    set-up runs, the stubbed launch records it)."""
    meta = torch.device("meta")
    fresh_tickets(meta)
    calls = _launched(monkeypatch)
    monkeypatch.setattr(decode_mod, "check_decode_inputs", lambda *a: None)
    b, hkv, d, s = 2, 2, 128, 1024
    q = torch.empty((b, g * hkv, d), dtype=torch.bfloat16, device=meta)
    k = torch.empty((b, hkv, s, d), dtype=torch.bfloat16, device=meta)
    length = torch.empty((b,), dtype=torch.int32, device=meta)
    decode_mod.flash_decode(q, k, k, length)
    name, entry, args = calls[-1]
    assert entry == "mp_flash_decode" and name == f"flash_decode_d128_g{g}"
    assert args[9].numel() == b * hkv * -(-g // 16)      # the tickets
    monkeypatch.setattr(decode_mod, "_tickets", {})
    norm = torch.empty((b, hkv, s), dtype=torch.float32, device=meta)
    words = torch.empty((b, g * hkv, s // 32), dtype=torch.int32, device=meta)
    masked_mod.launch_attend("lsh_masked_attention", "mp_lsh_masked_attention",
                             q, k, k, None, None, norm, (words,), length, 8,
                             75, "exact")
    assert calls[-1][2][11].numel() == b * hkv * -(-g // 16)  # tickets
    monkeypatch.setattr(decode_mod, "_tickets", {})
    tickets = merge_buffers(4, b, g * hkv, hkv, d, meta)[2]
    assert tickets.numel() == b * hkv * -(-g // 16)
    assert not [c for c in calls if c[1] not in ("mp_flash_decode",
                                                 "mp_lsh_masked_attention")]


@pytest.mark.parametrize("nsel,block_size,blocks,sms,want", [
    (11, 512, 10, 132, (512, 11)),    # SmolLM2-360M's phase-2 shape: 110 blocks
    (11, 512, 16, 132, (768, 8)),     # the 405B's: 128 blocks, one an SM
    (3, 512, 10, 132, (256, 6)),      # a serve's 3 blocks: one fill a block
    (3, 512, 16, 132, (256, 6)),
    (11, 512, 48, 132, (2816, 2)),    # 48 triples: two pieces each
    (3, 512, 400, 132, (1536, 1)),    # more triples than SMs: one a triple
    (1, 64, 2, 132, (64, 1)),         # one unit in all
    (11, 512, 10, 66, (1024, 6)),     # half the SMs: half the blocks
])
def test_tile_plan(nsel, block_size, blocks, sms, want):
    """The attends' general tile: each (request, kv head, block of heads)
    list of selected blocks cut into about sms // blocks pieces of whole
    fills (four 64-token units), the pieces covering the list; the grid at
    most one block an SM where a triple gets more than one piece."""
    chunk, pieces = tile_plan(nsel, block_size, blocks, sms)
    assert (chunk, pieces) == want
    tokens = nsel * block_size
    assert chunk % ATTEND_STAGE == 0 and (pieces - 1) * chunk < tokens <= pieces * chunk
    fill = FILL_STAGES * ATTEND_STAGE
    assert chunk % fill == 0 or chunk == tokens
    if pieces > 1 and chunk > fill:
        assert pieces * blocks <= sms
    assert tile_plan(nsel, block_size, blocks, sms, 256)[0] == min(256, tokens)
    with pytest.raises(ValueError):
        tile_plan(nsel, block_size, blocks, sms, 96)


# -- plain versions against the Pallas kernels at 16 and 48 heads a kv head -----


@pytest.mark.parametrize("G", [16, 48])
@pytest.mark.parametrize("int8", [False, True])
def test_flash_decode_plain_matches_pallas_head_tiles(G, int8):
    """Request 1 ends mid-block (37 tokens), request 2 is empty."""
    B, HKV, S, D = 3, 1, 256, 128
    rng = np.random.default_rng(60 + G)
    q = _bf16_values(rng, (B, HKV * G, D))
    length = np.asarray([S, 37, 0], np.int32)
    k = _bf16_values(rng, (B, HKV, S, D))
    v = _bf16_values(rng, (B, HKV, S, D))
    before = dict(LAUNCHES)
    if int8:
        kq, ks = quantize_rows(_t(k))
        vq, vs = quantize_rows(_t(v))
        jo, jl = j_flash_decode(jnp.asarray(q), jnp.asarray(_np(kq)),
                                jnp.asarray(_np(vq)), jnp.asarray(length),
                                block_tokens=128, interpret=True,
                                k_scale=jnp.asarray(_fold_major(ks, D)),
                                v_scale=jnp.asarray(_fold_major(vs, D)))
        to, tl = flash_decode(_t(q).bfloat16(), kq, vq, _t(length), ks, vs)
        tol = INT8_TOL
    else:
        bf = jnp.bfloat16
        jo, jl = j_flash_decode(jnp.asarray(q, bf), jnp.asarray(k, bf),
                                jnp.asarray(v, bf), jnp.asarray(length),
                                block_tokens=128, interpret=True)
        to, tl = flash_decode(_t(q).bfloat16(), _t(k).bfloat16(),
                              _t(v).bfloat16(), _t(length))
        tol = BF16_DECODE_TOL
    assert LAUNCHES == before                   # the CPU takes the plain version
    np.testing.assert_allclose(_np(to), np.asarray(jo, np.float32), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(_np(tl), np.asarray(jl, np.float32), atol=tol,
                               rtol=tol)
    assert (_np(to)[2] == 0).all() and np.isneginf(_np(tl)[2]).all()


def _last_heads(G):
    """The first head and the last head of each 16-head block."""
    return [0] + [h for h in range(G) if h % 16 == 15]


@pytest.mark.parametrize("G", [16, 48])
@pytest.mark.parametrize("int8", [False, True])
def test_lsh_fused_plain_matches_pallas_head_tiles(G, int8):
    """Keys planted near the queries of the first head and of the last head
    of each 16-head block; norms and signatures of the (dequantized) keys
    on both sides; counts exact."""
    B, HKV, S, D, K, L = 2, 1, 256, 128, 6, 20
    rng = np.random.default_rng(70 + G)
    q = _bf16_values(rng, (B, HKV * G, D))
    kc = _bf16_values(rng, (B, HKV, S, D))
    heads = _last_heads(G)
    qh = q.reshape(B, HKV, G, D)
    for i, t in enumerate(range(5, 5 + 8 * len(heads))):
        kc[:, :, t] = qh[:, :, heads[i % len(heads)]] + 0.3 * kc[:, :, t]
    kc = torch.from_numpy(kc).bfloat16().float().numpy()
    v = _bf16_values(rng, (B, HKV, S, D))
    proj = rng.standard_normal((D, K * L)).astype(np.float32)
    length = np.asarray([S, S // 2 + 17], np.int32)
    kw, tkw = {}, {}
    if int8:
        kq, ks = quantize_rows(_t(kc))
        vq, vs = quantize_rows(_t(v))
        kd = _np(dequantize_rows(kq, ks, torch.float32))
        jk, jv = jnp.asarray(_np(kq)), jnp.asarray(_np(vq))
        kw = dict(k_scale=jnp.asarray(_fold_major(ks, D)),
                  v_scale=jnp.asarray(_fold_major(vs, D)))
        tk, tv, tkw = kq, vq, dict(k_scale=ks, v_scale=vs)
        tol = INT8_TOL
    else:
        kd = kc
        jk, jv = jnp.asarray(kc, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
        tk, tv = _t(kc).bfloat16(), _t(v).bfloat16()
        tol = BF16_LSH_TOL
    knorm = np.linalg.norm(kd, axis=-1)
    fold = max(128 // D, 1)
    blk = jbits.plane_block(S, fold)
    jplanes = jax.vmap(lambda kb: jbits.build_planes_blocked(
        kb.transpose(1, 0, 2), jnp.asarray(proj), K, blk, fold))(jnp.asarray(kd))
    jqb = jbits.hash_bits(jnp.asarray(q), jnp.asarray(proj), K)
    if int8:
        jo, jl, jc = lsh_fused_attention2(
            jnp.asarray(q), jk, jv, jnp.asarray(knorm), jplanes, jqb,
            jnp.asarray(length), K, L, interpret=True, **kw)
    else:
        jo, jl, jc = j_lsh_fused_decode(
            jnp.asarray(q, jnp.bfloat16), jk, jv, jnp.asarray(knorm), jplanes,
            jqb, jnp.asarray(length), K, L, block_tokens=128, interpret=True)
    planes = torch.stack([tbits.build_planes(_t(kd[b]).transpose(0, 1),
                                             _t(proj), K) for b in range(B)])
    qb = tbits.hash_bits(_t(q), _t(proj), K)
    to, tl, tc = lsh_fused_decode(_t(q).bfloat16(), tk, tv, _t(knorm), planes,
                                  qb, _t(length), K, L, **tkw)
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    assert _np(tc).reshape(B, HKV, G)[:, :, heads].min() > 0   # the planted
    np.testing.assert_allclose(_np(to), np.asarray(jo, np.float32), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(_np(tl), np.asarray(jl, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("capacity,batch,hkv,group,d,want", [
    (16384, 2, 8, 4, 64, 1024),     # an exact instance: as before
    (16384, 2, 5, 3, 64, 1024),     # SmolLM2-360M's phase-2 shape
    (16384, 2, 8, 16, 128, 2048),   # the 405B's: a merge of 16 heads
    (16384, 2, 8, 6, 128, 2048),    # above 4 heads a block
    (16384, 2, 1, 48, 128, 1024),   # StarCoder-15B's: 16 heads, 1024 at least
    (384, 2, 8, 16, 128, 1024),     # a hot cache: one split
    (384, 2, 5, 3, 64, 256),
])
def test_tile_split_tokens(capacity, batch, hkv, group, d, want):
    """flash_decode's split for the general tile: MIN_SPLIT for every 4
    heads a block at least, MAX_SPLIT_TILE above 4 heads at most; exact
    instances as before."""
    heads = decode_mod.tile_heads(group, d)
    assert heads == (0 if _lib.exact_group(group, d) else min(group, 16))
    chunk = decode_mod.split_tokens(capacity, batch, hkv, 132, heads)
    assert chunk == want and chunk % decode_mod.DECODE_TILE == 0

"""The block_topk estimator's pieces in the port against the JAX package's:
int8 row quantization, and the plain versions of the three kernels (block
scorer, rescore-attend, block-attend) against the Pallas kernels in
interpret mode and against the XLA oracle `block_topk_decode`. The CUDA
kernels themselves are held against these plain versions in
tests/test_torch_kernels_cuda.py (card only).

Layouts: the JAX kernels take token-folded K/V ([B, Hkv, S/fold, 128],
fold = 128/d) and fold-major scales and scores; the port keeps token order.
The converters below reorder at the function boundary, as
`magicpig_tpu/ops/pallas/score.py::exact_scores` does.

Tolerances: quantized rows exactly (same bytes). Scores and block maxes
2e-2, as tests/test_pallas_kernels.py:165 holds the Pallas scorer; the port
follows the Pallas arithmetic (q / sqrt(d) rounded to bf16, f32 sums), so
the errors seen are at f32 rounding. Top-k block ids exactly, on inputs
whose block maxes lie further apart than that tolerance. Attention outputs
and lse 3e-3 with bf16 V and 2e-2 with int8 V, as
tests/test_pallas_kernels.py:217-231 holds block_attend.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicpig_tpu.ops import baselines as jbase
from magicpig_tpu.ops import quant as jquant
from magicpig_tpu.ops.pallas.block_attend import block_attend as j_block_attend
from magicpig_tpu.ops.pallas.rescore_attend import rescore_attend as j_rescore_attend
from magicpig_tpu.ops.pallas.score import block_rank as j_block_rank
from magicpig_tpu.ops.pallas.score import exact_scores_ranked as j_exact_scores_ranked
from magicpig_tpu.ops.pallas.score import length_mask
from magicpig_tpu_torch.ops import baselines as tbase
from magicpig_tpu_torch.ops import quant as tquant
from magicpig_tpu_torch.ops.kernels import (
    LAUNCHES,
    block_attend,
    block_rank,
    exact_scores_ranked,
    rescore_attend,
)
from magicpig_tpu_torch.ops.kernels.block_attend import block_attend_plain
from magicpig_tpu_torch.ops.kernels.block_score import block_scores_plain
from magicpig_tpu_torch.ops.kernels.rescore_attend import rescore_attend_plain

SCORE_TOL = 2e-2
BF16_V_TOL = 3e-3
INT8_V_TOL = 2e-2
B, HKV, G, D, S, BS = 2, 2, 4, 64, 1024, 128
FOLD = 128 // D


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().cpu().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- layout converters (JAX fold-major <-> port token order) ------------------


def _fold(d):
    """Tokens a 128-lane row of the JAX kernels holds at head dim d."""
    return max(128 // d, 1)


def _fold_rows(x):
    """[B, Hkv, S, d] -> token-folded [B, Hkv, S/fold, fold*d]."""
    b, h, s, d = x.shape
    fold = _fold(d)
    return x.reshape(b, h, s // fold, fold * d)


def _fold_scale(x, fold=FOLD):
    """[B, Hkv, S] -> fold-major [B, Hkv, fold, S/fold]."""
    b, h, s = x.shape
    return x.reshape(b, h, s // fold, fold).transpose(0, 1, 3, 2)


def _unfold_scores(x, fold=FOLD):
    """Fold-major [B, Hkv, G*fold, S/fold] -> token order [B, Hkv, G, S]."""
    b, h, gf, c = x.shape
    g = gf // fold
    return x.reshape(b, h, fold, g, c).transpose(0, 1, 3, 4, 2).reshape(b, h, g, c * fold)


def _fold_scores(x, fold=FOLD):
    """Token order [B, Hkv, G, S] -> fold-major [B, Hkv, G*fold, S/fold]."""
    b, h, g, s = x.shape
    return x.reshape(b, h, g, s // fold, fold).transpose(0, 1, 4, 2, 3).reshape(
        b, h, fold * g, s // fold)


def _inputs(seed, lengths=(S, 700), planted=False, d=D, g=G):
    """bf16 q, K, V and int8 K, V with scales, as numpy (f32 values) and
    torch tensors, g query heads a kv head. `planted`: each block of each kv
    head gets one key along the group's summed query, with a strength that
    differs from block to block by far more than SCORE_TOL, so the block
    maxes are ordered."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, HKV * g, d)).astype(np.float32)
    k = rng.standard_normal((B, HKV, S, d)).astype(np.float32)
    v = rng.standard_normal((B, HKV, S, d)).astype(np.float32)
    if planted:
        qsum = q.reshape(B, HKV, g, d).sum(axis=2)
        qdir = qsum / np.linalg.norm(qsum, axis=-1, keepdims=True)
        nb = S // BS
        for b in range(B):
            for h in range(HKV):
                strength = 4.0 + 1.5 * rng.permutation(nb)
                for j in range(nb):
                    k[b, h, j * BS + 5] = strength[j] * qdir[b, h]
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    tq, tk, tv = bf(q), bf(k), bf(v)
    kq, ks = tquant.quantize_rows(tk)
    vq, vs = tquant.quantize_rows(tv)
    length = torch.tensor(lengths, dtype=torch.int32)
    return dict(q=tq, k=tk, v=tv, kq=kq, ks=ks, vq=vq, vs=vs, length=length)


def _j(x):
    """A torch tensor as a JAX array of the same type."""
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)
    return jnp.asarray(x.numpy())


def _j_scores(x, quant, rank_only):
    """The Pallas scorer on the port's token-order inputs."""
    k, ks = (x["kq"], x["ks"]) if quant else (x["k"], None)
    fold = _fold(x["q"].shape[-1])
    mask = length_mask(_j(x["length"]), S, fold)
    args = (_j(x["q"]), _fold_rows(_j(k)),
            None if ks is None else _fold_scale(_j(ks), fold), mask, BS)
    if rank_only:
        return None, j_block_rank(*args, interpret=True)
    scores, bmax = j_exact_scores_ranked(*args, interpret=True)
    return _unfold_scores(scores, fold), bmax


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=tol, rtol=tol)


# -- quantization --------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_rows_is_bit_exact_with_jax(dtype):
    """Same int8 values and scales, rows of zeros and halfway values in."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 2, 50, 64)).astype(np.float32) * 3
    x[0, 0, 7] = 0.0                                 # zero row: scale 0
    x[1, 1, 3, :4] = [127.0, 0.5, -1.5, 2.5]         # halves round to even
    tx = torch.from_numpy(x).to(dtype)
    jx = jnp.asarray(tx.float().numpy(),
                     jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    tq, ts = tquant.quantize_rows(tx)
    jq, js = jquant.quantize_rows(jx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tquant.dequantize_rows(tq, ts, torch.float32).numpy(),
        np.asarray(jquant.dequantize_rows(jq, js, jnp.float32)))


# -- the block scorer ------------------------------------------------------------


# The general tile's group sizes and the small head dims, as (head dim,
# group size): 48 at d = 128 is StarCoder-15B's, three blocks of the block
# kernels' 16-head tile.
NEW_FORMS = ((64, 3), (128, 6), (128, 16), (32, 4), (16, 6), (128, 48))


@pytest.mark.parametrize("quant,d,g", [
    pytest.param(True, D, G, id="True"), pytest.param(False, D, G, id="False"),
    pytest.param(True, 128, G, id="True-d128"),    # Llama-3.1-8B's head dim
    *(pytest.param(True, d, g, id=f"True-d{d}-g{g}") for d, g in NEW_FORMS)])
def test_block_scorer_plain_matches_pallas(quant, d, g):
    x = _inputs(1, d=d, g=g)
    k, ks = (x["kq"], x["ks"]) if quant else (x["k"], None)
    scores, bmax = block_scores_plain(x["q"], k, ks, x["length"], BS)
    j_scores, j_bmax = _j_scores(x, quant, rank_only=False)
    _, j_rank = _j_scores(x, quant, rank_only=True)
    _close(scores, j_scores, SCORE_TOL)
    _close(bmax, j_bmax, SCORE_TOL)
    _close(bmax, j_rank, SCORE_TOL)
    # Blocks wholly past request 1's length (700 of 1024 tokens) are -inf.
    assert torch.isneginf(bmax[1, :, 6:]).all() and torch.isfinite(bmax[1, :, :6]).all()
    assert torch.isneginf(scores[1, :, :, 700:]).all()


@pytest.mark.parametrize("quant", [True, False])
def test_block_scorer_plain_matches_oracle_scores(quant, monkeypatch):
    """The scores `block_topk_decode` computes for itself (captured where it
    hands them to `block_topk_from_scores`), over the valid tokens."""
    x = _inputs(2)
    seen = {}

    def capture(scores, *args, **kw):
        seen["scores"] = np.asarray(scores)
        return real(scores, *args, **kw)

    real = jbase.block_topk_from_scores
    monkeypatch.setattr(jbase, "block_topk_from_scores", capture)
    if quant:
        jbase.block_topk_decode(_j(x["q"]), _j(x["kq"]), _j(x["vq"]), _j(x["length"]),
                                BS, 2, k_scale=_j(x["ks"]), v_scale=_j(x["vs"]))
        scores, _ = block_scores_plain(x["q"], x["kq"], x["ks"], x["length"], BS)
    else:
        jbase.block_topk_decode(_j(x["q"]), _j(x["k"]), _j(x["v"]), _j(x["length"]),
                                BS, 2)
        scores, _ = block_scores_plain(x["q"], x["k"], None, x["length"], BS)
    for b, n in enumerate(x["length"].tolist()):
        _close(scores[b, ..., :n], seen["scores"][b, ..., :n], SCORE_TOL)


@pytest.mark.parametrize("quant", [True, False])
def test_top_k_block_ids_equal_jax(quant):
    x = _inputs(3, planted=True)
    k, ks = (x["kq"], x["ks"]) if quant else (x["k"], None)
    bmax = block_rank(x["q"], k, ks, x["length"], BS)
    _, j_bmax = _j_scores(x, quant, rank_only=True)
    for b, n in enumerate(x["length"].tolist()):
        valid = np.sort(_np(bmax[b, :, :-(-n // BS)]), axis=-1)
        assert (np.diff(valid, axis=-1) > SCORE_TOL).all()
    ids = torch.topk(bmax, 5, dim=-1).indices
    _, j_ids = jax.lax.top_k(j_bmax, 5)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))


# -- the two attends -------------------------------------------------------------


def _selection(x, quant, n_sel):
    """The block ids the JAX ranking picks, as int32 for both sides."""
    _, j_bmax = _j_scores(x, quant, rank_only=True)
    _, j_ids = jax.lax.top_k(j_bmax, n_sel)
    return j_ids, _t(np.asarray(j_ids)).to(torch.int32)


@pytest.mark.parametrize("n_sel,d,g", [
    pytest.param(3, D, G, id="3"), pytest.param(8, D, G, id="8"),
    pytest.param(3, 128, G, id="3-d128"),
    *(pytest.param(3, d, g, id=f"3-d{d}-g{g}") for d, g in NEW_FORMS)])
def test_rescore_attend_plain_matches_pallas(n_sel, d, g):
    """int8 K and V. Request 1 (700 tokens) leaves blocks 6 and 7 empty;
    with 8 blocks selected they are among them."""
    x = _inputs(4, d=d, g=g)
    fold = _fold(d)
    j_ids, ids = _selection(x, True, n_sel)
    out, lse = rescore_attend(x["q"], ids, x["kq"], x["ks"], x["vq"], x["vs"],
                              x["length"], BS)
    j_out, j_lse = j_rescore_attend(
        _j(x["q"]), j_ids, _fold_rows(_j(x["kq"])), _fold_scale(_j(x["ks"]), fold),
        _fold_rows(_j(x["vq"])), _fold_scale(_j(x["vs"]), fold), _j(x["length"]),
        BS, d, interpret=True)
    _close(out, j_out, INT8_V_TOL)
    _close(lse, j_lse, INT8_V_TOL)


@pytest.mark.parametrize("quant,d,g", [
    pytest.param(True, D, G, id="True"), pytest.param(False, D, G, id="False"),
    pytest.param(False, 128, G, id="False-d128"),  # the store pipeline, bf16
    *(pytest.param(False, d, g, id=f"False-d{d}-g{g}") for d, g in NEW_FORMS)])
def test_block_attend_plain_matches_pallas(quant, d, g):
    x = _inputs(5, d=d, g=g)
    fold = _fold(d)
    k, ks = (x["kq"], x["ks"]) if quant else (x["k"], None)
    v, vs = (x["vq"], x["vs"]) if quant else (x["v"], None)
    j_ids, ids = _selection(x, quant, 4)
    scores, _ = exact_scores_ranked(x["q"], k, ks, x["length"], BS)
    out, lse = block_attend(scores, ids, v, vs, BS)
    j_out, j_lse = j_block_attend(
        jnp.asarray(_fold_scores(scores.numpy(), fold)), j_ids, _fold_rows(_j(v)),
        None if vs is None else _fold_scale(_j(vs), fold), BS, d, interpret=True)
    tol = INT8_V_TOL if quant else BF16_V_TOL
    _close(out, j_out, tol)
    _close(lse, j_lse, tol)


@pytest.mark.parametrize("pipeline,quant", [
    ("rescore", True), ("store", True), ("store", False)])
def test_block_topk_pipelines_match_oracle(pipeline, quant):
    """Rank, top-k and attend, as the server runs them (the rescore
    pipeline with int8 offload only), against `block_topk_decode`, which
    dequantizes V to bf16 where the kernels scale the probabilities."""
    x = _inputs(6)
    k, ks = (x["kq"], x["ks"]) if quant else (x["k"], None)
    v, vs = (x["vq"], x["vs"]) if quant else (x["v"], None)
    n_sel = 3
    if pipeline == "rescore":
        ids = torch.topk(block_rank(x["q"], k, ks, x["length"], BS), n_sel).indices
        out, lse = rescore_attend(x["q"], ids.to(torch.int32), k, ks, v, vs,
                                  x["length"], BS)
    else:
        scores, bmax = exact_scores_ranked(x["q"], k, ks, x["length"], BS)
        ids = torch.topk(bmax, n_sel).indices
        out, lse = block_attend(scores, ids.to(torch.int32), v, vs, BS)
    j_out, j_lse = jbase.block_topk_decode(
        _j(x["q"]), _j(k), _j(v), _j(x["length"]), BS, n_sel,
        k_scale=None if ks is None else _j(ks), v_scale=None if vs is None else _j(vs))
    tol = INT8_V_TOL if quant else BF16_V_TOL
    _close(out, j_out, tol)
    _close(lse, j_lse, tol)
    t_out, t_lse = tbase.block_topk_decode(x["q"], k, v, x["length"], BS, n_sel,
                                           k_scale=ks, v_scale=vs)
    _close(t_out, j_out, 1e-4)
    _close(t_lse, j_lse, 1e-4)


@pytest.mark.parametrize("which", ["rescore", "block"])
def test_selected_blocks_past_the_length_give_empty_rows(which):
    """Request 1 has 100 valid tokens: of its selected blocks only block 0
    holds any; request 0 has none at all (length 0, as after clear()).
    Empty rows give out 0 and lse -inf, with no NaN, in the port and in
    the Pallas kernels."""
    x = _inputs(7, lengths=(0, 100))
    ids = torch.tensor([[[0, 3, 5]] * HKV, [[6, 0, 2]] * HKV], dtype=torch.int32)
    j_ids = jnp.asarray(ids.numpy())
    if which == "rescore":
        out, lse = rescore_attend(x["q"], ids, x["kq"], x["ks"], x["vq"], x["vs"],
                                  x["length"], BS)
        j_out, j_lse = j_rescore_attend(
            _j(x["q"]), j_ids, _fold_rows(_j(x["kq"])), _fold_scale(_j(x["ks"])),
            _fold_rows(_j(x["vq"])), _fold_scale(_j(x["vs"])), _j(x["length"]), BS,
            D, interpret=True)
    else:
        scores, _ = exact_scores_ranked(x["q"], x["kq"], x["ks"], x["length"], BS)
        out, lse = block_attend(scores, ids, x["vq"], x["vs"], BS)
        j_out, j_lse = j_block_attend(
            jnp.asarray(_fold_scores(scores.numpy())), j_ids, _fold_rows(_j(x["vq"])),
            _fold_scale(_j(x["vs"])), BS, D, interpret=True)
    assert not torch.isnan(out).any() and not torch.isnan(lse).any()
    assert (out[0] == 0).all() and torch.isneginf(lse[0]).all()
    assert torch.isfinite(lse[1]).all()
    np.testing.assert_array_equal(np.isneginf(np.asarray(j_lse)), np.isneginf(_np(lse)))
    _close(out, j_out, INT8_V_TOL)
    _close(lse[1], np.asarray(j_lse)[1], INT8_V_TOL)


def test_plain_rescore_equals_plain_block_attend_of_stored_scores():
    """The two pipelines compute the same function: the rescored scores of
    the chosen blocks are the stored ones."""
    x = _inputs(8)
    scores, bmax = block_scores_plain(x["q"], x["kq"], x["ks"], x["length"], BS)
    ids = torch.topk(bmax, 4).indices.to(torch.int32)
    a = rescore_attend_plain(x["q"], ids, x["kq"], x["ks"], x["vq"], x["vs"],
                             x["length"], BS)
    b = block_attend_plain(scores, ids, x["vq"], x["vs"], BS)
    for got, want in zip(a, b):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_cpu_block_kernels_take_the_plain_versions_without_counting():
    before = dict(LAUNCHES)
    x = _inputs(9)
    scores, bmax = exact_scores_ranked(x["q"], x["kq"], x["ks"], x["length"], BS)
    ps, pb = block_scores_plain(x["q"], x["kq"], x["ks"], x["length"], BS)
    assert torch.equal(scores, ps) and torch.equal(bmax, pb)
    assert torch.equal(block_rank(x["q"], x["kq"], x["ks"], x["length"], BS), pb)
    assert LAUNCHES == before

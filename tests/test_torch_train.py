"""The port's training path against the JAX package's, on the CPU in
float32: the training attention's custom gradient, the needle and RULER-LM
steps, the schedule, resuming, the checkpoint writer and the data files.

Tolerances (measured and stated):
  * the plain `FlashPrefillTrain` (out, dq, dk, dv) against `jax.vjp` of
    `_flash_prefill_train`: 1e-5 of each tensor's largest |value| (f32
    sums in another order; at most 7.3e-7 measured);
  * the trainers' steps against the JAX step built from
    `examples/train_needle.py::forward_all` and optax from the same
    weights: losses over 3 steps within 1e-4 relative (1.3e-5 needle,
    2.6e-5 RULER measured), every leaf's gradient at step 0 (`cos` and
    `sin` included) within 1e-4 of that leaf's largest |gradient| (2.1e-6
    measured), and the trained `cos` within 1e-4 of JAX's (7.3e-6); the
    needle config at 3/1 heads of 128 (the card's 3B form) to the same
    losses and gradients (its `cos` not: see the test);
  * the cosine schedule against optax's: 1e-6 relative (optax evaluates
    it in float32);
  * a resumed 2 + 2-step run, `save_params` read back by both packages'
    `load_params`, and `make_data_torch.py`'s files: exactly.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from magicpig_tpu.models import llama as jllama
from magicpig_tpu.ops.attention import _flash_prefill_train
from magicpig_tpu_torch import training
from magicpig_tpu_torch.models.convert import (
    NPZ_LEAVES,
    load_params,
    params_from_numpy,
    save_params,
)
from magicpig_tpu_torch.ops import attention as tatt
from magicpig_tpu_torch.ops.kernels import FlashPrefillTrain, flash_prefill

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
ATTN_TOL = 1e-5
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-4
LR = 1e-3
STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _examples():
    sys.path.insert(0, str(EXAMPLES))
    try:
        import train_needle as jtn
        import train_needle_torch as ttn
        import train_ruler_lm as jtr
        import train_ruler_lm_torch as ttr
    finally:
        sys.path.remove(str(EXAMPLES))
    return jtn, ttn, jtr, ttr


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


# -- the training attention -----------------------------------------------------

# (group, batch, sq, skv, block_k, q_offset, kv_len, window, head_dim)
_GEOMETRIES = (
    (2, 64, 64, 32, 0, 64, None),         # self-attention
    (2, 48, 128, 32, 64, 100, None),      # q_offset, kv_len < skv
    (2, 64, 96, 32, 20, 90, 17),          # and a window
)
ATTN_FORMS = [(g, *form, 16) for g in (1, 2, 4) for form in _GEOMETRIES] + [
    # The forms the card's backward took on with every group size and head
    # dim: Llama-3.2-3B's (G 3, d 128), SmolLM2-360M's (G 3, d 64), the
    # general group sizes 5 and 16 (Llama-3.1-405B: G 16, d 128), d 32.
    (3, *_GEOMETRIES[1], 128),
    (3, *_GEOMETRIES[2], 64),
    (5, *_GEOMETRIES[0], 64),
    (5, *_GEOMETRIES[2], 32),
    (16, *_GEOMETRIES[2], 128),
    (16, *_GEOMETRIES[1], 32),
]


def _attn_id(form) -> str:
    # Head dim 16 forms keep the ids they had before the head dim joined.
    return "-".join(str(x) for x in form[:-1]) + (
        "" if form[-1] == 16 else f"-d{form[-1]}")


@pytest.mark.parametrize("form", ATTN_FORMS, ids=_attn_id)
def test_train_attention_matches_jax_vjp(form):
    g, b, sq, skv, block_k, off, kv_len, window, d = form
    hkv = 2
    rng = np.random.default_rng(sum(x or 0 for x in form))
    q = rng.standard_normal((b, sq, g * hkv, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal(q.shape).astype(np.float32)
    scale = d ** -0.5

    def f(q, k, v):
        return _flash_prefill_train(block_k, scale, window, q, k, v,
                                    jnp.int32(off), jnp.int32(kv_len))

    jout, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = FlashPrefillTrain.apply(tq, tk, tv, off, kv_len, block_k, scale,
                                  window)
    out.backward(torch.from_numpy(do))
    _close(out.detach(), jout, ATTN_TOL, "out")
    for name, t, j in zip("qkv", (tq, tk, tv), jgrads):
        assert t.grad.dtype == torch.float32
        _close(t.grad, j, ATTN_TOL, f"d{name}")
    # The same through the prefill entry's differentiable route.
    tq2 = torch.from_numpy(q).requires_grad_()
    out2 = flash_prefill(tq2, torch.from_numpy(k), torch.from_numpy(v),
                         torch.full((b,), kv_len),
                         q_offset=torch.full((b,), off), window=window,
                         sm_scale=scale, differentiable=True, block_k=block_k)
    out2.backward(torch.from_numpy(do))
    assert torch.equal(out2, out) and torch.equal(tq2.grad, tq.grad)


def test_train_attention_block_rule():
    """skv % block_k != 0 raises ValueError in the plain backward (as JAX's
    backward does) and in the Function before its forward."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 16, 2, 8)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 48, 1, 8)).astype(np.float32))
    with pytest.raises(ValueError, match="skv % block_k"):
        FlashPrefillTrain.apply(q, k, k, 0, 48, 32, None, None)
    out, lse = tatt.flash_prefill(q, k, k, torch.tensor([48]),
                                  return_lse=True, block_k=32)
    with pytest.raises(ValueError, match="skv % block_k"):
        tatt.flash_prefill_train_backward(q, k, k, out, lse, out, 0, 48, 32)

    def f(q, k):
        return _flash_prefill_train(32, 8 ** -0.5, None, q, k, k,
                                    jnp.int32(0), jnp.int32(48))

    with pytest.raises(ValueError, match="skv % block_k"):
        jax.grad(lambda q, k: f(q, k).sum())(jnp.asarray(q.numpy()),
                                             jnp.asarray(k.numpy()))


# -- the trainers' steps ----------------------------------------------------------


def test_trainer_data_and_configs_equal_jax():
    """make_batch and gen_pool draw the JAX examples' arrays from the same
    seeds (plain, variable-length and 2-hop batches), and the model
    configs agree field for field."""
    jtn, ttn, jtr, ttr = _examples()
    for kw in ({}, {"min_seq": 200, "hop_frac": 0.5}):
        rj, rt = np.random.default_rng(4), np.random.default_rng(4)
        for _ in range(2):
            for j, t in zip(jtn.make_batch(rj, 3, 256, **kw),
                            ttn.make_batch(rt, 3, 256, **kw)):
                np.testing.assert_array_equal(t, j)
                assert t.dtype == j.dtype
    rj, rt = np.random.default_rng(5), np.random.default_rng(5)
    for j, t in zip(jtr.gen_pool(3, 600, 1, 8, 16, rj),
                    ttr.gen_pool(3, 600, 1, 8, 16, rt)):
        np.testing.assert_array_equal(t, j)
    assert rj.integers(1 << 30) == rt.integers(1 << 30)
    for jm, tm in ((jtn, ttn), (jtr, ttr)):
        jc, tc = jm.model_config(), tm.model_config()
        for f in dataclasses.fields(jc):
            if f.name != "dtype" and hasattr(tc, f.name):
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert tc.dtype == torch.float32 and jc.dtype == jnp.float32


def _jax_step(cfg, jtn, tx, kind):
    """The JAX examples' step (their `main`'s `step`), returning the
    gradients too."""

    def loss_fn(p, tokens, a, b):
        logits = jtn.forward_all(p, cfg, tokens)
        if kind == "needle":
            target, mask = a, b
            ce = optax.softmax_cross_entropy_with_integer_labels(logits,
                                                                 target)
            m = mask.astype(jnp.float32)
            return (ce * m).sum() / jnp.maximum(m.sum(), 1)
        logits, tgt, w = logits[:, :-1], tokens[:, 1:], b[:, :-1]
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, tgt)
        return (ce * w).sum() / jnp.maximum(w.sum(), 1)

    @jax.jit
    def step(params, opt_state, tokens, a, b):
        loss, grads = jax.value_and_grad(loss_fn)(params, tokens, a, b)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    return step


def _needle_batches(ttn, seq):
    rng = np.random.default_rng(1)
    return [ttn.make_batch(rng, 2, seq) for _ in range(STEPS)]


def _ruler_batches(ttr, seq):
    rng = np.random.default_rng(1)
    toks, answer, valid = ttr.gen_pool(4, seq, 0, 8, 16, rng)
    wts = ttr.loss_weights(answer, valid, 0.05)
    sels = [rng.integers(0, 4, size=2) for _ in range(STEPS)]
    return [(toks[s], toks[s], wts[s]) for s in sels]


# The needle config reshaped to Llama-3.2-3B's head shape: 3 query heads
# over 1 kv head of 128 (G = 3, d = 128), the form the card trains the 3B at.
G3_D128 = dict(num_attention_heads=3, num_key_value_heads=1, head_dim=128)


@pytest.mark.parametrize("kind", ["needle", "ruler", "needle_g3_d128"])
def test_train_steps_match_jax(kind):
    jtn, ttn, jtr, ttr = _examples()
    jmod, tmod, seq = ((jtr, ttr, 512) if kind == "ruler"
                       else (jtn, ttn, 128))
    shape = G3_D128 if kind == "needle_g3_d128" else {}
    jcfg = dataclasses.replace(jmod.model_config(), num_hidden_layers=2,
                               **shape)
    tcfg = dataclasses.replace(tmod.model_config(), num_hidden_layers=2,
                               **shape)
    batches = (_ruler_batches(ttr, seq) if kind == "ruler"
               else _needle_batches(ttn, seq))
    jparams = jllama.init_params(jcfg, jax.random.key(0), seq)
    tparams = params_from_numpy(dataclasses.asdict(
        jax.tree_util.tree_map(np.asarray, jparams)), device="cpu")

    tx = optax.adamw(optax.cosine_decay_schedule(LR, STEPS, 0.1),
                     weight_decay=0.01)
    opt_state = tx.init(jparams)
    loss_kind = "ruler" if kind == "ruler" else "needle"
    step = _jax_step(jcfg, jtn, tx, loss_kind)
    opt = training.adamw(tparams, LR)
    loss_fn = (ttr.next_byte_loss if kind == "ruler"
               else training.masked_loss)
    jl, tl = [], []
    for i, batch in enumerate(batches):
        jparams, opt_state, loss, jgrads = step(
            jparams, opt_state, *(jnp.asarray(x) for x in batch))
        jl.append(float(loss))
        loss, _ = training.train_step(
            tparams, tcfg, opt, training.cosine_decay(LR, STEPS, i), loss_fn,
            *(torch.from_numpy(np.asarray(x)) for x in batch))
        tl.append(float(loss))
        if i == 0:
            jg = jax.tree_util.tree_leaves(jgrads)
            tg = [t.grad for t in training.leaves(tparams)]
            assert len(jg) == len(tg) == len(NPZ_LEAVES)
            for name, t, j in zip(NPZ_LEAVES, tg, jg):
                assert float(np.abs(np.asarray(j)).max()) > 0, name
                _close(t, j, GRAD_TOL, f"step-0 gradient of {name}")
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    # The RoPE tables moved, as optax moves them. Not held to JAX's at d =
    # 128: there some entries' step-0 gradients are float noise (~1e-8 in
    # both packages, against a largest 0.12), and AdamW's first update,
    # lr * g / (|g| + eps), moves such an entry by up to ~lr either way.
    if kind != "needle_g3_d128":
        _close(tparams.cos.detach(), np.asarray(jparams.cos), GRAD_TOL,
               "trained cos")
    assert not torch.equal(tparams.cos.detach(),
                           training.initial_params(tcfg, seq, 0, "cpu").cos)


def test_schedule_matches_optax():
    for lr, steps in ((3e-4, 50), (1e-3, 7)):
        sched = optax.cosine_decay_schedule(lr, steps, 0.1)
        for i in range(steps + 5):
            np.testing.assert_allclose(training.cosine_decay(lr, steps, i),
                                       float(sched(i)), rtol=1e-6)


class _Stop(Exception):
    pass


def test_resumed_run_equals_unbroken(tmp_path, monkeypatch):
    """Four steps with a stop after two (a rolling partial every step) and
    a rerun from the partial, without --init, end where four unbroken
    steps end: the same losses and weights bit for bit."""
    _, ttn, _, _ = _examples()
    small = dataclasses.replace(ttn.model_config(), num_hidden_layers=2)
    monkeypatch.setattr(ttn, "model_config", lambda: small)
    common = ["--steps", "4", "--batch", "2", "--seq", "128", "--device",
              "cpu", "--save-every", "1"]
    whole = ttn.train(ttn.parse_args(common + ["--out",
                                               str(tmp_path / "a.npz")]))

    calls = []
    step = training.train_step

    def stopping(*args):
        if len(calls) == 2:
            raise _Stop
        calls.append(1)
        return step(*args)

    out = str(tmp_path / "b.npz")
    monkeypatch.setattr(training, "train_step", stopping)
    with pytest.raises(_Stop):
        ttn.train(ttn.parse_args(common + ["--out", out]))
    monkeypatch.setattr(training, "train_step", step)
    assert Path(training.partial_path(out)).exists()
    rest = ttn.train(ttn.parse_args(common + ["--out", out]))
    assert rest["start"] == 2
    assert rest["losses"] == whole["losses"][2:]
    assert not Path(training.partial_path(out)).exists()
    a, b = np.load(tmp_path / "a.npz"), np.load(out)
    for i in range(len(NPZ_LEAVES)):
        np.testing.assert_array_equal(b[f"leaf_{i}"], a[f"leaf_{i}"])


# -- the checkpoint writer and the data files ---------------------------------------


def test_save_params_read_by_both_packages(tmp_path):
    jtn, ttn, _, _ = _examples()
    tcfg = ttn.model_config()
    params = training.initial_params(tcfg, 256, 3, "cpu")
    path = tmp_path / "ckpt.npz"
    save_params(params, path)
    want = [t.numpy() for t in training.leaves(params)]
    jparams = jtn.load_params(str(path), jtn.model_config(), 256)
    back = load_params(path, tcfg, 256, device="cpu")
    for name, w, j, t in zip(NPZ_LEAVES, want, jax.tree_util.tree_leaves(
            jparams), training.leaves(back)):
        for got in (np.asarray(j), t.numpy()):
            assert got.dtype == w.dtype and got.shape == w.shape, name
            assert got.tobytes() == w.tobytes(), name


def test_make_data_files_equal_jax(tmp_path):
    procs = [subprocess.Popen([sys.executable, str(EXAMPLES / script),
                               "--out", str(tmp_path / out), "--samples",
                               "1"], cwd=ROOT, stdout=subprocess.DEVNULL)
             for script, out in (("make_data.py", "jax"),
                                 ("make_data_torch.py", "torch"))]
    assert [p.wait(timeout=300) for p in procs] == [0, 0]
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "torch").iterdir())
    assert len(names) == 6
    for name in names:
        assert ((tmp_path / "torch" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name

"""The port's chunked prefill, slot release and continuous-batching
`Scheduler` against the JAX package's, on the CPU at the tiny float32 size
of `tests/test_engine.py` (max_length 256, chunk 32, K=6, L=40, 4 sink and
16 local tokens, a 32-token generation buffer), with the JAX weights and
hash projections carried across.

Tolerances: chunked-prefill logits 1e-5, as `tests/test_engine.py` holds
JAX's chunked prefill to its one-shot one; decode logits against JAX 2e-2,
the debias difference of `tests/test_torch_engine.py` (`JAX_DEBIAS_TOL`);
greedy tokens exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicpig_tpu.config import LSHConfig as JLSHConfig
from magicpig_tpu.config import preset as jpreset
from magicpig_tpu.models import llama as jllama
from magicpig_tpu.ops.rope import apply_rope as j_apply_rope
from magicpig_tpu.runtime import server as jserver
from magicpig_tpu.runtime import serving as jserving
from magicpig_tpu.runtime.engine import LLM as JLLM
from magicpig_tpu_torch.config import LSHConfig, preset
from magicpig_tpu_torch.models.convert import params_from_numpy
from magicpig_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from magicpig_tpu_torch.runtime import server as tserver
from magicpig_tpu_torch.runtime.engine import LLM
from magicpig_tpu_torch.runtime.serving import Scheduler

MAX_LEN = 256
CHUNK = 32
CHUNK_TOL = 1e-5
JAX_DEBIAS_TOL = 2e-2
LSH_KW = dict(K=6, L=40, num_sink_tokens=4, num_local_tokens=16,
              generation_buffer=32)
JCFG = dataclasses.replace(jpreset("llama-tiny"), dtype=jnp.float32)
TCFG = dataclasses.replace(preset("llama-tiny"), dtype=torch.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(JCFG, jax.random.key(0), MAX_LEN)
    tree = dataclasses.asdict(jax.tree_util.tree_map(np.asarray, jp))
    bank = np.random.default_rng(42).standard_normal(
        (TCFG.head_dim, LSH_KW["K"] * LSH_KW["L"])).astype(np.float32)
    return jp, params_from_numpy(tree, device="cpu"), bank


def _engines(weights, batch_size=1, max_length=MAX_LEN, **kw):
    jp, tp, bank = weights
    jl = JLLM(JCFG, batch_size=batch_size, max_length=max_length,
              chunk_size=CHUNK, params=jp, lsh=JLSHConfig(**LSH_KW, **kw))
    jl.projections = jnp.asarray(bank)
    tl = LLM(TCFG, batch_size=batch_size, max_length=max_length,
             chunk_size=CHUNK, params=tp, lsh=LSHConfig(**LSH_KW, **kw),
             projections=_t(bank), device="cpu")
    return jl, tl


def _prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, TCFG.vocab_size, size=n).astype(np.int32)
            for n in sizes]


def _run_chunks(cp):
    steps, logits = 0, None
    while not cp.done:
        logits = cp.step()
        steps += 1
    assert steps == cp.n_chunks
    return logits


# -- chunked prefill ----------------------------------------------------------


def test_start_prefill_matches_jax_and_one_shot_then_decodes(weights):
    """`start_prefill` of 77 tokens in chunks of 32: three chunks, logits
    as JAX's chunked prefill and the port's one-shot `prefill`; four
    decode steps after it as the one-shot engine's and JAX's."""
    (prompt,) = _prompts(3, (77,))
    jl, chunked = _engines(weights)
    _, one_shot = _engines(weights)
    jcp = jl.start_prefill(prompt, request_id=0)
    cp = chunked.start_prefill(prompt, request_id=0)
    assert cp.n_chunks == jcp.n_chunks == 3
    assert _run_chunks(cp) is cp.logits
    want = np.asarray(_run_chunks(jcp))
    got, mono = _np(cp.logits), _np(one_shot.prefill(prompt))
    np.testing.assert_allclose(got, want, rtol=CHUNK_TOL, atol=CHUNK_TOL)
    np.testing.assert_allclose(got, mono, rtol=CHUNK_TOL, atol=CHUNK_TOL)
    for eng in (chunked, one_shot):
        assert int(eng.state.pos[0]) == 77 and eng._pos_used[0] == 77

    tok = int(want[0].argmax())
    for _ in range(4):
        lj = np.asarray(jl.inference(np.asarray([tok])))
        lc = _np(chunked.inference(torch.tensor([tok])))
        lm = _np(one_shot.inference(torch.tensor([tok])))
        np.testing.assert_allclose(lc, lm, rtol=CHUNK_TOL, atol=CHUNK_TOL)
        np.testing.assert_allclose(lc, lj, rtol=JAX_DEBIAS_TOL,
                                   atol=JAX_DEBIAS_TOL)
        assert int(lc[0].argmax()) == int(lj[0].argmax())
        tok = int(lj[0].argmax())


def test_start_prefill_refuses_padded_prompt_past_max_length(weights):
    """230 tokens pad to 8 chunks of 32 = 256 > max_length 240: the JAX
    engine fails inside its staging write; the port raises before any work
    and allocates no staging. The one-shot prefill takes the prompt."""
    _, tl = _engines(weights, max_length=240)
    (prompt,) = _prompts(4, (230,))
    with pytest.raises(ValueError, match="chunks of 32 > max_length 240"):
        tl.start_prefill(prompt)
    assert tl._stage_k is None
    assert torch.isfinite(tl.prefill(prompt)).all()
    with pytest.raises(ValueError, match="shorter than sink"):
        tl.start_prefill(prompt[:20])


def test_release_slot_zeroes_lengths_in_place(weights):
    """release_slot zeroes the slot's four lengths and drops its guard
    mirrors, and every state tensor keeps its storage (a captured decode
    step reads them by address)."""
    _, tl = _engines(weights, batch_size=2)
    a, b = _prompts(5, (60, 70))
    tl.prefill(a, request_id=0)
    _run_chunks(tl.start_prefill(b, request_id=1))
    tl.inference(torch.tensor([1, 2]))
    st = tl.state
    tensors = [t for f in dataclasses.fields(st)
               for t in (getattr(st, f.name) if isinstance(getattr(st, f.name), list)
                         else [getattr(st, f.name)])]
    ptrs = [t.data_ptr() for t in tensors]
    before = {n: _np(getattr(st, n)).copy()
              for n in ("pos", "dense_len", "hot_len", "off_len")}
    tl.release_slot(1)
    for name, old in before.items():
        now = _np(getattr(st, name))
        assert now[1] == 0 and now[0] == old[0] and old[1] > 0, name
    assert 1 not in tl._hot_used and 1 not in tl._pos_used and 0 in tl._hot_used
    assert [t.data_ptr() for t in tensors] == ptrs


# -- the Scheduler ----------------------------------------------------------------


def _single_tokens(weights, prompt, n):
    _, tl = _engines(weights)
    want = [int(_np(tl.prefill(prompt))[0].argmax())]
    for _ in range(n - 1):
        want.append(int(_np(tl.inference(torch.tensor([want[-1]])))[0].argmax()))
    return want


@pytest.mark.parametrize("interleave,seed,sizes,max_tokens", [
    (False, 11, (60, 72, 66, 80), 4),      # tests/test_engine.py:321
    (True, 12, (70, 64, 90, 62), 5),       # tests/test_engine.py:383
], ids=["synchronous", "interleaved"])
def test_scheduler_tokens_match_jax_and_single_engines(weights, interleave,
                                                       seed, sizes, max_tokens):
    """Four requests over two slots: each request's greedy tokens equal
    the JAX Scheduler's in the same mode and a single-request engine's."""
    prompts = _prompts(seed, sizes)
    got = {}
    for name, (jl, tl) in (("jax", _engines(weights, batch_size=2)),
                           ("port", _engines(weights, batch_size=2))):
        sched = (jserving.Scheduler(jl, interleave=interleave) if name == "jax"
                 else Scheduler(tl, interleave=interleave))
        for p in prompts:
            sched.submit(p, max_tokens=max_tokens)
        finished = sched.run()
        assert len(finished) == 4 and not sched.pending
        got[name] = {r.uid: r.generated for r in finished}
    assert got["port"] == got["jax"]
    for uid, p in zip(sorted(got["port"]), prompts):
        assert got["port"][uid] == _single_tokens(weights, p, max_tokens), uid


def test_scheduler_modes_agree_and_refuse_long_generation(weights):
    """The two admission modes give each request the same tokens (the JAX
    package's `test_interleaved_scheduler_matches_synchronous`), and a
    request asking for more tokens than the generation buffer is refused."""
    prompts = _prompts(12, (70, 64, 90, 62))
    results = {}
    for interleave in (False, True):
        _, tl = _engines(weights, batch_size=2)
        sched = Scheduler(tl, interleave=interleave)
        for p in prompts:
            sched.submit(p, max_tokens=5)
        results[interleave] = {r.uid: r.generated for r in sched.run()}
        assert tl.graph_captures == 0           # the CPU steps run eagerly
    assert results[True] == results[False]
    with pytest.raises(ValueError, match="exceeds the generation buffer"):
        sched.submit(prompts[0], max_tokens=109)


# -- idle slots -------------------------------------------------------------------


def test_idle_slot_past_its_caches_matches_jax(weights):
    """Six rounds of a 60-token prefill into slot 0 and 30 decode steps at
    B = 2: slot 1 is never filled, and the batched step takes its hot
    length to 180, past its 128-row hot cache. JAX clamps the append; the
    port did not and raised in round 4. Slot 0's logits equal JAX's at
    every step, and slot 1's stay finite."""
    jl, tl = _engines(weights, batch_size=2)
    for prompt in _prompts(21, (60,) * 6):
        lj = np.asarray(jl.prefill(prompt))
        lt = _np(tl.prefill(prompt, request_id=0))
        np.testing.assert_allclose(lt, lj, rtol=1e-4, atol=1e-4)
        for _ in range(30):
            tok = int(lj[0].argmax())
            lj = np.asarray(jl.inference(np.asarray([tok, tok])))
            lt = _np(tl.inference(torch.tensor([tok, tok])))
            np.testing.assert_allclose(lt[0], lj[0], rtol=JAX_DEBIAS_TOL,
                                       atol=JAX_DEBIAS_TOL)
            assert np.isfinite(lt).all()
    assert int(tl.state.hot_len[1]) == int(jl.state.hot_len[1]) == 180
    assert tl.state.hot_k[0].shape[2] == 128


def test_append_past_the_cache_writes_its_last_row_as_jax():
    """An append at a length past the cache writes the last row, as JAX's
    `dynamic_update_slice` does; a length inside it writes that row."""
    rng = np.random.default_rng(0)
    cache = rng.standard_normal((2, 3, 8, 4)).astype(np.float32)
    new = rng.standard_normal((2, 3, 4)).astype(np.float32)
    lens = np.asarray([5, 11], np.int32)
    want = np.asarray(jserver._append_per_request(
        jnp.asarray(cache), jnp.asarray(new), jnp.asarray(lens)))
    got = _t(cache)
    tserver._append(got, _t(new), tserver._append_at(_t(lens), 8))
    np.testing.assert_array_equal(_np(got), want)


def test_rope_clamps_positions_past_the_table_as_jax():
    """Positions past the RoPE table read its last row, as JAX's gather
    does (an idle slot's position grows with every batched step)."""
    rng = np.random.default_rng(1)
    cos, sin = rope_cos_sin(TCFG, 64, "cpu")
    x = rng.standard_normal((2, 3, 2, TCFG.head_dim)).astype(np.float32)
    pos = np.asarray([[10, 63, 64], [70, 200, 5]], np.int32)
    got = apply_rope(_t(x), cos, sin, _t(pos).long())
    want = j_apply_rope(jnp.asarray(x), jnp.asarray(_np(cos)),
                        jnp.asarray(_np(sin)), jnp.asarray(pos))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)

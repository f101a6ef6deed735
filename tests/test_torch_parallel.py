"""The port's sharded engine (`parallel/mesh.py`, `sharded.py`, the
engine's hooks) against the JAX package's, on the CPU in float32.

Four gloo ranks (`parallel/launch.py`, one spawn for the file, one torch
thread each) run every case; the JAX engines run in this process on the
8-device virtual CPU mesh (`tests/conftest.py`) through the XLA path
(`use_pallas="off"`), with the same weights and hash projections carried
across. Each case prefills two prompts and decodes three steps on fixed
tokens (so that a near-tie cannot fork the two runs), and is held to the
unsharded JAX `LLM` and to JAX's `shard_engine` at the same mesh, at JAX's
own tolerances: 2e-3 for logits and 1e-3 for the sampled fraction
(`tests/test_sharded.py:91-92`), 2e-4 at 1 x 4 (`tests/test_parallel.py:
48-49`). Every rank must return the same results.

Cases: meshes 1 x 4, 2 x 2 and 2 x 2 with the ring prefill over "data",
each under LSH and block_topk (int8 offload); `start_prefill` at 2 x 2;
W8A8 weights at 1 x 2, whose row-split products quantize by the whole
row's amax; `make_multihost_mesh` with LOCAL_WORLD_SIZE=2. The split of
the weights and of the state is held to `param_pspecs` / `state_pspecs`
applied with numpy.
"""

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from magicpig_tpu_torch.config import LSHConfig, ModelConfig
from magicpig_tpu_torch.parallel.launch import launch

MAX_LEN, CHUNK, B, STEPS, WORLD = 192, 64, 2, 3, 4
PROMPT_LENS = (120, 100)
LOGIT_TOL, FRAC_TOL, TP_TOL = 2e-3, 1e-3, 2e-4
# The unsharded port against the unsharded JAX engine, per configuration:
# int8 offload 5e-3 of the largest logit (JAX's CPU path rounds the
# dequantized K/V to bf16), W8A8 5e-2 of it (a float32 rounding difference
# moves an activation one int8 step), the sampled fraction 2e-3
# (`tests/test_torch_int8.py`, `tests/test_torch_engine.py`).
INT8_TOL, W8_TOL, JAX_FRAC_TOL = 5e-3, 5e-2, 2e-3
CFG = dict(name="sharded-test", vocab_size=512, hidden_size=128,
           intermediate_size=256, num_hidden_layers=2, num_attention_heads=8,
           num_key_value_heads=4, head_dim=32, rope_theta=10000.0,
           rope_scaling=None, max_position_embeddings=4096,
           eos_token_ids=(0,))
LSH_KW = dict(num_sink_tokens=4, num_local_tokens=16, generation_buffer=32)
ESTIMATORS = {
    "lsh": dict(K=4, L=8),
    "block_topk": dict(K=1, L=0, estimator="block_topk", offload_quant="int8",
                       block_topk_block_size=64, block_topk_budget_frac=0.5),
}
# name: (weights, estimator, (n_data, n_model), seq_axis, staged prefill)
CASES = {
    **{f"{mesh[0]}x{mesh[1]}{'_ring' if seq else ''}_{est}":
       ("f32", est, mesh, seq, False)
       for mesh, seq in (((1, 4), None), ((2, 2), None), ((2, 2), "data"))
       for est in ESTIMATORS},
    "2x2_staged_block_topk": ("f32", "block_topk", (2, 2), None, True),
    "1x2_w8a8_lsh": ("w8a8", "lsh", (1, 2), None, False),
}


def _inputs():
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, CFG["vocab_size"], n).astype(np.int32)
               for n in PROMPT_LENS]
    tokens = rng.integers(1, CFG["vocab_size"], (STEPS, B)).astype(np.int32)
    return prompts, tokens


# -- the ranks (no JAX here: spawned ranks import this module) ------------------


def _port_run(llm, prompts, tokens, staged):
    pre = []
    for r, p in enumerate(prompts):
        if staged:
            h = llm.start_prefill(p, request_id=r)
            while not h.done:
                h.step()
            pre.append(h.logits.numpy()[0])
        else:
            pre.append(llm.prefill(p, request_id=r).numpy()[0])
    dec = [llm.inference(t).numpy() for t in tokens]
    return np.stack(pre), np.stack(dec), llm.avg_sparsity


def _engine_ranks(rank, trees, bank, cases):
    from magicpig_tpu_torch.models.convert import params_from_numpy
    from magicpig_tpu_torch.parallel.mesh import (
        axis_size,
        make_mesh,
        make_multihost_mesh,
        shard_engine,
    )
    from magicpig_tpu_torch.runtime.engine import LLM

    prompts, tokens = _inputs()
    cfg = ModelConfig(**CFG, dtype=torch.float32)
    params = {k: params_from_numpy(t, device="cpu") for k, t in trees.items()}

    def engine(weights, est):
        return LLM(cfg, batch_size=B, max_length=MAX_LEN, chunk_size=CHUNK,
                   params=params[weights],
                   lsh=LSHConfig(**ESTIMATORS[est], **LSH_KW),
                   projections=torch.from_numpy(bank), device="cpu")

    out = {"unsharded": {}}
    for name, (weights, est, (nd, nm), seq, staged) in cases.items():
        if rank == 0 and (weights, est) not in out["unsharded"]:
            out["unsharded"][weights, est] = _port_run(
                engine(weights, est), prompts, tokens, False)
        mesh = make_mesh(nd, nm)
        if mesh.get_coordinate() is None:
            out[name] = None
            continue
        llm = shard_engine(engine(weights, est), mesh, seq_axis=seq)
        out[name] = _port_run(llm, prompts, tokens, staged)
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    mesh = make_multihost_mesh()
    out["multihost"] = (axis_size(mesh, "data"), axis_size(mesh, "model"),
                        tuple(mesh.get_coordinate()))
    return out


# -- the JAX side ---------------------------------------------------------------


def _jax_engine(est, params, bank):
    import jax.numpy as jnp

    from magicpig_tpu.config import LSHConfig as JLSHConfig
    from magicpig_tpu.config import ModelConfig as JModelConfig
    from magicpig_tpu.runtime.engine import LLM as JLLM

    lsh = JLSHConfig(**ESTIMATORS[est], **LSH_KW, use_pallas="off")
    llm = JLLM(JModelConfig(**CFG, dtype=jnp.float32), batch_size=B,
               max_length=MAX_LEN, chunk_size=CHUNK, lsh=lsh, params=params)
    llm.projections = jnp.asarray(bank)
    return llm


def _jax_run(llm, prompts, tokens, staged=False):
    pre = []
    for r, p in enumerate(prompts):
        if staged:
            h = llm.start_prefill(p, request_id=r)
            while not h.done:
                h.step()
            pre.append(np.asarray(h.logits)[0])
        else:
            pre.append(np.asarray(llm.prefill(p, request_id=r))[0])
    dec = [np.asarray(llm.inference(t)) for t in tokens]
    return np.stack(pre), np.stack(dec), float(llm.avg_sparsity)


def _weights():
    """Numpy trees of the f32 and W8A8 weights (`params_from_numpy`'s
    layout, drawn by the port on the CPU), and the hash bank."""
    from magicpig_tpu_torch.models.llama import init_params, quantize_params

    gen = torch.Generator().manual_seed(3)
    tp = init_params(ModelConfig(**CFG, dtype=torch.float32), MAX_LEN, gen,
                     "cpu")
    tree = lambda p: _numpy_tree(dataclasses.asdict(p))
    bank = np.random.default_rng(5).standard_normal(
        (CFG["head_dim"], 4 * 8)).astype(np.float32)
    return {"f32": tree(tp), "w8a8": tree(quantize_params(tp, bits=8)),
            "w4": tree(quantize_params(tp, bits=4))}, bank


def _numpy_tree(d):
    """A nested dict of tensors as one of numpy arrays."""
    if isinstance(d, dict):
        return {k: _numpy_tree(v) for k, v in d.items()}
    return None if d is None else d.numpy()


def _jax_params(tree):
    """JAX `LlamaParams` from a numpy tree."""
    import jax.numpy as jnp

    from magicpig_tpu.models import llama as jllama

    def w(a):
        if isinstance(a, dict):
            kind = (jllama.Quant4Weight if a["scale"].ndim == a["q"].ndim
                    else jllama.QuantWeight)
            return kind(q=jnp.asarray(a["q"]), scale=jnp.asarray(a["scale"]))
        return None if a is None else jnp.asarray(a)

    layers = jllama.LayerParams(**{k: w(v) for k, v in tree["layers"].items()})
    return jllama.LlamaParams(layers=layers, **{
        k: w(v) for k, v in tree.items() if k != "layers"})


@pytest.fixture(scope="module")
def runs():
    """{case: (the sharded port's results on every rank, the unsharded
    port's, the unsharded JAX engine's, JAX's sharded engine's)}."""
    from magicpig_tpu.parallel.mesh import make_mesh, shard_engine

    trees, bank = _weights()
    prompts, tokens = _inputs()
    jp = {k: _jax_params(trees[k]) for k in ("f32", "w8a8")}

    def unsharded(key):
        weights, est = key
        return _jax_run(_jax_engine(est, jp[weights], bank), prompts, tokens)

    def sharded(case):
        weights, est, (nd, nm), seq, staged = case
        mesh = make_mesh(nd, nm)
        llm = shard_engine(_jax_engine(est, jp[weights], bank), mesh,
                           seq_axis=seq)
        with mesh:
            return _jax_run(llm, prompts, tokens, staged)

    keys = sorted({case[:2] for case in CASES.values()})
    with ThreadPoolExecutor(5) as pool:     # the ranks run while JAX runs
        port = pool.submit(launch, _engine_ranks, WORLD, trees, bank, CASES,
                           device="cpu", timeout=300)
        ref = dict(zip(keys, pool.map(unsharded, keys)))
        shard = dict(zip(CASES, pool.map(sharded, CASES.values())))
        ranks = port.result()
    port_ref = ranks[0]["unsharded"]
    out = {name: ([r[name] for r in ranks], port_ref[case[:2]],
                  ref[case[:2]], shard[name])
           for name, case in CASES.items()}
    out["multihost"] = [r["multihost"] for r in ranks]
    return out


def _jax_tol(name, want):
    """The port-vs-JAX bound of a case's configuration: JAX's own where
    the two unsharded engines agree to 1e-5 (exact weights and offload),
    else the gap the unsharded engines are held to, of the largest logit."""
    weights, est, (nd, nm) = CASES[name][:3]
    tol = TP_TOL if (nd, nm) == (1, 4) else LOGIT_TOL
    if weights == "w8a8":
        return W8_TOL * np.abs(want).max()
    if "offload_quant" in ESTIMATORS[est]:
        return INT8_TOL * np.abs(want).max()
    return tol


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_engine_matches_jax(runs, name):
    ranks, port_ref, jax_ref, jax_sharded = runs[name]
    nd, nm = CASES[name][2]
    live = ranks[:nd * nm]
    assert all(r is None for r in ranks[nd * nm:])
    for r in live[1:]:              # every rank returns the same results
        for a, b in zip(r, live[0]):
            np.testing.assert_array_equal(a, b)
    pre, dec, frac = live[0]
    # The sharding: against the unsharded port at JAX's own tolerances.
    tol = TP_TOL if (nd, nm) == (1, 4) else LOGIT_TOL
    np.testing.assert_allclose(pre, port_ref[0], rtol=tol, atol=tol)
    np.testing.assert_allclose(dec, port_ref[1], rtol=tol, atol=tol)
    assert abs(frac - port_ref[2]) < FRAC_TOL, (frac, port_ref[2])
    # Against the JAX engines, unsharded and sharded at the same mesh.
    for want in (jax_ref, jax_sharded):
        for got, w in ((pre, want[0]), (dec, want[1])):
            t = _jax_tol(name, w)
            np.testing.assert_allclose(got, w, rtol=t, atol=t)
        assert abs(frac - want[2]) < JAX_FRAC_TOL, (frac, want[2])


def test_multihost_mesh_puts_model_inside_a_host(runs):
    assert runs["multihost"] == [(2, 2, (r // 2, r % 2)) for r in range(WORLD)]


# -- the splits ---------------------------------------------------------------------


def _apply_spec(a, spec, n_data, d, n_model, m):
    """numpy slice of `a` that a PartitionSpec gives shard (d, m)."""
    a = np.asarray(a)
    for dim, axis in enumerate(tuple(spec)):
        if axis is None:
            continue
        n, i = (n_data, d) if axis == "data" else (n_model, m)
        size = a.shape[dim] // n
        a = np.take(a, np.arange(i * size, (i + 1) * size), axis=dim)
    return a


@pytest.mark.parametrize("weights", ["f32", "w8a8", "w4"])
def test_param_split_matches_param_pspecs(weights):
    import jax
    from jax.sharding import PartitionSpec as P

    from magicpig_tpu.parallel.mesh import param_pspecs
    from magicpig_tpu_torch.models.convert import params_from_numpy
    from magicpig_tpu_torch.parallel.mesh import shard_params

    tree = _weights()[0][weights]
    jp, tp = _jax_params(tree), params_from_numpy(tree, device="cpu")
    specs = param_pspecs(jp)
    n_model = 2
    for m in range(n_model):
        want = jax.tree_util.tree_map(
            lambda a, s: _apply_spec(a, s, 1, 0, n_model, m), jp, specs,
            is_leaf=lambda x: isinstance(x, P))
        got = shard_params(tp, n_model, m)
        flat_w = jax.tree_util.tree_leaves_with_path(
            dataclasses.asdict(jax.tree_util.tree_map(np.asarray, want)))
        flat_g = dict(jax.tree_util.tree_leaves_with_path(dataclasses.asdict(
            got), is_leaf=lambda x: isinstance(x, torch.Tensor)))
        for path, a in flat_w:
            np.testing.assert_array_equal(flat_g[path].numpy(), a, str(path))


def test_state_split_matches_state_pspecs():
    from magicpig_tpu.parallel.mesh import state_pspecs
    from magicpig_tpu.runtime import state as jstate
    from magicpig_tpu.config import LSHConfig as JLSHConfig
    from magicpig_tpu.config import ModelConfig as JModelConfig
    from magicpig_tpu_torch.parallel.mesh import shard_state
    from magicpig_tpu_torch.runtime import state as tstate

    for est in ESTIMATORS:
        kw = dict(**ESTIMATORS[est], **LSH_KW)
        cfg = ModelConfig(**CFG, dtype=torch.float32)
        full = tstate.init_state(cfg, LSHConfig(**kw), 4, MAX_LEN, "cpu")
        gen = torch.Generator().manual_seed(0)
        for f in dataclasses.fields(full):
            v = getattr(full, f.name)
            for t in v if isinstance(v, list) else [v]:
                t.copy_(torch.randint(-100, 100, t.shape, generator=gen))
        specs = state_pspecs(jstate.init_state(
            JModelConfig(**CFG), JLSHConfig(**kw), 4, MAX_LEN))
        for d, m in ((0, 0), (1, 1), (0, 1)):
            got = shard_state(full, 2, d, 2, m)
            for f in dataclasses.fields(full):
                v, g, s = (getattr(x, f.name) for x in (full, got, specs))
                pairs = zip(v, g, s) if isinstance(v, list) else [(v, g, s)]
                for t, gt, spec in pairs:
                    np.testing.assert_array_equal(
                        gt.numpy(), _apply_spec(t.numpy(), spec, 2, d, 2, m),
                        f.name)


def test_shard_engine_refuses_what_does_not_split():
    from magicpig_tpu_torch.models.llama import fuse_params, quantize_params
    from magicpig_tpu_torch.parallel.mesh import check_split
    from magicpig_tpu_torch.runtime.engine import LLM

    cfg = ModelConfig(**CFG, dtype=torch.float32)
    llm = LLM(cfg, max_length=MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="fused"):
        check_split(fuse_params(quantize_params(llm.params)), 2)
    with pytest.raises(ValueError, match="groups"):
        check_split(quantize_params(llm.params, bits=4), 4)
    check_split(llm.params, 4)


def _never_called(rank):
    raise AssertionError("a rank was started")


def test_ranks_run_on_the_card_unless_the_caller_asks_for_the_cpu(monkeypatch):
    """`launch` and `init_process` default to the card and raise where
    there is none, before a rank starts or a group forms."""
    from magicpig_tpu_torch.parallel.launch import init_process, rank_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch(_never_called, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_process(0, 1, "gloo", "unused-store")
    with pytest.raises(ValueError, match="device"):
        launch(_never_called, 2, device="tpu")
    assert rank_device(1, "cpu") == torch.device("cpu")


# -- synthetic_prefill on a sharded engine ------------------------------------------

SYN_SEQ = 150
SYN_MESHES = ((1, 2), (2, 1))


def _state_numpy(state) -> dict:
    """Copies of a DecodeState's tensors as numpy arrays (per-layer lists
    as lists), taken before a decode step appends to the state in place."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        out[f.name] = ([t.numpy().copy() for t in v] if isinstance(v, list)
                       else v.numpy().copy())
    return out


def _synthetic_ranks(rank, tree, bank):
    """Each estimator: on rank 0 the unsharded engine's state after
    `synthetic_prefill` and its decode logits on fixed tokens; on every
    rank, at each mesh of SYN_MESHES, its sharded engine's local state,
    the same decode's logits and its (data, model) coordinate."""
    from magicpig_tpu_torch.models.convert import params_from_numpy
    from magicpig_tpu_torch.parallel.mesh import make_mesh, shard_engine
    from magicpig_tpu_torch.runtime.engine import LLM
    from magicpig_tpu_torch.runtime.synthetic import synthetic_prefill

    _, tokens = _inputs()
    cfg = ModelConfig(**CFG, dtype=torch.float32)
    params = params_from_numpy(tree, device="cpu")
    out = {}
    for est in ESTIMATORS:
        def engine():
            return LLM(cfg, batch_size=B, max_length=MAX_LEN, chunk_size=CHUNK,
                       params=params,
                       lsh=LSHConfig(**ESTIMATORS[est], **LSH_KW),
                       projections=torch.from_numpy(bank), device="cpu")

        def decode(llm):
            return np.stack([llm.inference(t).numpy() for t in tokens])

        if rank == 0:
            llm = synthetic_prefill(engine(), SYN_SEQ, seed=4)
            out["unsharded", est] = _state_numpy(llm.state), decode(llm)
        for nd, nm in SYN_MESHES:
            llm = shard_engine(engine(), make_mesh(nd, nm))
            synthetic_prefill(llm, SYN_SEQ, seed=4)
            out[(nd, nm), est] = (_state_numpy(llm.state), decode(llm),
                                  (llm.shard.d, llm.shard.m))
    return out


@pytest.fixture(scope="module")
def synthetic_runs():
    trees, bank = _weights()
    return launch(_synthetic_ranks, 2, trees["f32"], bank, device="cpu",
                  timeout=300)


def _rank_slice(a: np.ndarray, heads: bool, nd: int, d: int, nm: int,
                m: int) -> np.ndarray:
    """Rank (d, m)'s part of an unsharded state array: by request, and by
    kv head for the per-layer arrays (`parallel/mesh.py::shard_state`)."""
    a = np.split(a, nd, axis=0)[d]
    return np.split(a, nm, axis=1)[m] if heads else a


@pytest.mark.parametrize("est", list(ESTIMATORS))
@pytest.mark.parametrize("mesh", SYN_MESHES,
                         ids=[f"{nd}x{nm}" for nd, nm in SYN_MESHES])
def test_synthetic_prefill_fills_each_ranks_slice(synthetic_runs, mesh, est):
    """On a sharded engine `synthetic_prefill` leaves each rank its slice
    of the unsharded engine's state: every rank draws all heads of every
    (layer, request) from the same generator, keeps its kv heads and its
    requests. Lengths, positions, signature bits and int8 rows exactly;
    float caches, means, norms and scales to 1e-6 (the same fills on fewer
    heads); then the decode logits within the sharded engine's bound
    (LOGIT_TOL), every rank's the same."""
    nd, nm = mesh
    full, full_dec = synthetic_runs[0]["unsharded", est]
    decs = []
    for rank in synthetic_runs:
        state, dec, (d, m) = rank[mesh, est]
        decs.append(dec)
        for name, got in state.items():
            want = full[name]
            if name == "step":
                np.testing.assert_array_equal(got, want)
                continue
            pairs = (zip(got, want) if isinstance(got, list)
                     else [(got, want)])
            for g, w in pairs:
                w = _rank_slice(w, isinstance(got, list), nd, d, nm, m)
                assert g.shape == w.shape, name
                if np.issubdtype(g.dtype, np.floating):
                    np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                               err_msg=name)
                else:
                    np.testing.assert_array_equal(g, w, err_msg=name)
        assert state["pos"].tolist() == [SYN_SEQ] * (B // nd)
        np.testing.assert_allclose(dec, full_dec, rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)
    np.testing.assert_array_equal(decs[0], decs[1])

"""The port's engine at the head shapes of the kernels' general tile and of
the small head dims, against the JAX `LLM`, on the CPU in float32.

Tiny two-layer models (layer 0 dense, layer 1 sparse) of llama-tiny's
width with the head shapes that public Llama-architecture models have and
the kernels' exact instances do not take: SmolLM2-360M's group of 3 at
head dim 64 (6 query heads over 2), Mistral-Small-Instruct-2409's group
of 6 at head dim 128 (6 over 1), Llama-3.1-405B's group of 16 at 128 (16
over 1, two blocks of the general tile a kv head on the card), and a group
of 4 at head dim 32 (8 over 2: llama-tiny's shape at twice its head dim).
Each under LSH masked at even L (K=10, L=150: the fused kernel's path)
and odd L (K=8, L=75: the scan and the masked attend), and at the two
shapes the card serves (SmolLM2's, the 405B's) block_topk over int8 K/V
(16-token blocks, the rescore pipeline; its kernels' plain versions at the
other two shapes are held to JAX's Pallas kernels in
`tests/test_torch_block_kernels.py`); prefill and 2 decode
steps, both engines fed JAX's greedy tokens, on weights the port draws
once a shape (`_weights`; JAX's own draw compiles for seconds a shape). JAX runs block_topk through
its Pallas kernels in interpret mode (`use_pallas="on"`), whose arithmetic
the port's follows (`tests/test_torch_engine.py`, its group-3 modes).

Tolerances, those `tests/test_torch_engine.py` holds its exact-weight
modes to: every step's logits within 5e-3 of the largest
(`D128_EXACT_TOL`; int8 offload rounds the dequantized K/V), the greedy
tokens equal, the sampled or realized fraction within 2e-3.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicpig_tpu.config import LSHConfig as JLSHConfig
from magicpig_tpu.config import preset as jpreset
from magicpig_tpu.models import llama as jllama
from magicpig_tpu.runtime.engine import LLM as JLLM
from magicpig_tpu_torch.config import LSHConfig, preset
from magicpig_tpu_torch.models.llama import init_params
from magicpig_tpu_torch.runtime.engine import LLM

EXACT_TOL = 5e-3
FRAC_TOL = 2e-3
MAX_LEN = 512
STEPS = 2
LSH_KW = dict(K=10, L=150, num_sink_tokens=4, num_local_tokens=16,
              generation_buffer=32)
MODES = {
    "lsh": dict(LSH_KW),
    "odd_l": dict(LSH_KW, K=8, L=75),
    "block_topk": dict(LSH_KW, K=1, L=0, estimator="block_topk",
                       offload_quant="int8", block_topk_block_size=16),
}
# (query heads, kv heads, head dim): group sizes 3, 6, 16 and 4.
SHAPES = {"g3-d64": (6, 2, 64), "g6-d128": (6, 1, 128),
          "g16-d128": (16, 1, 128), "g4-d32": (8, 2, 32)}
# (shape, mode) runs: every shape in LSH and odd L, block_topk at the
# served shapes (one JAX Pallas run in interpret mode costs ~5 s).
RUNS = [(s, m) for s in SHAPES for m in ("lsh", "odd_l")] + [
    ("g3-d64", "block_topk"), ("g16-d128", "block_topk")]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the engines' many small CPU ops (beside the
    other test workers, one thread a core oversubscribes the host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(shape):
    hq, hkv, d = SHAPES[shape]
    heads = dict(num_hidden_layers=2, num_attention_heads=hq,
                 num_key_value_heads=hkv, head_dim=d)
    return (dataclasses.replace(jpreset("llama-tiny"), dtype=jnp.float32,
                                **heads),
            dataclasses.replace(preset("llama-tiny"), dtype=torch.float32,
                                **heads))


@functools.lru_cache(maxsize=None)
def _weights(shape):
    """The port's f32 weights of a shape (seed 2) and the same weights as
    JAX `LlamaParams`."""
    _, tcfg = _configs(shape)
    tp = init_params(tcfg, MAX_LEN, torch.Generator().manual_seed(2), "cpu")

    def j(a):
        return None if a is None else jnp.asarray(a.numpy())

    layers = jllama.LayerParams(**{k: j(v) for k, v in dataclasses.asdict(
        tp.layers).items()})
    return tp, jllama.LlamaParams(layers=layers, **{
        f.name: j(getattr(tp, f.name)) for f in dataclasses.fields(tp)
        if f.name != "layers"})


@pytest.fixture(scope="module", params=RUNS,
                ids=lambda p: f"{p[0]}-{p[1]}")
def runs(request):
    """Prefill + STEPS decode steps of both engines on JAX's greedy tokens:
    ([logits per call], fraction) for JAX and for the port."""
    shape, mode = request.param
    d = SHAPES[shape][2]
    kw = MODES[mode]
    jcfg, tcfg = _configs(shape)
    tp, jp = _weights(shape)
    bank = np.random.default_rng(44).standard_normal(
        (d, max(kw["K"], 1) * max(kw["L"], 1))).astype(np.float32)
    pallas = kw.get("estimator") == "block_topk"
    jl = JLLM(jcfg, max_length=MAX_LEN, chunk_size=64, params=jp,
              lsh=JLSHConfig(**kw, use_pallas="on" if pallas else "auto"))
    jl.projections = jnp.asarray(bank)
    tl = LLM(tcfg, max_length=MAX_LEN, params=tp, lsh=LSHConfig(**kw),
             projections=torch.from_numpy(bank), device="cpu")
    prompt = np.random.default_rng(6).integers(
        1, tcfg.vocab_size, 300).astype(np.int32)
    jlog = [np.asarray(jl.prefill(prompt))]
    tlog = [tl.prefill(prompt).numpy()]
    for _ in range(STEPS):
        tok = int(jlog[-1][0].argmax())
        jlog.append(np.asarray(jl.inference(np.asarray([tok]))))
        tlog.append(tl.inference(torch.tensor([tok])).numpy())
    return (jlog, jl.avg_sparsity), (tlog, tl.avg_sparsity)


def test_forms_logits_and_tokens_match_jax(runs):
    (jlog, _), (tlog, _) = runs
    for got, want in zip(tlog, jlog):
        assert float(np.abs(got - want).max() / np.abs(want).max()) < EXACT_TOL
    assert ([int(x[0].argmax()) for x in tlog]
            == [int(x[0].argmax()) for x in jlog])


def test_forms_fraction_matches_jax(runs):
    (_, jsp), (_, tsp) = runs
    assert 0 < tsp < 1
    assert tsp == pytest.approx(jsp, abs=FRAC_TOL)

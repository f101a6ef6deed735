"""The compiled decode step on the card: `LLM.inference` and
`LLM.decode_steps` replay a CUDA graph of one whole step (`DecodeGraph`,
`runtime/engine.py`) after one eager step, and must give what the eager
step `LLM._decode` gives.

Each test takes the `cuda` fixture and skips without a card. This file
imports no JAX, so it also runs on the card machine, which has none:

    python3 -m pytest --noconftest tests/test_torch_graph_cuda.py

Engines: two layers at Llama-3.2-1B width (layer 0 dense, layer 1 sparse),
batch 2, prompts of 1500 and 900 tokens, random weights from a seed. The
graphed step runs the same kernels in the same order on the same inputs as
the eager one, and every hand-written kernel is deterministic, so logits
are compared bit for bit (`torch.equal`) and launch counts exactly.
"""

import dataclasses

import pytest
import torch

from magicpig_tpu_torch.config import LSHConfig, preset
from magicpig_tpu_torch.ops.kernels import (LAUNCHES, W4_SHAPE_LAUNCHES,
                                            reset_launches)
from magicpig_tpu_torch.ops.kernels.flash_decode import _outgrown, device_state
from magicpig_tpu_torch.ops.sampling import greedy_sample
from magicpig_tpu_torch.runtime.engine import LLM, graph_kernel_nodes

# Each form of the step a phase-3 serve of `chip_smoke.py` runs, as (the
# engine's LSHConfig, its weight quantization).
FORMS = {
    "lsh_bf16": (LSHConfig(), "none"),
    "lsh_int8": (LSHConfig(offload_quant="int8"), "none"),
    "sampled": (LSHConfig(decode_mode="sampled"), "none"),
    "odd_l": (LSHConfig(K=8, L=75), "none"),
    "block_topk_int8": (LSHConfig(estimator="block_topk",
                                  offload_quant="int8"), "none"),
    "block_topk_int4": (LSHConfig(estimator="block_topk",
                                  offload_quant="int4"), "none"),
    "dense_int8_w4": (LSHConfig(K=0, L=0, dense_quant="int8"), "int4"),
    "w8a8": (LSHConfig(offload_quant="int8"), "int8"),
    # The reference's baselines in plain PyTorch, layer 1 sparse (their
    # default keeps layers {0, 1} dense).
    "quest": (LSHConfig(estimator="quest", dense_layers=(0,)), "none"),
    "topk": (LSHConfig(estimator="topk", dense_layers=(0,)), "none"),
    "oracle_sampling": (LSHConfig(estimator="oracle_sampling",
                                  dense_layers=(0,)), "none"),
}
# The hand-written kernels, as their names appear in the profiler.
OWN_KERNELS = ("flash_decode_kernel", "lsh_split_kernel",
               "collision_words_kernel", "block_score_kernel",
               "rescore_attend_kernel", "block_attend_kernel",
               "w4_matmul_kernel")


@pytest.fixture
def cuda():
    """The card; the tests skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphed step runs only there")
    return torch.device("cuda")


def _engine(dev, form, batch_size=2, seed=3):
    lsh, weight_quant = FORMS[form]
    cfg = dataclasses.replace(preset("llama-3.2-1b"), num_hidden_layers=2,
                              weight_quant=weight_quant,
                              fuse_small_linears=weight_quant != "none")
    return LLM(cfg, batch_size=batch_size, max_length=2048, lsh=lsh,
               device=dev, seed=seed)


def _prompts(llm, seed=5, lengths=(1500, 900)):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randint(1, llm.config.vocab_size, (n,), generator=gen)
            for n in lengths[:llm.batch_size]]


def _prefill(llm, prompts):
    """Prefill each prompt into its slot; the greedy first tokens [B]."""
    return torch.cat([llm.prefill(p, request_id=i).argmax(-1)
                      for i, p in enumerate(prompts)])


def _run(step, tokens, n):
    """n greedy steps of `step` (tokens -> logits): (inputs, logits)."""
    inputs, logits = [], []
    for _ in range(n):
        out = step(tokens)
        inputs.append(tokens)
        logits.append(out)
        tokens = out.argmax(-1)
    return inputs, logits


def _eager(llm, prompts, inputs):
    """clear(), the prompts again, and the eager step on `inputs`."""
    llm.clear()
    _prefill(llm, prompts)
    return [llm._decode(tokens)[0] for tokens in inputs]


@pytest.mark.parametrize("form", sorted(FORMS))
def test_cuda_graphed_step_equals_eager(cuda, form):
    """8 steps through `inference` (the first eager, the rest replays)
    against the eager step on the same tokens after clear() and the same
    prefills: logits bit for bit, and the same kernel launches counted."""
    llm = _engine(cuda, form)
    prompts = _prompts(llm)
    first = _prefill(llm, prompts)
    reset_launches()
    inputs, graphed = _run(llm.inference, first, 8)
    counted = dict(LAUNCHES), dict(W4_SHAPE_LAUNCHES)
    assert llm._graph is not None
    llm.clear()
    _prefill(llm, prompts)
    reset_launches()
    eager = [llm._decode(tokens)[0] for tokens in inputs]
    assert (dict(LAUNCHES), dict(W4_SHAPE_LAUNCHES)) == counted
    assert sum(counted[0].values()) > 0
    for step, (g, e) in enumerate(zip(graphed, eager)):
        assert torch.equal(g, e), f"step {step}: max |diff| {(g - e).abs().max()}"


@pytest.mark.parametrize("form", ["lsh_bf16", "block_topk_int8"])
def test_cuda_decode_steps_graphed_equals_inference_loop(cuda, form):
    """`decode_steps` (the greedy token kept on the card across replays, in
    two calls) gives the tokens and sparsity of an `inference` loop on a
    twin engine."""
    a, b = _engine(cuda, form), _engine(cuda, form)
    first = _prefill(a, _prompts(a))
    assert torch.equal(_prefill(b, _prompts(b)), first)
    toks = a.decode_steps(first, 5)
    toks = torch.cat([toks, a.decode_steps(toks[-1], 4)])
    _, logits = _run(b.inference, first, 9)
    loop = torch.stack([l.argmax(-1) for l in logits]).to(torch.int32)
    assert torch.equal(toks, loop)
    # decode_steps sums a call's fractions in float32 before adding them.
    assert a.avg_sparsity == pytest.approx(b.avg_sparsity, rel=1e-6)


def test_cuda_clear_and_new_prefill_replay_the_same_graph(cuda):
    """After clear() and other prompts, the engine replays the graph it
    captured before, and the replay equals the eager step."""
    llm = _engine(cuda, "lsh_bf16")
    _run(llm.inference, _prefill(llm, _prompts(llm)), 4)
    graph = llm._graph
    llm.clear()
    other = _prompts(llm, seed=11, lengths=(1300, 1700))
    inputs, graphed = _run(llm.inference, _prefill(llm, other), 6)
    assert llm._graph is graph
    for g, e in zip(graphed, _eager(llm, other, inputs)):
        assert torch.equal(g, e)


def test_cuda_graph_keeps_its_tickets_when_another_engine_grows_them(cuda):
    """Engine A captures its step; the merge tickets then grow (engine B at
    batch 4 and a direct request for more), and small blocks of the size
    of A's tickets are allocated and filled with -1, which would take
    their memory were it freed: A's replays still equal its eager step,
    since the tickets it captured stay allocated."""
    a = _engine(cuda, "lsh_bf16", batch_size=1)
    prompts = _prompts(a)
    _run(a.inference, _prefill(a, prompts), 2)
    tickets = device_state(cuda, 1)[0]
    captured, pairs = tickets.data_ptr(), tickets.numel()
    del tickets
    b = _engine(cuda, "block_topk_int8", batch_size=4, seed=4)
    _run(b.inference, _prefill(b, _prompts(b, lengths=(1500, 900, 700, 1100))), 3)
    device_state(cuda, 4 * pairs)
    assert device_state(cuda, 1)[0].data_ptr() != captured
    assert any(t.data_ptr() == captured for t in _outgrown)
    del b
    junk = [torch.full((pairs,), -1, dtype=torch.int32, device=cuda)
            for _ in range(256)]
    a.clear()
    inputs, graphed = _run(a.inference, _prefill(a, prompts), 5)
    del junk
    for g, e in zip(graphed, _eager(a, prompts, inputs)):
        assert torch.equal(g, e)


def _eager_kernels(llm, tokens):
    """Kernels of one eager step (`_decode` and the greedy token) by the
    profiler, the fullest of three sessions: (all kernels, the
    hand-written ones). In a process that has run many kernels the
    profiler loses the first few kernel records of a session (five after
    the kernel tests, the first ops of the step; a capture of the same
    step holds them all), so 32 sleep kernels go first and are not
    counted."""
    from torch.profiler import ProfilerActivity, profile

    best = (0, 0)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(32):
                torch.cuda._sleep(1000)
            greedy_sample(llm._decode(tokens)[0])
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "spin_kernel" not in e.name
                  and not e.name.startswith(("Memcpy", "Memset"))]
        own = sum(any(k in e.name for k in OWN_KERNELS) for e in events)
        best = max(best, (len(events), own))
    return best


@pytest.mark.parametrize("form", ["lsh_bf16", "sampled", "dense_int8_w4"])
def test_cuda_graph_nodes_are_the_eager_kernels(cuda, form):
    """The captured step's kernel nodes are the eager step's kernels: its
    hand-written launches (as counted) plus its PyTorch ops."""
    llm = _engine(cuda, form)
    inputs, _ = _run(llm.inference, _prefill(llm, _prompts(llm)), 2)
    reset_launches()
    total, own = _eager_kernels(llm, inputs[-1])
    assert own == sum(LAUNCHES.values()) // 3 > 0
    assert graph_kernel_nodes(llm._graph.graph) == total


def test_cuda_oracle_sampling_draws_new_ids_at_each_replay(cuda, monkeypatch):
    """Oracle sampling's ids come from the state's decode step and the
    layer: inside the captured step each replay draws new ids, and a fresh
    engine with the same seed, fed the same prompts, draws the same ones.
    The ids are copied out of the step (a copy the capture records) into a
    buffer the first, eager step allocates."""
    from magicpig_tpu_torch.ops import baselines

    inner, buf = baselines.sample_ids, []

    def recording(scores, u):
        ids = inner(scores, u)
        if not buf:
            buf.append(torch.zeros_like(ids))
        buf[0].copy_(ids)
        return ids

    monkeypatch.setattr(baselines, "sample_ids", recording)
    runs = []
    for _ in range(2):
        buf.clear()
        llm = _engine(cuda, "oracle_sampling")
        tokens = _prefill(llm, _prompts(llm))
        ids = []
        for _ in range(4):
            tokens = llm.inference(tokens).argmax(-1)
            ids.append(buf[0].clone())
        assert llm._graph is not None and int(llm.state.step) == 4
        runs.append(ids)
    for a, b in zip(runs[0][1:], runs[0][2:]):
        assert not torch.equal(a, b)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_cuda_graphed_step_equals_eager_llama_8b_width(cuda):
    """Two layers at Llama-3.1-8B width (hidden 4096, 32/8 heads of 128,
    vocab 128256, untied lm_head; layer 0 dense, layer 1 sparse under LSH
    K=10, L=150): the d = 128 forms of the decode and fused LSH kernels in
    the graphed step, which must equal the eager step bit for bit with the
    same launches counted."""
    cfg = dataclasses.replace(preset("llama-3.1-8b"), num_hidden_layers=2)
    llm = LLM(cfg, batch_size=2, max_length=2048, lsh=LSHConfig(),
              device=cuda, seed=3)
    prompts = _prompts(llm)
    first = _prefill(llm, prompts)
    reset_launches()
    inputs, graphed = _run(llm.inference, first, 8)
    counted = dict(LAUNCHES)
    assert llm._graph is not None
    assert counted["flash_decode_d128"] == 16
    assert counted["lsh_fused_decode_d128"] == 8
    assert sum(counted.values()) == 24
    llm.clear()
    _prefill(llm, prompts)
    reset_launches()
    eager = [llm._decode(tokens)[0] for tokens in inputs]
    assert dict(LAUNCHES) == counted
    for step, (g, e) in enumerate(zip(graphed, eager)):
        assert torch.equal(g, e), f"step {step}: max |diff| {(g - e).abs().max()}"


@pytest.mark.parametrize("lsh,forms", [
    (LSHConfig(), ("lsh_fused_decode_d128",)),
    (LSHConfig(K=8, L=75), ("collision_words", "lsh_masked_attention_d128"))],
    ids=["lsh", "odd_l"])
def test_cuda_graphed_step_equals_eager_llama_3b_width(cuda, lsh, forms):
    """Two layers at Llama-3.2-3B width (hidden 3072, 24/8 heads of 128:
    group size 3; tied embeddings; layer 0 dense, layer 1 sparse) under LSH
    K=10, L=150 (the fused kernel) and at odd L, K=8, L=75 (the scan and
    the masked attend): the G = 3 forms in the graphed step, which must
    equal the eager step bit for bit with the same launches counted."""
    cfg = dataclasses.replace(preset("llama-3.2-3b"), num_hidden_layers=2)
    llm = LLM(cfg, batch_size=2, max_length=2048, lsh=lsh, device=cuda,
              seed=3)
    prompts = _prompts(llm)
    first = _prefill(llm, prompts)
    reset_launches()
    inputs, graphed = _run(llm.inference, first, 8)
    counted = dict(LAUNCHES)
    assert llm._graph is not None
    assert counted["flash_decode_d128"] == 16
    for name in forms:
        assert counted[name] == 8, name
    assert sum(counted.values()) == 16 + 8 * len(forms)
    llm.clear()
    _prefill(llm, prompts)
    reset_launches()
    eager = [llm._decode(tokens)[0] for tokens in inputs]
    assert dict(LAUNCHES) == counted
    for step, (g, e) in enumerate(zip(graphed, eager)):
        assert torch.equal(g, e), f"step {step}: max |diff| {(g - e).abs().max()}"


# SmolLM2-360M as its published config.json gives it
# (huggingface.co/HuggingFaceTB/SmolLM2-360M, config.json).
SMOLLM2_360M = dict(
    architectures=["LlamaForCausalLM"], vocab_size=49152, hidden_size=960,
    intermediate_size=2560, num_hidden_layers=32, num_attention_heads=15,
    num_key_value_heads=5, hidden_act="silu", rms_norm_eps=1e-5,
    rope_theta=100000, rope_scaling=None, max_position_embeddings=8192,
    tie_word_embeddings=True, bos_token_id=0, eos_token_id=0,
    torch_dtype="bfloat16")


def _graphed_equals_eager(llm, dense, forms):
    """8 graphed steps against the eager step on the same inputs: logits
    bit for bit, the same launches (`dense` twice a step, each of `forms`
    once)."""
    prompts = _prompts(llm)
    first = _prefill(llm, prompts)
    reset_launches()
    inputs, graphed = _run(llm.inference, first, 8)
    counted = dict(LAUNCHES)
    assert llm._graph is not None
    assert counted[dense] == 16
    for name in forms:
        assert counted[name] == 8, name
    assert sum(counted.values()) == 16 + 8 * len(forms)
    llm.clear()
    _prefill(llm, prompts)
    reset_launches()
    eager = [llm._decode(tokens)[0] for tokens in inputs]
    assert dict(LAUNCHES) == counted
    for step, (g, e) in enumerate(zip(graphed, eager)):
        assert torch.equal(g, e), f"step {step}: max |diff| {(g - e).abs().max()}"


@pytest.mark.parametrize("lsh,forms", [
    (LSHConfig(), ("lsh_fused_decode_g3",)),
    (LSHConfig(K=8, L=75), ("collision_words", "lsh_masked_attention_g3")),
    (LSHConfig(estimator="block_topk", offload_quant="int8"),
     ("block_rank_g3", "rescore_attend_g3"))],
    ids=["lsh", "odd_l", "block_topk_int8"])
def test_cuda_graphed_step_equals_eager_smollm2_width(cuda, lsh, forms):
    """Two layers at SmolLM2-360M's width (hidden 960, 15/5 heads of 64:
    group size 3 at head dim 64, the kernels' general tile; tied
    embeddings; the config from its config.json values through
    `from_hf_config`; layer 0 dense, layer 1 sparse) under LSH, odd L and
    block_topk over int8 offload: the "_g3" forms in the graphed step, bit
    for bit the eager step's, the same launches counted."""
    from magicpig_tpu_torch.config import ModelConfig

    cfg = ModelConfig.from_hf_config(dict(SMOLLM2_360M, num_hidden_layers=2),
                                     name="smollm2-360m")
    llm = LLM(cfg, batch_size=2, max_length=2048,
              lsh=dataclasses.replace(lsh, dense_layers=(0,)), device=cuda,
              seed=3)
    _graphed_equals_eager(llm, "flash_decode_g3", forms)


@pytest.mark.parametrize("d", [16, 32])
def test_cuda_graphed_step_equals_eager_small_head_dims(cuda, d):
    """Two layers of llama-tiny (8/2 heads of 16) and of the same model at
    head dim 32 under LSH K=10, L=150: the "_d16" / "_d32" forms in the
    graphed step, bit for bit the eager step's."""
    cfg = dataclasses.replace(preset("llama-tiny"), num_hidden_layers=2,
                              head_dim=d)
    llm = LLM(cfg, batch_size=2, max_length=2048,
              lsh=LSHConfig(dense_layers=(0,)), device=cuda, seed=3)
    _graphed_equals_eager(llm, f"flash_decode_d{d}", (f"lsh_fused_decode_d{d}",))


def test_cuda_graphed_step_equals_eager_llama_8b_width_block_topk4(cuda):
    """Two layers at Llama-3.1-8B width under `bench.py`'s block_topk4 mode
    (W8A8 fused weights; layer 0 dense over int8 K/V, layer 1 block_topk
    over packed int4 K and int8 V): the d = 128 forms of the int8 decode,
    the bf16 hot decode, the packed scorer and the packed rescore-attend in
    the graphed step, which must equal the eager step bit for bit with the
    same launches counted."""
    cfg = dataclasses.replace(preset("llama-3.1-8b"), num_hidden_layers=2,
                              weight_quant="int8", fuse_small_linears=True)
    lsh = LSHConfig(K=1, L=0, estimator="block_topk", offload_quant="int4",
                    dense_quant="int8")
    llm = LLM(cfg, batch_size=2, max_length=2048, lsh=lsh, device=cuda,
              seed=3)
    prompts = _prompts(llm)
    first = _prefill(llm, prompts)
    reset_launches()
    inputs, graphed = _run(llm.inference, first, 8)
    counted = dict(LAUNCHES)
    assert llm._graph is not None
    for name in ("flash_decode_int8_d128", "flash_decode_d128",
                 "block_rank_int4_d128", "rescore_attend_int4_d128"):
        assert counted[name] == 8, name
    assert sum(counted.values()) == 32
    llm.clear()
    _prefill(llm, prompts)
    reset_launches()
    eager = [llm._decode(tokens)[0] for tokens in inputs]
    assert dict(LAUNCHES) == counted
    for step, (g, e) in enumerate(zip(graphed, eager)):
        assert torch.equal(g, e), f"step {step}: max |diff| {(g - e).abs().max()}"



def _state_tensors(llm):
    st = llm.state
    return [t for f in dataclasses.fields(st)
            for t in (getattr(st, f.name) if isinstance(getattr(st, f.name), list)
                      else [getattr(st, f.name)])]


def _replays_equal_eager(llm, tokens, n):
    """n graphed steps from `tokens`, then the state put back as it was
    before them (in place) and the eager step on the same inputs: logits
    bit for bit."""
    tensors = _state_tensors(llm)
    saved = [t.clone() for t in tensors]
    inputs, graphed = _run(llm.inference, tokens, n)
    for t, s in zip(tensors, saved):
        t.copy_(s)
    for tok, g in zip(inputs, graphed):
        e = llm._decode(tok)[0]
        assert torch.equal(g, e), f"max |diff| {(g - e).abs().max()}"


@pytest.mark.parametrize("form", ["lsh_bf16", "block_topk_int4"])
def test_cuda_graph_survives_chunked_admission_and_release(cuda, form):
    """A graph captured before a `release_slot` and a chunked prefill
    (`start_prefill`, 512-token chunks, flash_prefill at a query offset)
    into the freed slot is not captured again, and its replays after them
    equal the eager step on the same state, bit for bit."""
    llm = _engine(cuda, form)
    llm.chunk_size = 512
    prompts = _prompts(llm)
    _, logits = _run(llm.inference, _prefill(llm, prompts), 3)
    graph = llm._graph
    assert graph is not None and llm.graph_captures == 1
    llm.release_slot(1)
    assert all(int(x[1]) == 0 for x in (llm.state.pos, llm.state.dense_len,
                                        llm.state.hot_len, llm.state.off_len))
    reset_launches()
    cp = llm.start_prefill(_prompts(llm, seed=6, lengths=(1300,))[0],
                           request_id=1)
    while not cp.done:
        cp.step()
    assert cp.n_chunks == 3 and LAUNCHES["flash_prefill"] == 3 * 2
    tokens = torch.stack([logits[-1][0].argmax(), cp.logits[0].argmax()])
    _replays_equal_eager(llm, tokens, 4)
    assert llm._graph is graph and llm.graph_captures == 1


def test_cuda_idle_slot_past_hot_capacity_under_the_graph(cuda):
    """Slot 1 is never filled while slot 0 takes two requests of 250
    steps: the batched step takes slot 1's hot length to 500, past its
    384-row hot cache (the append clamps to the last row, the kernels read
    at most the capacity). The graph replays with no device assert, and
    its last steps equal the eager step on the same state, bit for bit."""
    llm = _engine(cuda, "lsh_bf16")
    for seed in (5, 7):
        (prompt,) = _prompts(llm, seed=seed, lengths=(1500,))
        tok = llm.prefill(prompt, request_id=0).argmax(-1)
        tokens = torch.cat([tok, tok])
        for _ in range(246):
            tokens = llm.inference(tokens).argmax(-1)
        torch.cuda.synchronize()
    assert int(llm.state.hot_len[1]) == 492 > llm.state.hot_k[0].shape[2] == 384
    _replays_equal_eager(llm, tokens, 4)
    torch.cuda.synchronize()
    assert int(llm.state.hot_len[1]) == 496 and llm.graph_captures == 1


@pytest.mark.parametrize("form", ["lsh_bf16", "block_topk_int8"])
def test_cuda_graphed_step_equals_eager_with_sliding_window(cuda, form):
    """A two-layer cut at Mistral-7B's head shape (8/2 heads of 128) with a
    sliding window of 512 tokens (the hot capacity is 384): request 0's
    1500-token prompt has its offload clipped to the window (448 rows) and
    its dense layer bounded by it; request 1's 508-token prompt crosses the
    window during the 8 steps, so that its sinks age one by one (positions
    512 to 515) under the replayed graph, whose bounds come from the state
    on the card at each replay. Logits bit for bit against the eager step,
    launches equal."""
    from magicpig_tpu_torch.config import ModelConfig

    cfg = ModelConfig(name="mistral-cut", vocab_size=32000, hidden_size=1024,
                      intermediate_size=2048, num_hidden_layers=2,
                      num_attention_heads=8, num_key_value_heads=2,
                      head_dim=128, rope_theta=10000.0,
                      max_position_embeddings=32768, eos_token_ids=(2,),
                      sliding_window=512)
    llm = LLM(cfg, batch_size=2, max_length=2048, lsh=FORMS[form][0],
              device=cuda, seed=3)
    prompts = _prompts(llm, lengths=(1500, 508))
    first = _prefill(llm, prompts)
    assert llm.state.off_len.tolist() == [448, 440]
    reset_launches()
    inputs, graphed = _run(llm.inference, first, 8)
    counted = dict(LAUNCHES)
    assert llm._graph is not None and llm.state.pos.tolist() == [1508, 516]
    llm.clear()
    _prefill(llm, prompts)
    reset_launches()
    eager = [llm._decode(tokens)[0] for tokens in inputs]
    assert dict(LAUNCHES) == counted and counted["flash_decode_d128"] == 16
    for step, (g, e) in enumerate(zip(graphed, eager)):
        assert torch.equal(g, e), f"step {step}: max |diff| {(g - e).abs().max()}"


def test_cuda_nccl_one_rank_graph_holds_the_collectives_llama_8b_width(
        cuda, tmp_path):
    """Two layers at Llama-3.1-8B width under LSH, sharded over a 1 x 1
    mesh with NCCL (`parallel/`): the step captured with its collectives
    (the row-split sums, the logits' gathers, the fraction's sum) replays
    to the eager step's logits bit for bit, equals the unsharded engine on
    the same weights bit for bit, and its graph holds more kernel nodes
    than the unsharded step's: the collectives'."""
    import torch.distributed as dist

    from magicpig_tpu_torch.parallel.launch import init_process
    from magicpig_tpu_torch.parallel.mesh import make_mesh, shard_engine
    from magicpig_tpu_torch.parallel.sharded import COLLECTIVES, reset_collectives

    cfg = dataclasses.replace(preset("llama-3.1-8b"), num_hidden_layers=2)
    ref = LLM(cfg, batch_size=2, max_length=2048, lsh=LSHConfig(),
              device=cuda, seed=3)
    prompts = _prompts(ref)
    inputs, want = _run(ref.inference, _prefill(ref, prompts), 8)
    init_process(0, 1, "nccl", str(tmp_path / "store"), "cuda")
    try:
        llm = LLM(cfg, batch_size=2, max_length=2048, lsh=LSHConfig(),
                  params=ref.params, projections=ref.projections, device=cuda)
        shard_engine(llm, make_mesh(1, 1))
        _prefill(llm, prompts)
        reset_launches()
        reset_collectives()
        graphed = [llm.inference(tokens) for tokens in inputs]
        calls = dict(COLLECTIVES)
        assert llm.graph_captures == 1
        assert calls["sum"] == 2 * (2 * 2 + 1) and calls["gather"] == 2 * 2
        assert dict(LAUNCHES)["lsh_fused_decode_d128"] == 8
        nodes = graph_kernel_nodes(llm._graph.graph)
        assert nodes > graph_kernel_nodes(ref._graph.graph)
        eager = _eager(llm, prompts, inputs)
    finally:
        dist.destroy_process_group()
    for step, (g, e, w) in enumerate(zip(graphed, eager, want)):
        assert torch.equal(g, e), f"step {step}: max |diff| {(g - e).abs().max()}"
        assert torch.equal(g, w), f"step {step}: max |diff| {(g - w).abs().max()}"

"""The LLM engine: prefill / start_prefill / inference / decode_steps /
generate / release_slot / clear (port of `magicpig_tpu/runtime/engine.py`,
the single-device path).

PyTorch runs eagerly, so the engine calls the layer functions directly:
`prefill` runs the whole prompt layer by layer through the flash-prefill
kernel and fills the attention-server state; `start_prefill` runs it one
`chunk_size` chunk at a time (`ChunkedPrefill`: each chunk's queries attend
the request's K/V staged so far, through the same kernel at a query
offset), and fills the state from the staged K/V after the last chunk, so
that a scheduler can run decode steps between chunks
(`runtime/serving.py`); a decode step runs every layer
once (dense layers through flash decode, sparse layers through flash decode
over the hot tokens plus the estimator over the offloaded ones: the fused
LSH kernel, for `LSHConfig(estimator="block_topk")` the block scorer and
an attend over the best blocks, or the reference's baselines "quest",
"topk" and "oracle_sampling" in plain PyTorch; `K < 0` selects quest). On the card the first decode step runs
eagerly and creates what the kernels make lazily (the library, the
tickets, kernel attributes); every later step replays a CUDA graph of the
whole step (`DecodeGraph`), as the JAX engine runs one jitted program. On
the CPU every step runs eagerly. `decode_steps` keeps the greedy tokens on
the device and synchronises once. The model's weights follow
`ModelConfig.weight_quant` (bf16, W8A8 or int4 through the packed-nibble
kernel at decode size), and the caches `LSHConfig.offload_quant` and
`dense_quant` (bf16, or int8 rows through the kernels' int8 forms; int4
offload K through the int8 LSH form, or packed through the block kernels'
int4 forms). A config with a sliding window (`ModelConfig.sliding_window`,
Mistral v0.1) takes it through every stage: the prefill's and the chunks'
flash prefill, the sparse fill's offload clip, and the decode step's
flash decode bounds (`runtime/server.py`), eager and graphed alike.

Sharded over a ("data", "model") mesh (`parallel.mesh.shard_engine`),
every rank makes the same calls with the same global arguments (request
ids, [B] tokens) and returns the same global results (logits [B, V],
tokens, the sparsity counters): each rank runs its batch slice at its kv
heads (`layer_config`), sums the row-split products and gathers the
logits (`parallel/sharded.py`). A prompt runs whole on every data rank,
or with `seq_axis` over the ring (`parallel/ring.py`), and its fill lands
in the owning data rank's slot. The step is captured as a CUDA graph
only when every collective is NCCL's (a gloo collective cannot be
captured: those steps run eagerly, and `graph_captures` stays 0).
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from magicpig_tpu_torch.config import LSHConfig, ModelConfig, preset
from magicpig_tpu_torch.models.llama import (
    LlamaParams,
    init_params,
    post_attention,
    qkv_proj,
    unembed,
)
from magicpig_tpu_torch.ops.hashing import make_hash_projections
from magicpig_tpu_torch.ops.kernels import flash_prefill
from magicpig_tpu_torch.ops.kernels._lib import CapturedLaunches
from magicpig_tpu_torch.ops.sampling import greedy_sample, top_p_sample
from magicpig_tpu_torch.parallel.ring import ring_prefill, shard_tokens, unshard_tokens
from magicpig_tpu_torch.runtime import state as state_lib
from magicpig_tpu_torch.runtime.server import (
    decode_dense_layer,
    decode_sparse_layer,
    fill_dense_layer,
    fill_sparse_layer,
)


def resolve_device(device: torch.device | str | None) -> torch.device:
    """The CUDA card unless the caller names another device; with no card
    and no device named, raise rather than run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "plain PyTorch versions on the CPU")
        device = "cuda"
    return torch.device(device)


def graph_kernel_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The kernels a replay of `graph` (captured with `keep_graph=True`)
    launches: its kernel nodes, read through libcuda's graph API."""
    drv = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if drv.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if drv.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kind = ctypes.c_int(-1)
    kernels = 0
    for node in nodes:
        if drv.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        kernels += kind.value == 0             # CU_GRAPH_NODE_TYPE_KERNEL
    return kernels


class DecodeGraph:
    """One decode step captured as a CUDA graph: `decode` (the engine's
    eager step) on a static [B] token buffer, then the greedy next token.
    A replay reads and advances the engine's state in place, so the state's
    buffers must keep their addresses (`state.reset_state`); the outputs are
    static tensors that the next replay overwrites. The graph is kept
    (`keep_graph`) so that its nodes can be counted (`graph_kernel_nodes`)."""

    def __init__(self, decode, batch: int, device: torch.device):
        self.tokens = torch.zeros((batch,), dtype=torch.int64, device=device)
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        with CapturedLaunches() as self.launches, torch.cuda.graph(self.graph):
            self.logits, self.frac = decode(self.tokens)
            self.next = greedy_sample(self.logits)
        self.graph.instantiate()

    def replay(self, tokens: torch.Tensor):
        """(logits [B, V], mean sampled fraction, greedy tokens [B] int32)
        of one step on `tokens`."""
        self.tokens.copy_(tokens)
        self.graph.replay()
        self.launches.replayed()
        return self.logits, self.frac, self.next


class LLM:
    """Sparse-attention decoding engine (LSH sampling by default; `lsh`
    picks the estimator and its options). Without `params` the weights are
    drawn on the device from `seed`, quantized as `config.weight_quant`
    says (one layer at a time); passed-in params may be quantized."""

    def __init__(self, model: str | ModelConfig = "llama-tiny", K: int = 10,
                 L: int = 150, batch_size: int = 1, max_length: int = 8192,
                 generation_buffer: int = 256, chunk_size: int = 8192,
                 params: LlamaParams | None = None, seed: int = 0,
                 lsh: LSHConfig | None = None,
                 projections: torch.Tensor | None = None,
                 device: torch.device | str | None = None):
        self.device = resolve_device(device)
        self.config = preset(model) if isinstance(model, str) else model
        if lsh is None:
            # K < 0 selects the Quest baseline, as in the reference.
            lsh = LSHConfig(K=abs(K), L=L, generation_buffer=generation_buffer,
                            estimator="quest" if K < 0 else "lsh")
        self.lsh = lsh
        window = self.config.sliding_window
        if (window is not None and lsh.enabled
                and window <= state_lib.hot_capacity(lsh)):
            # Only sink tokens may leave the window (decode_sparse_layer):
            # every local and generated hot token must stay inside it.
            raise ValueError(
                f"sliding_window {window} must exceed the hot capacity "
                f"{state_lib.hot_capacity(lsh)} (sink + local + generation "
                "buffer)")
        self.batch_size = batch_size
        self.max_length = max_length
        self.chunk_size = chunk_size
        self.groups = state_lib.layer_groups(self.config, self.lsh)

        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.params = params if params is not None else init_params(
            self.config, max_length, gen, self.device)
        self.projections = (projections.to(self.device, torch.float32)
                            if projections is not None else
                            make_hash_projections(
                                self.config.head_dim, max(self.lsh.K, 1),
                                max(self.lsh.L, 1), gen, self.device))
        self._sample_gen = torch.Generator(device=self.device)
        self._sample_gen.manual_seed(seed + 1)
        self.state = state_lib.init_state(self.config, self.lsh, batch_size,
                                          max_length, self.device)
        # Mean sampled fraction over decode steps (the reference's "Avg
        # Sparsity"), kept across clear(). The sum stays on the device so
        # that a decode step does not wait for the card.
        self._sparsity_sum = torch.zeros((), dtype=torch.float64,
                                         device=self.device)
        self._sparsity_steps = 0
        # Host mirrors of per-slot cache use for the generation-buffer
        # guard: past capacity an append would write out of bounds, so
        # decode entry fails loudly instead.
        self._hot_used: dict[int, int] = {}
        self._pos_used: dict[int, int] = {}
        # On the card: whether a step ran eagerly, then the captured step
        # (captured once: admissions and releases keep the state's buffers).
        self._warmed_up = False
        self._graph: DecodeGraph | None = None
        self.graph_captures = 0
        # start_prefill's staged K/V [n_layers, max_length, Hkv, d] each,
        # allocated at its first call; one chunked prefill at a time.
        self._stage_k: torch.Tensor | None = None
        self._stage_v: torch.Tensor | None = None
        # Set by `parallel.mesh.shard_engine`: the mesh, the prefill's
        # sequence axis and this rank's `Shard`.
        self.mesh = None
        self.seq_axis: str | None = None
        self.shard = None

    @property
    def layer_config(self) -> ModelConfig:
        """The shapes the layers run at: the config, or under a mesh the
        rank's heads, MLP columns and vocabulary shard."""
        return self.config if self.shard is None else self.shard.config

    def _tokens(self, input_ids) -> torch.Tensor:
        if isinstance(input_ids, torch.Tensor):
            return input_ids.reshape(-1).to(self.device, torch.int64)
        ids = np.asarray(input_ids, np.int64).reshape(-1)
        return torch.from_numpy(ids).to(self.device)

    # -- prefill ------------------------------------------------------------

    @torch.no_grad()
    def prefill(self, input_ids, request_id: int = 0) -> torch.Tensor:
        """Prefill one request into slot `request_id`; returns logits [1, V]."""
        cfg, sh = self.layer_config, self.shard
        tokens = self._tokens(input_ids)
        p = self._check_prompt(tokens)
        if sh is not None and sh.n_seq > 1:
            return self._prefill_ring(tokens, request_id)
        params = self.params
        hidden = params.embed[tokens][None]                    # [1, P, h]
        positions = torch.arange(p, device=self.device)[None]
        length = torch.full((1,), p, dtype=torch.int32, device=self.device)
        for i, (kind, gi) in enumerate(self.groups):
            lp = params.layers.layer(i)
            q, k, v = qkv_proj(lp, cfg, hidden, positions, params.cos, params.sin)
            attn = flash_prefill(q, k, v, length,
                                 window=cfg.sliding_window)    # [1, P, Hq, d]
            hidden = post_attention(lp, cfg, attn.reshape(1, p, -1), hidden, sh)
            self._fill(kind, gi, request_id, k[0], v[0])
        logits = self._logits(hidden[:, -1])                   # [1, V]
        self._admitted(request_id, p)
        return logits

    def _fill(self, kind: str, gi: int, request_id: int, k: torch.Tensor,
              v: torch.Tensor) -> None:
        """One layer's fill of request `request_id` from its prompt K/V
        [P, Hkv, d] (under a mesh: on the owning data rank only, into its
        local slot, at the rank's kv heads)."""
        sh = self.shard
        if sh is not None:
            if not sh.owns(request_id):
                return
            request_id = sh.slot(request_id)
        if kind == "dense":
            fill_dense_layer(self.state, gi, request_id, k, v)
        else:
            fill_sparse_layer(self.state, gi, request_id, k, v,
                              self.projections, self.lsh,
                              self.config.sliding_window)

    def _logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """f32 logits [rows, V] of final hidden rows (under a mesh, the
        vocabulary shards gathered over "model")."""
        logits = unembed(self.params, self.layer_config, hidden)
        return logits if self.shard is None else self.shard.gather_vocab(logits)

    def _prefill_ring(self, tokens: torch.Tensor, request_id: int) -> torch.Tensor:
        """`prefill` with the prompt's sequence split over the seq axis:
        padded with token 0 to whole chunks of min(chunk_size, max_length)
        (`shard_engine` makes them split into 2 x N zigzag chunks), each
        rank runs its tokens through every layer, attention through the
        ring, and the owning data rank gathers each layer's K/V for its
        fill. Pad tokens lie after the prompt, so no prompt token attends
        them."""
        cfg, sh, params = self.layer_config, self.shard, self.params
        p = tokens.shape[0]
        n, r, layout = sh.n_seq, sh.seq_rank, "zigzag"
        c = min(self.chunk_size, self.max_length)
        p_pad = -(-p // c) * c
        padded = torch.zeros((1, p_pad), dtype=torch.int64, device=self.device)
        padded[0, :p] = tokens
        # Pad positions past the RoPE table take its last row.
        positions = torch.arange(p_pad, device=self.device).clamp(
            max=params.cos.shape[0] - 1)[None]
        local = shard_tokens(padded, n, r, layout)               # [1, P/N]
        positions = shard_tokens(positions, n, r, layout)
        sl = local.shape[1]
        hidden = params.embed[local]                             # [1, P/N, h]
        for i, (kind, gi) in enumerate(self.groups):
            lp = params.layers.layer(i)
            q, k, v = qkv_proj(lp, cfg, hidden, positions, params.cos, params.sin)
            attn = ring_prefill(q, k, v, self.mesh, self.seq_axis, layout)
            hidden = post_attention(lp, cfg, attn.reshape(1, sl, -1), hidden, sh)
            k_all = unshard_tokens(sh.gather_seq(k[0]), layout, dim=0)[:p]
            v_all = unshard_tokens(sh.gather_seq(v[0]), layout, dim=0)[:p]
            self._fill(kind, gi, request_id, k_all, v_all)
        # The last prompt token's hidden row, from the rank that holds it
        # (the others add zeros).
        where = shard_tokens(torch.arange(p_pad, device=self.device)[None],
                             n, r, layout)[0]
        last = (where == p - 1).to(hidden.dtype)[:, None] * hidden[0]
        last = sh.sum_seq(last.sum(dim=0, keepdim=True))         # [1, h]
        logits = self._logits(last)
        self._admitted(request_id, p)
        return logits

    def _check_prompt(self, tokens: torch.Tensor) -> int:
        p = tokens.shape[0]
        if p < self.lsh.num_sink_tokens + self.lsh.num_local_tokens + 1:
            raise ValueError("prompt shorter than sink + local tokens + 1")
        if p > self.max_length:
            raise ValueError(f"prompt of {p} tokens > max_length {self.max_length}")
        return p

    def _admitted(self, request_id: int, p: int) -> None:
        """The slot's position and guard mirrors after its fill (the
        mirrors are global on every rank; the position the owner's)."""
        sh = self.shard
        if sh is None:
            self.state.pos[request_id] = p
        elif sh.owns(request_id):
            self.state.pos[sh.slot(request_id)] = p
        self._hot_used[request_id] = (self.lsh.num_sink_tokens
                                      + self.lsh.num_local_tokens)
        self._pos_used[request_id] = p

    # -- chunked prefill ------------------------------------------------------

    def start_prefill(self, input_ids, request_id: int = 0) -> "ChunkedPrefill":
        """Begin a chunked prefill of one request into slot `request_id`;
        each `.step()` of the returned `ChunkedPrefill` runs one chunk, and
        the last one fills the slot and returns the first-token logits.
        The prompt is padded with token 0 to whole chunks of
        min(chunk_size, max_length); a padded prompt longer than
        max_length raises. The first call allocates the staging pair
        [n_layers, max_length, Hkv, d] (one more request's K/V in the
        compute dtype), shared by every later one: one chunked prefill may
        be in flight at a time."""
        cp = ChunkedPrefill(self, input_ids, request_id)
        if self._stage_k is None:
            cfg = self.layer_config
            shape = (len(self.groups), self.max_length,
                     cfg.num_key_value_heads, cfg.head_dim)
            self._stage_k = torch.zeros(shape, dtype=cfg.dtype,
                                        device=self.device)
            self._stage_v = torch.zeros_like(self._stage_k)
        return cp

    def _prefill_chunk(self, tokens: torch.Tensor, off: int,
                       true_len: int) -> torch.Tensor:
        """One chunk (tokens [c] at positions off..off + c - 1) through
        every layer: its K/V go into the staging pair, and its queries
        attend the staged prefix. Returns the logits [1, V] at the last
        prompt position the chunk holds."""
        cfg, params, sh = self.layer_config, self.params, self.shard
        c = tokens.shape[0]
        hidden = params.embed[tokens][None]                    # [1, c, h]
        positions = torch.arange(off, off + c, device=self.device)[None]
        length = torch.full((1,), off + c, dtype=torch.int32, device=self.device)
        q_offset = torch.full((1,), off, dtype=torch.int32, device=self.device)
        for i in range(len(self.groups)):
            lp = params.layers.layer(i)
            q, k, v = qkv_proj(lp, cfg, hidden, positions, params.cos, params.sin)
            self._stage_k[i, off:off + c] = k[0]
            self._stage_v[i, off:off + c] = v[0]
            attn = flash_prefill(q, self._stage_k[i][None],
                                 self._stage_v[i][None], length, q_offset,
                                 window=cfg.sliding_window)
            hidden = post_attention(lp, cfg, attn.reshape(1, c, -1), hidden, sh)
        last = min(max(true_len - 1 - off, 0), c - 1)
        return self._logits(hidden[:, last])                   # [1, V]

    def _fill_from_staging(self, true_len: int, request_id: int) -> None:
        """The fills of `prefill`, from the staged K/V of the whole prompt."""
        for i, (kind, gi) in enumerate(self.groups):
            self._fill(kind, gi, request_id, self._stage_k[i, :true_len],
                       self._stage_v[i, :true_len])
        self._admitted(request_id, true_len)

    def release_slot(self, slot: int) -> None:
        """Free one request slot for a later prefill: its four lengths
        zeroed in place (a captured step keeps its buffers) and its guard
        mirrors dropped. `slot` is global: under a mesh the owning data
        rank zeroes its local slot."""
        st, sh = self.state, self.shard
        self._hot_used.pop(slot, None)
        self._pos_used.pop(slot, None)
        if sh is not None:
            if not sh.owns(slot):
                return
            slot = sh.slot(slot)
        for lens in (st.pos, st.dense_len, st.hot_len, st.off_len):
            lens[slot] = 0

    # -- decode -------------------------------------------------------------

    def _decode(self, tokens: torch.Tensor):
        """One decode step of the whole batch: (logits [B, V], mean sampled
        fraction of the sparse layers as a device scalar). Under a mesh the
        rank decodes its batch slice at its heads and returns the global
        logits and fraction."""
        cfg, lsh, params, st = self.layer_config, self.lsh, self.params, self.state
        sh = self.shard
        window = cfg.sliding_window
        if sh is not None:
            tokens = sh.local_batch(tokens)
        b = tokens.shape[0]
        hidden = params.embed[tokens]                          # [B, h]
        positions = st.pos.long()[:, None]
        frac_sum = torch.zeros((), device=self.device)
        n_sparse = 0
        for i, (kind, gi) in enumerate(self.groups):
            lp = params.layers.layer(i)
            q, k, v = qkv_proj(lp, cfg, hidden[:, None], positions,
                               params.cos, params.sin)
            q, k, v = q[:, 0], k[:, 0], v[:, 0]                # [B, H, d]
            # Under a mesh q, k, v and the state are the rank's (batch,
            # kv-head) slice, so the layers run unchanged at local shapes.
            if kind == "dense":
                out = decode_dense_layer(st, gi, q, k, v, window)
            else:
                out, frac = decode_sparse_layer(st, gi, q, k, v,
                                                self.projections, lsh, window)
                frac_sum = frac_sum + frac
                n_sparse += 1
            hidden = post_attention(lp, cfg, out.reshape(b, 1, -1),
                                    hidden[:, None], sh)[:, 0]
        logits = self._logits(hidden)                          # [B, V]
        st.pos += 1
        st.dense_len += 1
        st.hot_len += 1
        if lsh.estimator == "oracle_sampling" and lsh.enabled:
            st.step += 1        # its draws' counter; no other path reads it
        frac = frac_sum / max(n_sparse, 1)
        if sh is not None:
            logits = sh.gather_batch(logits)
            frac = sh.global_frac(frac, st.off_len)
        return logits, frac

    def _guard_decode(self, n_steps: int):
        """Fail loudly if `n_steps` more decode tokens would overflow any
        live slot's generation buffer or the dense cache."""
        hot_cap = state_lib.hot_capacity(self.lsh)
        for slot, used in self._hot_used.items():
            if self.lsh.enabled and used + n_steps > hot_cap:
                raise ValueError(
                    f"slot {slot}: {n_steps} more decode steps would use "
                    f"{used + n_steps} hot tokens > generation-buffer "
                    f"capacity {hot_cap}; raise LSHConfig.generation_buffer")
            if self._pos_used.get(slot, 0) + n_steps > self.max_length:
                raise ValueError(
                    f"slot {slot}: position {self._pos_used[slot] + n_steps} "
                    f"would exceed max_length {self.max_length}")
        for slot in self._hot_used:
            self._hot_used[slot] += n_steps
            self._pos_used[slot] += n_steps

    def _step(self, tokens: torch.Tensor):
        """One decode step: (logits [B, V], mean sampled fraction, greedy
        tokens [B] int32). On the card the engine's first step runs eagerly
        and the second captures the step; from then on each step replays it
        and returns the graph's static outputs. A failed capture or replay
        raises. A mesh with a gloo collective runs every step eagerly."""
        if self._graph is None and self._warmed_up:
            self._graph = DecodeGraph(self._decode, self.batch_size,
                                      self.device)
            self.graph_captures += 1
        if self._graph is not None:
            return self._graph.replay(tokens)
        self._warmed_up = self.device.type == "cuda" and (
            self.shard is None or self.shard.capturable)
        logits, frac = self._decode(tokens)
        return logits, frac, greedy_sample(logits)

    @torch.no_grad()
    def inference(self, input_ids) -> torch.Tensor:
        """One decode step for the whole batch; returns logits [B, V]."""
        self._guard_decode(1)
        logits, frac, _ = self._step(self._tokens(input_ids))
        if self.lsh.enabled:
            self._sparsity_sum = self._sparsity_sum + frac
            self._sparsity_steps += 1
        # The graph's logits are overwritten by the next step.
        return logits if self._graph is None else logits.clone()

    @torch.no_grad()
    def decode_steps(self, input_ids, n_steps: int) -> torch.Tensor:
        """Greedy-decode n_steps tokens for the whole batch, tokens kept on
        the device; returns [n_steps, B] int32."""
        self._guard_decode(n_steps)
        tok = self._tokens(input_ids)
        toks = torch.empty((n_steps, tok.shape[0]), dtype=torch.int32,
                           device=self.device)
        frac_sum = torch.zeros((), device=self.device)
        for i in range(n_steps):
            _, frac, nxt = self._step(tok)
            toks[i] = nxt
            tok = toks[i]
            frac_sum = frac_sum + frac
        if self.lsh.enabled:
            self._sparsity_sum = self._sparsity_sum + frac_sum
            self._sparsity_steps += n_steps
        return toks

    @property
    def avg_sparsity(self) -> float:
        """Mean sampled fraction (block_topk: the realized fraction, its
        budget clamped to each offload length) over all decode steps since
        creation."""
        return float(self._sparsity_sum) / max(self._sparsity_steps, 1)

    def sparsity_snapshot(self) -> tuple[torch.Tensor, int]:
        """Accumulator snapshot for `avg_sparsity_since` (per-run averages)."""
        return (self._sparsity_sum, self._sparsity_steps)

    def avg_sparsity_since(self, snapshot: tuple[torch.Tensor, int]) -> float:
        s0, n0 = snapshot
        return float(self._sparsity_sum - s0) / max(self._sparsity_steps - n0, 1)

    def generate(self, input_ids, max_tokens: int = 128,
                 temperature: float = 0.6, top_p: float = 0.9,
                 verbose: bool = False) -> list[int]:
        """Prefill slot 0 + decode loop (greedy below temperature 0.1, else
        top-p); returns the generated token ids and clears the state."""
        hot_cap = state_lib.hot_capacity(self.lsh)
        base = self.lsh.num_sink_tokens + self.lsh.num_local_tokens
        if self.lsh.enabled and base + max_tokens > hot_cap:
            raise ValueError(
                f"max_tokens={max_tokens} exceeds the generation buffer "
                f"({hot_cap - base} tokens); raise "
                f"LSHConfig.generation_buffer")
        n_prompt = self._tokens(input_ids).shape[0]
        logits = self.prefill(input_ids, request_id=0)
        t1 = time.perf_counter()
        generated: list[int] = []
        for _ in range(max_tokens):
            if temperature < 0.1:
                token = greedy_sample(logits)
            else:
                token = top_p_sample(self._sample_gen, logits, temperature,
                                     top_p)
            tok = int(token[0])
            generated.append(tok)
            if tok in self.config.eos_token_ids:
                break
            logits = self.inference(token[:1].expand(self.batch_size))
        t2 = time.perf_counter()
        if verbose:
            n = len(generated)
            print(f"[INFO] Prefill {n_prompt} tokens")
            print(f"[INFO] Generate {n} tokens")
            print(f"[INFO] Decoding Latency {1000 * (t2 - t1) / max(n, 1):.2f} ms/token")
        self.clear()
        return generated

    def clear(self):
        """Reset all server state in place (the captured step keeps its
        buffers); the sparsity counters survive."""
        state_lib.reset_state(self.state)
        self._hot_used.clear()
        self._pos_used.clear()


class ChunkedPrefill:
    """One request's prefill in flight (`LLM.start_prefill`). `step()` runs
    the next chunk and returns None, or after the last chunk fills the
    slot from the staged K/V and returns the first-token logits [1, V]."""

    def __init__(self, llm: LLM, input_ids, request_id: int):
        tokens = llm._tokens(input_ids)
        p = llm._check_prompt(tokens)
        self.c = min(llm.chunk_size, llm.max_length)
        self.n_chunks = -(-p // self.c)
        if self.n_chunks * self.c > llm.max_length:
            raise ValueError(
                f"prompt of {p} tokens padded to {self.n_chunks} chunks of "
                f"{self.c} > max_length {llm.max_length}")
        self.llm = llm
        self.request_id = request_id
        self.true_len = p
        self._tokens = torch.zeros((self.n_chunks * self.c,), dtype=torch.int64,
                                   device=llm.device)
        self._tokens[:p] = tokens
        self._idx = 0
        self.logits: torch.Tensor | None = None

    @property
    def done(self) -> bool:
        return self.logits is not None

    @torch.no_grad()
    def step(self) -> torch.Tensor | None:
        """One chunk of prefill work; the logits after the last chunk."""
        if self.done:
            raise RuntimeError("the chunked prefill has finished")
        llm, c = self.llm, self.c
        off = self._idx * c
        logits = llm._prefill_chunk(self._tokens[off:off + c], off,
                                    self.true_len)
        self._idx += 1
        if self._idx < self.n_chunks:
            return None
        llm._fill_from_staging(self.true_len, self.request_id)
        self.logits = logits
        return logits

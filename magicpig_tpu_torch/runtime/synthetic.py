"""The post-prefill state at a given context length from random K/V (port of
`magicpig_tpu/runtime/synthetic.py`), for decode measurements at long
context without a prompt's prefill.

Every layer and request goes through the engine's own fills (centering,
norms, SimHash planes, quantization), so a decode step behaves as after a
real prefill: its cost does not depend on the cache's values. One (layer,
request) at a time, so the peak memory is the state plus one fill's
temporaries.

On a sharded engine (`parallel/mesh.py::shard_engine`) every rank draws as
the unsharded engine draws, per (layer, request) and all kv heads, from
the same generator, keeps the kv heads of its model rank and fills only
the requests its data rank owns (each into its local slot); the draws of
the others only advance the generator. So each rank's state is its slice
of the unsharded engine's, and the peak memory is still one fill's.
"""

from __future__ import annotations

import torch

from magicpig_tpu_torch.runtime.server import fill_dense_layer, fill_sparse_layer


def draw_kv(gen: torch.Generator, seq_len: int, hkv: int, d: int,
            dtype: torch.dtype, device: torch.device):
    """K and V [seq_len, Hkv, d] of one (layer, request): standard normal
    draws in `dtype` from `gen`."""
    k = torch.randn((seq_len, hkv, d), generator=gen, dtype=dtype, device=device)
    v = torch.randn((seq_len, hkv, d), generator=gen, dtype=dtype, device=device)
    return k, v


@torch.no_grad()
def synthetic_prefill(llm, seq_len: int, seed: int = 0):
    """Fill every layer of every slot of `llm` with random K/V of `seq_len`
    tokens (drawn from a generator seeded by `seed`, layer by layer and
    slot by slot), set each slot's position to `seq_len` and register the
    generation-buffer guard, as a prefill of `seq_len` tokens does. Under a
    mesh, each rank fills its slice of that state (module docstring)."""
    cfg, lsh, sh = llm.config, llm.lsh, llm.shard
    if not lsh.num_sink_tokens + lsh.num_local_tokens < seq_len <= llm.max_length:
        raise ValueError(f"seq_len {seq_len} outside (sink + local, "
                         f"max_length {llm.max_length}]")
    heads = llm.layer_config.num_key_value_heads     # the rank's kv heads
    h0 = 0 if sh is None else sh.m * heads
    gen = torch.Generator(device=llm.device)
    gen.manual_seed(seed)
    for kind, gi in llm.groups:
        for r in range(llm.batch_size):
            k, v = draw_kv(gen, seq_len, cfg.num_key_value_heads, cfg.head_dim,
                           cfg.dtype, llm.device)
            slot = r
            if sh is not None:
                if not sh.owns(r):
                    continue
                slot = sh.slot(r)
                k = k[:, h0:h0 + heads].contiguous()
                v = v[:, h0:h0 + heads].contiguous()
            if kind == "dense":
                fill_dense_layer(llm.state, gi, slot, k, v)
            else:
                fill_sparse_layer(llm.state, gi, slot, k, v, llm.projections,
                                  lsh, cfg.sliding_window)
    for r in range(llm.batch_size):
        llm._admitted(r, seq_len)
    return llm

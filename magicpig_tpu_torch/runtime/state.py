"""Decode-time cache state (port of `magicpig_tpu/runtime/state.py`).

Layouts chosen for the card (the JAX package's token folding to 128 lanes
is a TPU choice):
  * dense layers: [B, Hkv, max_len, d] per layer; with dense int8, int8
    rows and per-row f32 scales dense_k_scale / dense_v_scale
    [B, Hkv, max_len] in token order (the JAX package keeps them
    fold-major);
  * sparse layers: a hot region (sink + local + generated tokens)
    [B, Hkv, hot_cap, d] and the offloaded middle [B, Hkv, off_cap, d] in
    token order;
  * LSH only: keys of both regions centered by the mean offload key;
    centered-key norms [B, Hkv, off_cap] f32; SimHash bit-planes
    [B, Hkv, L, K, off_cap/32] int32 in the flat layout of `ops.bitcodes`;
  * quantized offload (either estimator): off_k / off_v int8 with per-row
    f32 scales off_k_scale / off_v_scale [B, Hkv, off_cap] in token order;
    with int4 offload K holds 4-bit-grid values, and under block_topk it is
    packed along the head dimension, off_k [B, Hkv, off_cap, d/2] (byte j
    holds channel j in its low nibble and channel j + d/2 in its high one,
    `ops/pack4.py`); V stays int8 [B, Hkv, off_cap, d];
  * Quest only: per-page key minima and maxima quest_min / quest_max
    [B, Hkv, off_cap / page, d] in the cache dtype, taken from the offload
    keys before any quantization;
  * per-request lengths as int32 device tensors [B], and the decode step
    counter `step` [] int32, which oracle sampling folds into its draws.
Fill, decode and `reset_state` write into these tensors in place, which
keeps one copy of each cache and the addresses a captured decode step uses.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from magicpig_tpu_torch.config import LSHConfig, ModelConfig
from magicpig_tpu_torch.ops.bitcodes import num_words


@dataclasses.dataclass
class DecodeState:
    """All attention-server state of one engine instance."""

    dense_k: list[torch.Tensor]   # per dense layer [B, Hkv, max_len, d]
    dense_v: list[torch.Tensor]   # (int8 when the dense layers are quantized)
    dense_k_scale: list[torch.Tensor]  # dense int8 only: [B, Hkv, max_len]
    dense_v_scale: list[torch.Tensor]
    dense_len: torch.Tensor       # [B] i32, valid tokens per request
    hot_k: list[torch.Tensor]     # per sparse layer [B, Hkv, hot_cap, d]
    hot_v: list[torch.Tensor]
    hot_len: torch.Tensor         # [B] i32
    off_k: list[torch.Tensor]     # per sparse layer [B, Hkv, off_cap, d]
                                  # (d/2 packed bytes with packed int4 K)
    off_v: list[torch.Tensor]     # (int8 when the offload is quantized)
    off_k_scale: list[torch.Tensor]  # int8 only: [B, Hkv, off_cap] f32
    off_v_scale: list[torch.Tensor]
    off_len: torch.Tensor         # [B] i32
    # LSH only (empty lists for block_topk):
    k_norm: list[torch.Tensor]    # per sparse layer [B, Hkv, off_cap] f32
    avg_k: list[torch.Tensor]     # per sparse layer [B, Hkv, d] f32
    planes: list[torch.Tensor]    # per sparse layer [B, Hkv, L, K, W] i32
    # Quest only (empty lists otherwise):
    quest_min: list[torch.Tensor]  # per sparse layer [B, Hkv, n_pages, d]
    quest_max: list[torch.Tensor]
    pos: torch.Tensor             # [B] i32, next absolute position
    step: torch.Tensor            # [] i32, decode steps since the last reset


def hot_capacity(lsh: LSHConfig) -> int:
    cap = lsh.num_sink_tokens + lsh.num_local_tokens + lsh.generation_buffer
    return ((cap + 127) // 128) * 128


def offload_capacity(lsh: LSHConfig, max_length: int) -> int:
    """Offload tokens per request: 128-aligned (whole signature words), for
    block_topk a whole number of ranking blocks, for quest of pages."""
    cap = max(0, max_length - lsh.num_sink_tokens - lsh.num_local_tokens)
    align = 128
    if lsh.estimator == "block_topk":
        align = max(align, lsh.block_topk_block_size)
    if lsh.estimator == "quest":
        align = math.lcm(align, lsh.quest_page_size)
    return ((cap + align - 1) // align) * align


def init_state(config: ModelConfig, lsh: LSHConfig, batch_size: int,
               max_length: int, device: torch.device | str) -> DecodeState:
    dense = lsh.dense_layers_for(config.num_hidden_layers)
    nd = len(dense)
    ns = config.num_hidden_layers - nd
    b, hkv, d, dt = (batch_size, config.num_key_value_heads, config.head_dim,
                     config.dtype)
    off_cap = offload_capacity(lsh, max_length)
    hot_cap = hot_capacity(lsh)
    n_lsh = ns if lsh.estimator == "lsh" else 0
    n_quest = ns if lsh.estimator == "quest" else 0
    n_quant = ns if lsh.offload_quantized else 0
    off_dt = torch.int8 if lsh.offload_quantized else dt
    off_kd = d // 2 if lsh.packed_k4(d) else d
    nd_quant = nd if lsh.dense_quantized else 0
    dense_dt = torch.int8 if lsh.dense_quantized else dt

    def per_layer(n, shape, dtype):
        return [torch.zeros(shape, dtype=dtype, device=device) for _ in range(n)]

    def lens():
        return torch.zeros((b,), dtype=torch.int32, device=device)

    return DecodeState(
        dense_k=per_layer(nd, (b, hkv, max_length, d), dense_dt),
        dense_v=per_layer(nd, (b, hkv, max_length, d), dense_dt),
        dense_k_scale=per_layer(nd_quant, (b, hkv, max_length), torch.float32),
        dense_v_scale=per_layer(nd_quant, (b, hkv, max_length), torch.float32),
        dense_len=lens(),
        hot_k=per_layer(ns, (b, hkv, hot_cap, d), dt),
        hot_v=per_layer(ns, (b, hkv, hot_cap, d), dt),
        hot_len=lens(),
        off_k=per_layer(ns, (b, hkv, off_cap, off_kd), off_dt),
        off_v=per_layer(ns, (b, hkv, off_cap, d), off_dt),
        off_k_scale=per_layer(n_quant, (b, hkv, off_cap), torch.float32),
        off_v_scale=per_layer(n_quant, (b, hkv, off_cap), torch.float32),
        off_len=lens(),
        k_norm=per_layer(n_lsh, (b, hkv, off_cap), torch.float32),
        avg_k=per_layer(n_lsh, (b, hkv, d), torch.float32),
        planes=per_layer(n_lsh, (b, hkv, max(lsh.L, 1), max(lsh.K, 1),
                                 num_words(off_cap)), torch.int32),
        quest_min=per_layer(n_quest, (b, hkv, off_cap // lsh.quest_page_size,
                                      d), dt),
        quest_max=per_layer(n_quest, (b, hkv, off_cap // lsh.quest_page_size,
                                      d), dt),
        pos=lens(),
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


def reset_state(state: DecodeState) -> None:
    """Zero every tensor of `state` in place: it then equals a fresh
    `init_state`, and every buffer keeps its address, which a captured
    decode step (`runtime/engine.py`) reads and writes on each replay."""
    for field in dataclasses.fields(state):
        value = getattr(state, field.name)
        for t in value if isinstance(value, list) else [value]:
            t.zero_()


def layer_groups(config: ModelConfig, lsh: LSHConfig):
    """Map each layer index to ('dense'|'sparse', index within its group)."""
    dense = set(lsh.dense_layers_for(config.num_hidden_layers))
    groups = []
    di = si = 0
    for i in range(config.num_hidden_layers):
        if i in dense:
            groups.append(("dense", di))
            di += 1
        else:
            groups.append(("sparse", si))
            si += 1
    return groups

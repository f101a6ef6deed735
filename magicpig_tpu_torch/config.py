"""Model and LSH configuration (PyTorch port of `magicpig_tpu/config.py`).

The knobs mirror the reference system (MagicPIG):
  * LSH parameters K (bits per table) and L (number of tables);
  * the attention-cache partition: 4 sink tokens + 64 local tokens + a
    generation buffer;
  * dense layers (full attention, no sampling): [0, 16, 32, 48, 64] cut to
    the model's depth.

`ModelConfig.weight_quant` stores the matmul weights bf16, int8 per output
channel (W8A8) or int4 in 128-input groups; `fuse_small_linears` joins
q/k/v and gate/up of quantized weights into one matmul each.

`LSHConfig` keeps the fields the estimators read: "lsh" (SimHash
sampling, with the exact, polynomial or no debias, decoded in the masked
or the sampled form), "block_topk" (exact-score block ranking), and the
reference's accuracy baselines "quest", "topk" and "oracle_sampling";
each with bf16, int8 or int4 offload K (V int8 when quantized), and the
dense layers' K/V bf16 or int8 (`dense_quant`). With int4 offload under
block_topk the K rows are stored packed, two channels a byte
(`ops/pack4.py`). An unknown estimator or decode mode raises `ValueError`.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os

import torch


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """Llama-3 style RoPE frequency scaling (HF `rope_scaling` dict)."""

    rope_type: str = "default"  # "default" | "llama3"
    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192


WEIGHT_QUANTS = ("none", "int8", "int4")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Llama-family transformer shape; with `sliding_window` (Mistral
    v0.1) position t attends keys in (t - window, t]."""

    name: str = "llama-tiny"
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    rope_scaling: RopeScaling | None = None
    max_position_embeddings: int = 131072
    tie_word_embeddings: bool = False
    eos_token_ids: tuple[int, ...] = (128001, 128008, 128009)
    dtype: torch.dtype = torch.bfloat16
    # Sliding-window attention (Mistral v0.1): position t attends keys in
    # (t - window, t]; None attends the whole causal prefix.
    sliding_window: int | None = None
    # Matmul weight storage: "none" (the model dtype), "int8" (W8A8:
    # per-output-channel int8 weights, per-token int8 activations) or
    # "int4" (group-128 int4 weights, nibble-packed; models/llama.py).
    weight_quant: str = "none"
    # Quantized weights only: q/k/v and gate/up as one wider matmul each
    # (quantize, then concatenate: the same numbers as the separate calls).
    fuse_small_linears: bool = False

    def __post_init__(self):
        if self.weight_quant not in WEIGHT_QUANTS:
            raise ValueError(f"unknown weight_quant {self.weight_quant!r}")

    @classmethod
    def from_hf_config(cls, path_or_dict, name: str = "hf-model") -> "ModelConfig":
        """Build from a HuggingFace config.json (a path or the parsed dict),
        as the JAX package's `ModelConfig.from_hf_config` does, its
        `sliding_window` included."""
        if isinstance(path_or_dict, (str, os.PathLike)):
            with open(path_or_dict) as f:
                cfg = json.load(f)
        else:
            cfg = dict(path_or_dict)
        rs = cfg.get("rope_scaling") or None
        scaling = None
        if rs is not None:
            scaling = RopeScaling(
                rope_type=rs.get("rope_type", rs.get("type", "default")),
                factor=rs.get("factor", 8.0),
                low_freq_factor=rs.get("low_freq_factor", 1.0),
                high_freq_factor=rs.get("high_freq_factor", 4.0),
                original_max_position_embeddings=rs.get(
                    "original_max_position_embeddings", 8192))
        eos = cfg.get("eos_token_id", 2)
        eos = tuple(eos) if isinstance(eos, (list, tuple)) else (eos,)
        hidden = cfg["hidden_size"]
        heads = cfg["num_attention_heads"]
        return cls(
            name=name,
            vocab_size=cfg["vocab_size"],
            hidden_size=hidden,
            intermediate_size=cfg["intermediate_size"],
            num_hidden_layers=cfg["num_hidden_layers"],
            num_attention_heads=heads,
            num_key_value_heads=cfg.get("num_key_value_heads", heads),
            head_dim=cfg.get("head_dim", hidden // heads),
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
            rope_theta=cfg.get("rope_theta", 10000.0),
            rope_scaling=scaling,
            max_position_embeddings=cfg.get("max_position_embeddings", 131072),
            tie_word_embeddings=cfg.get("tie_word_embeddings", False),
            eos_token_ids=eos,
            sliding_window=cfg.get("sliding_window"),
        )


_LLAMA3_SCALING = RopeScaling(
    rope_type="llama3",
    factor=8.0,
    low_freq_factor=1.0,
    high_freq_factor=4.0,
    original_max_position_embeddings=8192,
)

_LLAMA32_SCALING = dataclasses.replace(_LLAMA3_SCALING, factor=32.0)

PRESETS: dict[str, ModelConfig] = {
    # Tiny config for unit tests (fits the CPU, exercises GQA).
    "llama-tiny": ModelConfig(
        name="llama-tiny",
        vocab_size=512,
        hidden_size=128,
        intermediate_size=256,
        num_hidden_layers=4,
        num_attention_heads=8,
        num_key_value_heads=2,
        head_dim=16,
        rope_theta=10000.0,
        rope_scaling=None,
        max_position_embeddings=4096,
        eos_token_ids=(0,),
    ),
    "llama-3.2-1b": ModelConfig(
        name="llama-3.2-1b",
        hidden_size=2048,
        intermediate_size=8192,
        num_hidden_layers=16,
        num_attention_heads=32,
        num_key_value_heads=8,
        head_dim=64,
        rope_scaling=_LLAMA32_SCALING,
        tie_word_embeddings=True,
    ),
    # Head dim 128 and group size 3 (24 query heads over 8): every decode
    # kernel has its G = 3 form at d = 128, so the 3B runs on the card.
    "llama-3.2-3b": ModelConfig(
        name="llama-3.2-3b",
        hidden_size=3072,
        intermediate_size=8192,
        num_hidden_layers=28,
        num_attention_heads=24,
        num_key_value_heads=8,
        head_dim=128,
        rope_scaling=_LLAMA32_SCALING,
        tie_word_embeddings=True,
    ),
    "llama-3.1-8b": ModelConfig(
        name="llama-3.1-8b",
        hidden_size=4096,
        intermediate_size=14336,
        num_hidden_layers=32,
        num_attention_heads=32,
        num_key_value_heads=8,
        head_dim=128,
        rope_scaling=_LLAMA3_SCALING,
    ),
    "llama-3.1-70b": ModelConfig(
        name="llama-3.1-70b",
        hidden_size=8192,
        intermediate_size=28672,
        num_hidden_layers=80,
        num_attention_heads=64,
        num_key_value_heads=8,
        head_dim=128,
        rope_scaling=_LLAMA3_SCALING,
    ),
    "llama-2-7b": ModelConfig(
        name="llama-2-7b",
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=11008,
        num_hidden_layers=32,
        num_attention_heads=32,
        num_key_value_heads=32,
        head_dim=128,
        rope_theta=10000.0,
        max_position_embeddings=4096,
        eos_token_ids=(2,),
    ),
    "mistral-7b": ModelConfig(
        name="mistral-7b",
        vocab_size=32768,
        hidden_size=4096,
        intermediate_size=14336,
        num_hidden_layers=32,
        num_attention_heads=32,
        num_key_value_heads=8,
        head_dim=128,
        rope_theta=1000000.0,
        max_position_embeddings=131072,
        eos_token_ids=(2,),
    ),
}


def default_dense_layers(num_layers: int) -> tuple[int, ...]:
    """Layers that keep full (dense) attention: the reference's
    [0, 16, 32, 48, 64], cut to the model's depth."""
    return tuple(l for l in (0, 16, 32, 48, 64) if l < num_layers)


ESTIMATORS = ("lsh", "quest", "topk", "oracle_sampling", "block_topk")
DECODE_MODES = ("masked", "sampled")


@dataclasses.dataclass(frozen=True)
class LSHConfig:
    """Sparse-attention parameters.

    K bits per hash table, L tables; K=0 turns sampling off (full attention
    in every layer). `estimator` picks the sparse layers' algorithm:
      * "lsh"        -- SimHash >=2-of-L sampling + debias;
      * "block_topk" -- every offloaded key scored exactly, the
        `block_topk_budget_frac` best `block_topk_block_size`-token blocks
        (by their max score over the GQA group) attended. Quantized,
        `block_topk_pipeline="rescore"` ranks from block maxes and rescores
        the chosen blocks; "store" (and bf16 offload) stores the scores and
        attends from them;
      * "quest"      -- page-landmark top-k: each `quest_page_size`-token
        page scored by its key min/max bound, the `quest_budget_frac`
        best pages attended;
      * "topk"       -- oracle top-k: exact scores, the `topk_budget_frac`
        highest attended (ties admit more);
      * "oracle_sampling" -- `os_budget_frac` token ids drawn from the
        exact softmax with replacement, their values averaged.
    The three baselines score every offloaded key in plain PyTorch (they
    are accuracy references, not fast paths) and keep layers {0, 1} dense.
    `offload_quant="int8"` stores the offload K/V int8 per row with f32
    scales (for lsh, the centered keys, whose stored norms and signatures
    are those of the dequantized rows); "int4" puts K on the 4-bit grid
    (values in [-7, 7]) and keeps V int8: for lsh in the int8 layout, for
    block_topk packed two channels a byte (`packed_k4`). `dense_quant="int8"`
    stores the dense layers' K/V as int8 rows. The hot sink and local tokens
    stay exact. `lsh_debias` reweights the sampled scores by the exact
    collision probability ("exact"), by its degree-20 polynomial fit
    ("poly"), or not at all ("none"). `decode_mode` "masked" attends every
    sampled key of the offload region in place; "sampled" compacts each
    head's sampled keys to a static budget of token ids
    (`sample_budget`), gathers those rows and applies the exact debias
    whatever `lsh_debias` says (as the reference's sampled path does).
    """

    K: int = 10
    L: int = 150
    num_sink_tokens: int = 4
    num_local_tokens: int = 64
    generation_buffer: int = 256
    dense_layers: tuple[int, ...] | None = None  # None -> default rule
    estimator: str = "lsh"
    block_topk_block_size: int = 512
    block_topk_budget_frac: float = 0.08
    block_topk_pipeline: str = "rescore"
    # Quest: page size and page budget as a fraction of the offload
    # capacity; TopK and OracleSampling token budgets (the same fraction).
    quest_page_size: int = 16
    quest_budget_frac: float = 0.04
    topk_budget_frac: float = 0.02
    os_budget_frac: float = 0.02
    # Static per-head budget of the sampled mode, a fraction of the offload
    # capacity (the expected collision rate at K=10, L=150 is ~2%).
    sample_budget_frac: float = 0.06
    min_sample_budget: int = 128
    decode_mode: str = "masked"
    lsh_debias: str = "exact"
    offload_quant: str = "none"
    dense_quant: str = "none"

    def __post_init__(self):
        for field, value, known in (
                ("estimator", self.estimator, ESTIMATORS),
                ("decode_mode", self.decode_mode, DECODE_MODES),
                ("block_topk_pipeline", self.block_topk_pipeline,
                 ("rescore", "store")),
                ("lsh_debias", self.lsh_debias, ("exact", "poly", "none")),
                ("offload_quant", self.offload_quant,
                 ("none", "int8", "int4")),
                ("dense_quant", self.dense_quant, ("none", "int8"))):
            if value not in known:
                raise ValueError(f"unknown {field} {value!r}; known: {known}")
        if self.K < 0 or self.L < 0:
            raise ValueError(f"K and L must be >= 0, got K={self.K} L={self.L}")
        if self.block_topk_block_size <= 0:
            raise ValueError("block_topk_block_size must be > 0")
        if self.quest_page_size <= 0:
            raise ValueError("quest_page_size must be > 0")

    @property
    def offload_quantized(self) -> bool:
        """Offload K/V stored quantized (int8 or int4 K, int8 V) with
        per-row f32 scales?"""
        return self.offload_quant != "none"

    @property
    def offload_k_bits(self) -> int:
        """Bits of the offload K grid (V is always quantized at 8)."""
        return 4 if self.offload_quant == "int4" else 8

    def packed_k4(self, head_dim: int) -> bool:
        """Store the offload K packed, two 4-bit channels a byte
        (`ops/pack4.py`)? Only the block_topk scorer and rescore read K as
        stored, so block_topk with int4 offload packs for any even head
        dim; the lsh kernel reads int8 rows and keeps them. (The JAX
        package packs only at 512-token blocks and d >= 64, a rule of its
        TPU layout.)"""
        return (self.offload_quant == "int4" and self.estimator == "block_topk"
                and head_dim % 2 == 0)

    @property
    def dense_quantized(self) -> bool:
        """Dense-layer K/V stored int8 with per-row f32 scales?"""
        return self.dense_quant != "none"

    @property
    def enabled(self) -> bool:
        """Sparse layers active? (K=0 = full attention everywhere.)"""
        return self.K != 0

    def sample_budget(self, offload_len: int) -> int:
        """Static budget of sampled tokens per (head, step) of the sampled
        mode: `sample_budget_frac` of `offload_len`, at least
        `min_sample_budget`, rounded up to a multiple of 128 and at most
        `offload_len`."""
        b = max(self.min_sample_budget,
                int(math.ceil(offload_len * self.sample_budget_frac)))
        return min(offload_len, ((b + 127) // 128) * 128)

    def dense_layers_for(self, num_layers: int) -> tuple[int, ...]:
        """Full-attention layers: all with K=0, else the given ones, else
        the default rule for lsh and block_topk and layers {0, 1} for the
        reference's baselines (`quest_cache.py:128`)."""
        if not self.enabled:
            return tuple(range(num_layers))
        if self.dense_layers is not None:
            return tuple(l for l in self.dense_layers if l < num_layers)
        if self.estimator in ("lsh", "block_topk"):
            return default_dense_layers(num_layers)
        return tuple(l for l in (0, 1) if l < num_layers)


def preset(name: str) -> ModelConfig:
    if name in PRESETS:
        return PRESETS[name]
    raise KeyError(f"unknown model preset {name!r}; known: {sorted(PRESETS)}")

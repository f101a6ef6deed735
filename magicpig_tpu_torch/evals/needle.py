"""The needle-retrieval accuracy eval: the trained needle model's
vocabulary and shape, the estimators it scores, and its haystacks (the
port's copy of what `examples/estimator_accuracy.py` takes from
`examples/train_needle.py`, which imports JAX).

A haystack is filler tokens with key-value needles ("MARK k v") placed
deep in the offload region; a probe prefills it, decodes the query marker,
then the key, and counts the greedy token after the key against the
needle's value: the retrieval happens in the second decode step, under
the estimator. `make_eval_sample` makes the same numpy draws as the JAX
example, so one seed gives the same haystacks in both packages. The
weights load through `models.convert.load_params` (`data/needle_ckpt.npz`).
"""

from __future__ import annotations

import numpy as np
import torch

from magicpig_tpu_torch.config import LSHConfig, ModelConfig

# Vocabulary (`train_needle.py:56-61`).
PAD, BOS, MARK, QUERY = 0, 1, 2, 3
QUERY2 = 4                         # 2-hop (variable-tracking) query marker
FILLER_LO, FILLER_HI = 8, 448      # haystack noise tokens
KEY_LO, KEY_HI = 448, 704          # needle keys
VAL_LO, VAL_HI = 704, 960          # needle values
VOCAB = 1024


def model_config(dtype: torch.dtype = torch.float32) -> ModelConfig:
    """The needle model (`train_needle.py:64-80`): d = 64, GQA 8/4."""
    return ModelConfig(
        name="needle-12m",
        vocab_size=VOCAB,
        hidden_size=256,
        intermediate_size=768,
        num_hidden_layers=4,
        num_attention_heads=8,
        num_key_value_heads=4,
        head_dim=64,
        rope_theta=10000.0,
        rope_scaling=None,
        max_position_embeddings=32768,
        eos_token_ids=(PAD,),
        dtype=dtype,
    )


def estimator_configs(K: int, L: int) -> dict[str, LSHConfig]:
    """The systems the eval scores (`estimator_accuracy.py:50-100`): full
    attention, MagicPIG's LSH (bf16, int8 and int4 offload), Quest, TopK and
    block_topk in its block sizes and offload types."""
    base = dict(num_sink_tokens=4, num_local_tokens=64,
                generation_buffer=128)
    block = dict(K=1, L=0, estimator="block_topk", block_topk_budget_frac=0.08,
                 dense_layers=(0,), **base)
    return {
        "full": LSHConfig(K=0, L=0, **base),
        f"lsh_K{K}L{L}": LSHConfig(K=K, L=L, decode_mode="masked", **base),
        f"lsh_K{K}L{L}_int8": LSHConfig(K=K, L=L, decode_mode="masked",
                                        offload_quant="int8", **base),
        "quest_4pct": LSHConfig(K=1, L=0, estimator="quest",
                                quest_page_size=16, quest_budget_frac=0.04,
                                dense_layers=(0,), **base),
        "block_topk_8pct": LSHConfig(block_topk_block_size=256,
                                     offload_quant="int8", **block),
        "block_topk_int4": LSHConfig(block_topk_block_size=256,
                                     offload_quant="int4", **block),
        # 512-token blocks store int4 K packed (`config.packed_k4` at d = 64).
        "block_topk_int4pk": LSHConfig(block_topk_block_size=512,
                                       offload_quant="int4", **block),
        "block_topk_512_int8": LSHConfig(block_topk_block_size=512,
                                         offload_quant="int8", **block),
        # bench.py's block_topk4 mode: packed int4 K and int8 dense K/V.
        "block_topk4_flagship": LSHConfig(block_topk_block_size=512,
                                          offload_quant="int4",
                                          dense_quant="int8", **block),
        f"lsh_K{K}L{L}_int4": LSHConfig(K=K, L=L, decode_mode="masked",
                                        offload_quant="int4", **base),
        "topk_2pct": LSHConfig(K=1, L=0, estimator="topk",
                               topk_budget_frac=0.02, dense_layers=(0,),
                               **base),
    }


def make_eval_sample(rng: np.random.Generator, ctx: int, n_needles: int,
                     task: str = "single"):
    """One haystack of `ctx` tokens with the needles at least 256 tokens
    from its end, and its probes: (tokens int32 [ctx], [(query marker,
    key, expected value), ...]). Tasks (`estimator_accuracy.py:103-144`):
    "single" probes one random needle, "multiquery" every needle in a
    random order, "hop" one two-hop chain (MARK c k, then "[QUERY2] c"
    expects the value of the needle with key k)."""
    toks = rng.integers(FILLER_LO, FILLER_HI, size=ctx)
    toks[0] = BOS
    keys = rng.choice(np.arange(KEY_LO, KEY_HI), size=2 * n_needles,
                      replace=False)
    chain = keys[n_needles:]
    keys = keys[:n_needles]
    vals = rng.integers(VAL_LO, VAL_HI, size=n_needles)
    n_marks = 2 * n_needles if task == "hop" else n_needles
    pos = np.sort(rng.choice(np.arange(8, ctx - 256 - 3 * n_marks),
                             size=n_marks, replace=False))
    for i in range(n_needles):
        toks[pos[i]:pos[i] + 3] = (MARK, keys[i], vals[i])
    if task == "hop":
        for i in range(n_needles):
            p = pos[n_needles + i]
            toks[p:p + 3] = (MARK, chain[i], keys[i])
        queries = [(QUERY2, int(chain[i]), int(vals[i]))
                   for i in range(n_needles)]
        queries = [queries[rng.integers(0, n_needles)]]
    elif task == "multiquery":
        order = rng.permutation(n_needles)
        queries = [(QUERY, int(keys[i]), int(vals[i])) for i in order]
    else:
        qi = rng.integers(0, n_needles)
        queries = [(QUERY, int(keys[qi]), int(vals[qi]))]
    return toks.astype(np.int32), queries


def probe(llm, tokens: np.ndarray, queries) -> tuple[int, list[int]]:
    """One sample through slot 0 of `llm`: release, prefill, then for each
    probe decode its marker and its key and read the greedy token; the
    true value is teacher-forced before the next probe. Returns (correct
    probes, predicted tokens)."""
    llm.release_slot(0)
    llm.prefill(tokens, request_id=0)
    correct, preds = 0, []
    for j, (marker, key, value) in enumerate(queries):
        llm.inference(np.asarray([marker], np.int32))
        logits = llm.inference(np.asarray([key], np.int32))
        pred = int(logits[0].argmax())
        preds.append(pred)
        correct += pred == value
        if j + 1 < len(queries):
            llm.inference(np.asarray([value], np.int32))
    return correct, preds

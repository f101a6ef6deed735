"""Prediction driver: run the engine over generated task samples (port of
`magicpig_tpu/evals/ruler/predict.py`).

Equivalent of the reference's `pred/call_api.py` + `pred/xllm_gen.py` loop:
greedy decoding at temperature 0, per-task `tokens_to_generate`, prompts
longer than the engine takes cut from the front (their first 4 tokens
kept), resumable by skipping already-predicted indices
(`call_api.py:237-241`, `xllm_gen.py:136-140`), and an avg-sparsity
report per task (`xllm_gen.py:184-190`).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from magicpig_tpu_torch.config import ModelConfig
from magicpig_tpu_torch.evals.ruler.score import score_predictions, write_summary
from magicpig_tpu_torch.evals.ruler.tasks import TASK_SUITE, generate_task


def model_config(dtype: torch.dtype = torch.float32) -> ModelConfig:
    """The byte-vocab Llama of `data/ruler_lm_v2.npz`
    (`examples/train_ruler_lm.py::model_config`): 6 layers, hidden 256,
    8 query and 4 kv heads of 64, vocab 320 (259 used: bytes + pad, bos,
    eos)."""
    return ModelConfig(
        name="ruler-byte-lm",
        vocab_size=320,
        hidden_size=256,
        intermediate_size=1024,
        num_hidden_layers=6,
        num_attention_heads=8,
        num_key_value_heads=4,
        head_dim=64,
        rope_theta=100000.0,
        rope_scaling=None,
        max_position_embeddings=65536,
        eos_token_ids=(2,),
        dtype=dtype,
    )


def _existing_indices(path: str) -> set[int]:
    done = set()
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    done.add(json.loads(line)["index"])
                except (ValueError, KeyError, TypeError):
                    continue
    return done


def predict_task(llm, tokenizer, task: str, out_file: str,
                 num_samples: int = 50, target_tokens: int = 16384,
                 seed: int = 42, verbose: bool = True) -> dict:
    """Run one task; returns {"score", "n", "nulls", "avg_sparsity"}."""
    spec = TASK_SUITE[task]
    samples = generate_task(task, num_samples, target_tokens, seed=seed,
                            tokenizer=tokenizer)
    done = _existing_indices(out_file)
    os.makedirs(os.path.dirname(out_file) or ".", exist_ok=True)
    # Per-task sparsity: the change of the engine's lifetime counters, so
    # one engine reused across tasks reports each task's own average.
    snap = llm.sparsity_snapshot()

    with open(out_file, "a") as f:
        for s in samples:
            if s["index"] in done:
                continue
            ids = tokenizer.encode(s["input"] + s["answer_prefix"])
            max_ctx = llm.max_length - spec.tokens_to_generate - 1
            if len(ids) > max_ctx:  # front-truncate like long-context evals
                ids = ids[:4] + ids[len(ids) - (max_ctx - 4):]
            t0 = time.time()
            out_ids = llm.generate(np.asarray(ids, np.int32),
                                   max_tokens=spec.tokens_to_generate,
                                   temperature=0.0)
            pred = tokenizer.decode(out_ids)
            row = {
                "index": s["index"],
                "pred": pred,
                "outputs": s["outputs"],
                "input_tokens": len(ids),
                "time_s": round(time.time() - t0, 2),
            }
            f.write(json.dumps(row) + "\n")
            f.flush()
            if verbose:
                print(f"[{task}] {s['index']}: {len(ids)} tok -> "
                      f"{pred[:60]!r}", flush=True)

    result = score_predictions(out_file, spec.metric)
    result["avg_sparsity"] = float(llm.avg_sparsity_since(snap))
    return result


def run_suite(llm, tokenizer, out_dir: str, tasks=None, num_samples: int = 50,
              target_tokens: int = 16384, seed: int = 42,
              verbose: bool = True) -> dict:
    """Run a list of tasks (default: all 13) and write summary.csv."""
    tasks = tasks or list(TASK_SUITE)
    results = {}
    for t in tasks:
        out_file = os.path.join(out_dir, f"{t}.jsonl")
        results[t] = predict_task(llm, tokenizer, t, out_file,
                                  num_samples=num_samples,
                                  target_tokens=target_tokens, seed=seed,
                                  verbose=verbose)
        print(f"[{t}] score={results[t]['score']} "
              f"nulls={results[t]['nulls']} "
              f"sparsity={results[t]['avg_sparsity']:.4f}", flush=True)
    write_summary(results, out_dir)
    return results

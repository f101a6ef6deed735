#!/usr/bin/env python
"""Score every sparse estimator against full attention on the trained
needle model, on the PyTorch/CUDA port (`magicpig_tpu_torch`): the
counterpart of `examples/estimator_accuracy.py`, with its flags and
protocol. Per sample:

  release_slot(0); prefill([BOS] haystack-with-needles)
  inference([Q])                 # decode step 1 (estimator on)
  inference(k_q) -> argmax == v_q ?   # decode step 2: the retrieval

    python examples/estimator_accuracy_torch.py --ckpt data/needle_ckpt.npz \
        --contexts 2048,4096,8192 --samples 150

Rows are appended to <out>/summary.csv (default
results/estimator_accuracy_torch/; multiquery and hop write
summary_<task>.csv) with the columns context, estimator, accuracy,
avg_sparsity, n; a (context, estimator, n) row already there is skipped,
so a run resumes where it stopped (a rerun with more samples, so another
n, scores anew; an empty summary file gets its header). --weight-quant int8 / int4 quantizes the
loaded weights (names get "_w8" / "_w4"). On the card (--device cuda, the
default) the model runs in bf16, the type the kernels take; on the CPU in
f32. Imports only the port.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", type=str, default="data/needle_ckpt.npz")
    ap.add_argument("--contexts", type=str, default="2048,4096,8192")
    ap.add_argument("--samples", type=int, default=200)
    ap.add_argument("--needles", type=int, default=2)
    ap.add_argument("--task", type=str, default="single",
                    choices=["single", "multiquery", "hop"])
    ap.add_argument("--K", type=int, default=10)
    ap.add_argument("--L", type=int, default=150)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", type=str,
                    default="results/estimator_accuracy_torch")
    ap.add_argument("--estimators", type=str, default="",
                    help="comma-separated subset of estimator names "
                         "(default: all)")
    ap.add_argument("--weight-quant", type=str, default="none",
                    choices=["none", "int8", "int4"])
    ap.add_argument("--device", type=str, default="cuda",
                    choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from magicpig_tpu_torch.evals.needle import (
        estimator_configs,
        make_eval_sample,
        model_config,
        probe,
    )
    from magicpig_tpu_torch.models.convert import load_params
    from magicpig_tpu_torch.models.llama import quantize_params
    from magicpig_tpu_torch.runtime.engine import LLM

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    contexts = [int(c) for c in args.contexts.split(",")]
    cfg = model_config(torch.bfloat16 if dev.type == "cuda" else torch.float32)
    max_len = max(contexts) + 256
    params = load_params(args.ckpt, cfg, max_len, device=dev)
    suffix = ""
    if args.weight_quant != "none":
        bits = 4 if args.weight_quant == "int4" else 8
        params = quantize_params(params, bits=bits)
        cfg = dataclasses.replace(cfg, weight_quant=args.weight_quant)
        suffix = f"_w{bits}"
    if args.needles != 2:
        suffix += f"_n{args.needles}"
    os.makedirs(args.out, exist_ok=True)
    csv_name = ("summary.csv" if args.task == "single"
                else f"summary_{args.task}.csv")
    csv_path = os.path.join(args.out, csv_name)
    if not os.path.exists(csv_path) or os.path.getsize(csv_path) == 0:
        with open(csv_path, "w") as f:
            f.write("context,estimator,accuracy,avg_sparsity,n\n")
    with open(csv_path) as f:
        next(f)
        done = set()
        for line in f:
            ctx, name, *_, n = line.strip().split(",")
            done.add((ctx, name, n))

    configs = estimator_configs(args.K, args.L)
    if args.estimators:
        keep = args.estimators.split(",")
        configs = {n: c for n, c in configs.items() if n in keep}
    rows = []
    for ctx in contexts:
        rng = np.random.default_rng(args.seed + ctx)
        samples = [make_eval_sample(rng, ctx, args.needles, task=args.task)
                   for _ in range(args.samples)]
        n_probes = str(sum(len(queries) for _, queries in samples))
        for name, lsh in configs.items():
            if (str(ctx), f"{name}{suffix}", n_probes) in done:
                print(f"ctx={ctx} {name}{suffix}: done (resume skip)",
                      flush=True)
                continue
            llm = LLM(cfg, batch_size=1, max_length=ctx + 256,
                      chunk_size=min(2048, ctx), params=params, lsh=lsh,
                      device=dev)
            snap = llm.sparsity_snapshot()
            correct = total = 0
            t0 = time.perf_counter()
            for toks, queries in samples:
                c, _ = probe(llm, toks, queries)
                correct += c
                total += len(queries)
            acc = correct / total
            spars = llm.avg_sparsity_since(snap)
            rows.append((ctx, name, acc))
            with open(csv_path, "a") as f:
                f.write(f"{ctx},{name}{suffix},{acc:.4f},{spars:.4f},{total}\n")
            print(f"ctx={ctx} {name}{suffix}: acc={acc:.3f} sparsity="
                  f"{spars:.4f} ({time.perf_counter() - t0:.1f} s)", flush=True)
            del llm
    names = list(configs)
    print("\n| context | " + " | ".join(names) + " |")
    print("|---" * (len(names) + 1) + "|")
    for ctx in contexts:
        cells = [next((f"{a:.3f}" for c, n, a in rows if c == ctx and n == nm),
                      "-") for nm in names]
        print(f"| {ctx} | " + " | ".join(cells) + " |")
    print(f"\nwrote {csv_path}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Batched generation on the PyTorch/CUDA port (`magicpig_tpu_torch`), the
counterpart of `examples/batch_generation.py`: B sequential prefills, then
a batched greedy decode.

    python examples/batch_generation_torch.py --model llama-3.2-1b --B 4
    python examples/batch_generation_torch.py --device cpu --P 256 --G 8

The flags mirror the JAX example's (--model, --B, --M, --P, --G, --K, --L,
--data), plus --device (the card by default; cpu runs the kernels' plain
versions). --model is a preset name (random weights from seed 0). Imports
only the port.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", type=str, default="llama-tiny")
    p.add_argument("--B", type=int, default=4, help="batch size")
    p.add_argument("--M", type=int, default=2048, help="max length")
    p.add_argument("--P", type=int, default=1024, help="prefill length")
    p.add_argument("--G", type=int, default=32, help="generation length")
    p.add_argument("--K", type=int, default=10)
    p.add_argument("--L", type=int, default=150)
    p.add_argument("--data", type=str, default=None,
                   help="jsonl file with an 'input' field per line")
    p.add_argument("--device", type=str, default=None,
                   help="torch device: the card (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch

    from magicpig_tpu_torch.config import LSHConfig
    from magicpig_tpu_torch.runtime.engine import LLM
    from magicpig_tpu_torch.utils.tokenizer import get_tokenizer

    tok = get_tokenizer(None)
    if args.data:
        prompts = []
        with open(args.data) as f:
            for line in f:
                prompts.append(json.loads(line)["input"])
                if len(prompts) == args.B:
                    break
    else:
        prompts = [f"Request {i}: " + "All work and no play. " * 200
                   for i in range(args.B)]

    llm = LLM(args.model, batch_size=args.B, max_length=args.M,
              lsh=LSHConfig(K=args.K, L=args.L), device=args.device)

    first = []
    for i, text in enumerate(prompts):
        ids = tok.encode(text)[: args.P]
        logits = llm.prefill(ids, request_id=i)
        first.append(int(logits[0].argmax()))
    print(f"[INFO] prefilled {args.B} requests")

    toks = torch.tensor(first, dtype=torch.int32)
    if llm.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = llm.decode_steps(toks, args.G).cpu()          # [G, B]
    dt = time.perf_counter() - t0
    print(f"[INFO] Decoding Latency {1000 * dt / args.G:.2f} ms/token")
    print(f"[INFO] Decoding Throughput {args.B * args.G / dt:.2f} token/s")
    if llm.lsh.enabled:
        print(f"[INFO] Avg Sparsity {llm.avg_sparsity:.4f}")
    for b in range(args.B):
        print(f"--- request {b}: {tok.decode(out[:, b].tolist())!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

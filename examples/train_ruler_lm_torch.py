#!/usr/bin/env python
"""Train the byte-level RULER language model on the PyTorch/CUDA port
(`magicpig_tpu_torch`), the counterpart of `examples/train_ruler_lm.py`.

    python examples/train_ruler_lm_torch.py --steps 3000 --out data/ruler_lm.npz
    python examples/train_ruler_lm_torch.py --steps 2 --batch 2 --seq 1024 \
        --pool 4 --target-lo 64 --target-hi 96 --device cpu

The same model (`ruler-byte-lm`: 6 layers, vocab 320, hidden 256, 8/4 heads
of 64, f32), data (`gen_pool`: the port's RULER generators,
`evals/ruler/tasks.py::generate_task`, at seeds disjoint from the eval's
42, byte-encoded by `ByteTokenizer`), weighted next-byte loss (1 on answer
bytes, --lm-weight elsewhere), optimizer (AdamW, cosine schedule, every
leaf trained, the RoPE tables included) and flags as the JAX example; the
checkpoint in its `.npz` layout, which `examples/ruler_eval_torch.py
--npz` reads. A rolling partial (`<out>.partial.pt`, every --save-every
steps) holds the step and the optimizer's state, and a rerun resumes from
it. Without --init the weights are drawn by `init_params` from a CPU
generator seeded with --seed, then moved to the device (the card unless
--device cpu). Imports only the port.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TRAIN_TASKS = ("niah_single_1", "niah_single_2", "niah_single_3",
               "niah_multikey_1", "niah_multivalue", "niah_multiquery",
               "vt")


def model_config(dtype=None):
    """ruler-byte-lm: a byte vocabulary (259 used, padded to 320), d = 64
    with GQA, f32 unless `dtype` says otherwise."""
    import torch

    from magicpig_tpu_torch.config import ModelConfig

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
        dtype=torch.float32 if dtype is None else dtype,
    )


def gen_pool(n: int, seq: int, seed: int, target_lo: int, target_hi: int,
             rng: np.random.Generator, tasks=TRAIN_TASKS):
    """n byte-encoded samples, as `examples/train_ruler_lm.py::gen_pool`
    draws them: (tokens [n, seq] i32, answer [n, seq] bool at the
    next-byte indices of the answer, valid [n, seq] bool). Tasks cycle
    through `tasks`, each call of the generator a fresh seed >= 10000."""
    from magicpig_tpu_torch.evals.ruler.tasks import generate_task
    from magicpig_tpu_torch.utils.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    toks = np.zeros((n, seq), np.int32)
    answer = np.zeros((n, seq), bool)
    valid = np.zeros((n, seq), bool)
    i = 0
    batch_idx = 0
    while i < n:
        task = tasks[batch_idx % len(tasks)]
        tt = int(rng.integers(target_lo, target_hi + 1))
        samples = generate_task(task, min(64, n - i), tt,
                                seed=10000 + seed * 131 + batch_idx)
        batch_idx += 1
        for s in samples:
            prompt = s["input"] + s["answer_prefix"]
            full = prompt + " " + ", ".join(s["outputs"]) + "."
            ids = tok.encode(full)
            plen = len(tok.encode(prompt))
            if len(ids) > seq:      # drop over-long draws
                continue
            toks[i, :len(ids)] = ids
            valid[i, :len(ids)] = True
            answer[i, plen - 1:len(ids) - 1] = True   # next-token indices
            i += 1
            if i == n:
                break
    return toks, answer, valid


def loss_weights(answer: np.ndarray, valid: np.ndarray,
                 lm_weight: float) -> np.ndarray:
    """1 at answer-byte predictions, lm_weight on the other valid bytes."""
    return np.where(answer, 1.0,
                    np.where(valid, lm_weight, 0.0)).astype(np.float32)


def next_byte_loss(logits, tokens, wts):
    """The weighted next-byte loss and the answer bytes' accuracy."""
    from magicpig_tpu_torch.training import masked_loss

    return masked_loss(logits[:, :-1], tokens[:, 1:], wts[:, :-1])


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=8192,
                    help="byte context (~6x the generator's target_tokens)")
    ap.add_argument("--target-lo", type=int, default=128)
    ap.add_argument("--target-hi", type=int, default=1024)
    ap.add_argument("--pool", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--lm-weight", type=float, default=0.05,
                    help="loss weight on non-answer next-byte prediction")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default="data/ruler_lm.npz")
    ap.add_argument("--init", type=str, default=None)
    ap.add_argument("--train-tasks", type=str, default=None,
                    help="comma list with repetition = sampling weight "
                         "(e.g. 'vt,vt,vt,niah_single_1' oversamples vt 3:1)")
    ap.add_argument("--save-every", type=int, default=500,
                    help="steps between rolling partials")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device: the card (default) or cpu")
    return ap.parse_args(argv)


def train(args) -> dict:
    """Run the training `args` describe; returns the per-step losses and
    answer accuracies (floats), the first step run (`start`) and the wall
    clock at each printed step (`printed`: the print waits for the step's
    loss, so for the device)."""
    import torch

    from magicpig_tpu_torch import training
    from magicpig_tpu_torch.models.convert import save_params
    from magicpig_tpu_torch.runtime.engine import resolve_device

    tasks = (tuple(args.train_tasks.split(","))
             if args.train_tasks else TRAIN_TASKS)
    dev = resolve_device(args.device)
    cfg = model_config()
    params = training.initial_params(cfg, args.seq, args.seed, dev,
                                     init=args.init)
    opt = training.adamw(params, args.lr)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    partial = training.partial_path(args.out)
    start = 0
    if os.path.exists(partial):
        start = training.load_partial(partial, params, opt)
        print(f"resumed from {partial} at step {start}", flush=True)

    rng = np.random.default_rng(args.seed + 1)
    t0 = time.time()
    print("generating sample pool...", flush=True)
    toks, answer, valid = gen_pool(args.pool, args.seq, args.seed,
                                   args.target_lo, args.target_hi, rng,
                                   tasks=tasks)
    wts = loss_weights(answer, valid, args.lm_weight)
    print(f"pool ready ({time.time() - t0:.0f}s); training", flush=True)

    losses, accs, printed = [], [], []
    for i in range(args.steps):
        sel = rng.integers(0, args.pool, size=args.batch)
        if i < start:
            continue
        tokens = torch.from_numpy(toks[sel]).to(dev)
        # The tokens are the model's input and, shifted, the loss's target.
        loss, acc = training.train_step(
            params, cfg, opt, training.cosine_decay(args.lr, args.steps, i),
            next_byte_loss, tokens, tokens,
            torch.from_numpy(wts[sel]).to(dev))
        losses.append(loss)
        accs.append(acc)
        if i % 100 == 0 or i == args.steps - 1:
            print(f"step {i}: loss {float(loss):.4f} answer-acc "
                  f"{float(acc):.3f} ({time.time() - t0:.0f}s)", flush=True)
            printed.append(time.time())
        if (i % args.save_every == 0 or i == args.steps - 1) and i > start:
            training.save_partial(partial, i, params, opt)
    save_params(params, args.out)
    if os.path.exists(partial):
        os.remove(partial)
    print(f"saved {args.out}", flush=True)
    return dict(losses=[float(x) for x in losses],
                accs=[float(x) for x in accs], printed=printed, start=start)


def main(argv=None) -> int:
    train(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())

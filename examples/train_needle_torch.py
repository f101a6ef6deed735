#!/usr/bin/env python
"""Train the needle-in-haystack retrieval model on the PyTorch/CUDA port
(`magicpig_tpu_torch`), the counterpart of `examples/train_needle.py`.

    python examples/train_needle_torch.py --steps 3000 --out data/needle_ckpt.npz
    python examples/train_needle_torch.py --steps 4 --batch 2 --seq 256 --device cpu

The same model (`needle-12m`: 4 layers, hidden 256, 8/4 heads of 64, f32),
task (`make_batch`, a copy of the JAX example's numpy generator: needles
"[MARK] k v" in a filler haystack, every needle queried in a tail block,
the loss at each queried value), loss, optimizer (AdamW, cosine schedule
to 0.1 of --lr, every leaf trained, the RoPE tables included) and flags as
the JAX example; the checkpoint is written in its `.npz` layout
(`models/convert.py::save_params`), which `examples/estimator_accuracy_torch.py`
and the JAX package both read. On the card the attention runs the
flash_prefill kernel forward and the flash_prefill_bwd kernel backward;
`--device cpu` runs their plain versions.

Unlike the JAX example, a run resumes from its rolling partial
(`<out>.partial.pt`, written every --save-every steps) with or without
--init, and the partial holds the step and the optimizer's state, so the
schedule and the moments continue where the run stopped. Without --init
the weights are drawn by the port's `init_params` from a CPU generator
seeded with --seed (the same numbers on every machine), then moved to the
device. Imports only the port.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# -- vocabulary (as examples/train_needle.py) ---------------------------------
PAD, BOS, MARK, QUERY = 0, 1, 2, 3
QUERY2 = 4                         # 2-hop (variable-tracking) query marker
FILLER_LO, FILLER_HI = 8, 448      # haystack noise tokens
KEY_LO, KEY_HI = 448, 704          # needle keys
VAL_LO, VAL_HI = 704, 960          # needle values
VOCAB = 1024


def model_config(dtype=None):
    """needle-12m: d = 64 with GQA, f32 unless `dtype` says otherwise."""
    import torch

    from magicpig_tpu_torch.config import ModelConfig

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
        dtype=torch.float32 if dtype is None else dtype,
    )


def make_batch(rng: np.random.Generator, batch: int, seq: int,
               n_needles: int = 4, min_seq: int | None = None,
               hop_frac: float = 0.0):
    """(tokens [B, seq] i32, target [B, seq] i32, mask [B, seq] bool), the
    draws of `examples/train_needle.py::make_batch` in the same order, so
    one seed gives both trainers the same batches. Every needle is queried
    in a tail block "[Q] k v [Q] k v ..." and the loss applies at each
    value position. min_seq: each sequence's content length is uniform in
    [min_seq, seq], the query block at its end. hop_frac: the share of
    samples drawn as the 2-hop variable-tracking analogue (a chain link
    "[MARK] c k" per needle, queried as "[QUERY2] c" for the needle's
    value)."""
    qlen = 3 * n_needles
    toks = rng.integers(FILLER_LO, FILLER_HI, size=(batch, seq))
    keys = np.stack([rng.choice(np.arange(KEY_LO, KEY_HI),
                                size=2 * n_needles,
                                replace=False) for _ in range(batch)])
    chain = keys[:, n_needles:]
    keys = keys[:, :n_needles]
    vals = rng.integers(VAL_LO, VAL_HI, size=(batch, n_needles))
    target = np.zeros((batch, seq), np.int64)
    mask = np.zeros((batch, seq), bool)
    for b in range(batch):
        hop = rng.random() < hop_frac
        r = seq if min_seq is None else int(rng.integers(min_seq, seq + 1))
        # Needles at least ~256 tokens before the query block.
        far = min(256, (r - qlen) // 2)
        hi = r - qlen - 3 * n_needles - far
        n_marks = 2 * n_needles if hop else n_needles
        pos = np.sort(rng.choice(np.arange(1, max(hi, 2)),
                                 size=n_marks, replace=False))
        for i in range(n_needles):
            toks[b, pos[i]:pos[i] + 3] = (MARK, keys[b, i], vals[b, i])
        if hop:
            for i in range(n_needles):
                p = pos[n_needles + i]
                toks[b, p:p + 3] = (MARK, chain[b, i], keys[b, i])
        order = rng.permutation(n_needles)
        base = r - qlen
        for j, qi in enumerate(order):
            qk = chain[b, qi] if hop else keys[b, qi]
            toks[b, base + 3 * j:base + 3 * j + 3] = (
                QUERY2 if hop else QUERY, qk, vals[b, qi])
            target[b, base + 3 * j + 1] = vals[b, qi]
            mask[b, base + 3 * j + 1] = True
    toks[:, 0] = BOS
    return (toks.astype(np.int32), target.astype(np.int32), mask)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--needles", type=int, default=4)
    ap.add_argument("--min-seq", type=int, default=None,
                    help="variable content length: uniform in [min_seq, seq]")
    ap.add_argument("--hop-frac", type=float, default=0.0,
                    help="fraction of samples as the 2-hop vt analogue")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default="data/needle_ckpt.npz")
    ap.add_argument("--init", type=str, default=None,
                    help="checkpoint (.npz) to continue from")
    ap.add_argument("--save-every", type=int, default=100,
                    help="steps between rolling partials")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device: the card (default) or cpu")
    return ap.parse_args(argv)


def train(args) -> dict:
    """Run the training `args` describe; returns the per-step losses and
    accuracies (floats), the first step run (`start`) and the wall clock at
    each printed step (`printed`: the print waits for the step's loss, so
    for the device)."""
    import torch

    from magicpig_tpu_torch import training
    from magicpig_tpu_torch.models.convert import save_params
    from magicpig_tpu_torch.runtime.engine import resolve_device

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

    # Batches come from one seeded stream; a resumed run draws and drops
    # the batches of the steps already taken.
    rng = np.random.default_rng(args.seed + 1)
    t0 = time.time()
    losses, accs, printed = [], [], []
    for i in range(args.steps):
        toks, tgt, msk = make_batch(rng, args.batch, args.seq, args.needles,
                                    min_seq=args.min_seq,
                                    hop_frac=args.hop_frac)
        if i < start:
            continue
        batch = [torch.from_numpy(x).to(dev) for x in (toks, tgt, msk)]
        loss, acc = training.train_step(
            params, cfg, opt, training.cosine_decay(args.lr, args.steps, i),
            training.masked_loss, *batch)
        losses.append(loss)
        accs.append(acc)
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i}: loss {float(loss):.4f} acc {float(acc):.3f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
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

#!/usr/bin/env python
"""Write the port's needle-12m initial weights (init_params from a CPU
generator seeded with --seed, max_len --seq) in the JAX `.npz` layout, and
print their digest, so that the unmodified JAX example can train from the
same weights as `examples/train_needle_torch.py --seed <seed>` does.

    python results/train_needle_jax_cpu/make_init.py --seed 0 --seq 1024 --out init.npz
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "examples"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--out", type=str, required=True)
    args = ap.parse_args()

    from train_needle_torch import model_config

    from magicpig_tpu_torch.models.convert import save_params
    from magicpig_tpu_torch.training import digest, initial_params

    params = initial_params(model_config(), args.seq, args.seed, "cpu")
    save_params(params, args.out)
    print(f"init digest {digest(params)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

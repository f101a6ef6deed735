#!/usr/bin/env python
"""RULER-equivalent evaluation on the PyTorch/CUDA port
(`magicpig_tpu_torch`), the counterpart of `examples/ruler_eval.py`:
data generation, prediction and scoring in one command.

    # the 13-task suite on the byte-level model, full attention, on the card
    python examples/ruler_eval_torch.py --npz data/ruler_lm_v2.npz \
        --seq 1152 --samples 50 --max-length 6912 --K 0

    # the same model under Quest on the CPU, two tasks
    python examples/ruler_eval_torch.py --npz data/ruler_lm_v2.npz \
        --seq 1152 --samples 2 --estimator quest --tasks niah_single_1 vt \
        --device cpu

The flags are `examples/ruler_eval.py`'s, with --device (default cuda) in
place of --cpu. Estimator selection follows the reference: --K 0 is full
attention, --K < 0 Quest, --estimator overrides (its K is |K|, or 10).
--max-length defaults to --seq + 512; prompts longer than it allows are
cut from the front. --npz loads a byte-level checkpoint of
`examples/train_ruler_lm.py` (`evals/ruler::model_config`), --checkpoint a
local HF directory, else --model names a preset with random weights. On
the card the model runs in bf16, the type the kernels take; on the CPU in
f32. Predictions go to <out>/<model>_seq<seq>_<estimator>_K<K>L<L><tag>/,
one jsonl per task and summary.csv. Imports only the port.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BUDGET_FIELDS = {"topk": "topk_budget_frac",
                 "block_topk": "block_topk_budget_frac",
                 "quest": "quest_budget_frac",
                 "oracle_sampling": "os_budget_frac"}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", type=str, default="llama-tiny")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="local HF checkpoint dir (config.json + safetensors)")
    p.add_argument("--npz", type=str, default=None,
                   help="byte-level checkpoint of examples/train_ruler_lm.py")
    p.add_argument("--tokenizer", type=str, default=None)
    p.add_argument("--tasks", type=str, nargs="*", default=None,
                   help="subset of tasks (default: all 13)")
    p.add_argument("--seq", type=int, default=16384,
                   help="target context size of the task generators")
    p.add_argument("--samples", type=int, default=50)
    p.add_argument("--K", type=int, default=10)
    p.add_argument("--L", type=int, default=150)
    p.add_argument("--estimator", type=str, default=None,
                   choices=["lsh", "quest", "topk", "oracle_sampling",
                            "block_topk"])
    p.add_argument("--decode-mode", type=str, default="masked",
                   choices=["sampled", "masked"])
    p.add_argument("--debias", type=str, default="exact",
                   choices=["exact", "poly", "none"])
    p.add_argument("--budget-frac", type=float, default=None,
                   help="the selected estimator's budget fraction")
    p.add_argument("--block-size", type=int, default=None,
                   help="block_topk ranking block size")
    p.add_argument("--offload-quant", type=str, default=None,
                   choices=["none", "int8", "int4"])
    p.add_argument("--tag", type=str, default="",
                   help="suffix of the output directory's name")
    p.add_argument("--max-length", type=int, default=None)
    p.add_argument("--out", type=str, default="ruler_out")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (the kernels) or cpu (their "
                        "plain versions)")
    return p.parse_args(argv)


def lsh_config(args):
    """The `LSHConfig` the flags select, as `examples/ruler_eval.py` does."""
    from magicpig_tpu_torch.config import LSHConfig

    kw = {}
    if args.estimator:
        kw["estimator"] = args.estimator
        kw["K"] = abs(args.K) or 10
    elif args.K < 0:
        kw["estimator"] = "quest"
        kw["K"] = -args.K
    else:
        kw["K"] = args.K
    field = BUDGET_FIELDS.get(kw.get("estimator", "lsh"))
    if args.budget_frac is not None and field:
        kw[field] = args.budget_frac
    if args.block_size is not None:
        kw["block_topk_block_size"] = args.block_size
    if args.offload_quant is not None:
        kw["offload_quant"] = args.offload_quant
    return LSHConfig(L=args.L, decode_mode=args.decode_mode,
                     lsh_debias=args.debias, **kw)


def main(argv=None) -> int:
    args = parse_args(argv)

    import time

    import torch

    from magicpig_tpu_torch.config import preset
    from magicpig_tpu_torch.evals.ruler import model_config, run_suite
    from magicpig_tpu_torch.runtime.engine import LLM
    from magicpig_tpu_torch.utils.tokenizer import get_tokenizer

    device = torch.device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    max_len = args.max_length or (args.seq + 512)
    if args.checkpoint:
        from magicpig_tpu_torch.models.loader import load_checkpoint

        config, params = load_checkpoint(args.checkpoint, max_len, device=device)
    elif args.npz:
        from magicpig_tpu_torch.models.convert import load_params

        config = model_config(dtype)
        params = load_params(args.npz, config, max_len, device=device)
    else:
        config, params = preset(args.model), None
    lsh = lsh_config(args)
    llm = LLM(config, batch_size=1, max_length=max_len, lsh=lsh, params=params,
              seed=0, device=device)
    tok = get_tokenizer(args.tokenizer or args.checkpoint)

    out_dir = os.path.join(args.out, f"{config.name}_seq{args.seq}_"
                                     f"{lsh.estimator}_K{lsh.K}L{lsh.L}"
                                     f"{args.tag}")
    t = time.perf_counter()
    results = run_suite(llm, tok, out_dir, tasks=args.tasks,
                        num_samples=args.samples, target_tokens=args.seq,
                        seed=args.seed, verbose=False)
    avg = sum(r["score"] for r in results.values()) / max(len(results), 1)
    print(f"\n== {config.name} seq={args.seq} {lsh.estimator} "
          f"K{lsh.K}/L{lsh.L}: average score {avg:.2f} "
          f"({time.perf_counter() - t:.1f} s on {device}, "
          f"{config.dtype}) ==")
    print(f"summary: {os.path.join(out_dir, 'summary.csv')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

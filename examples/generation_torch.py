#!/usr/bin/env python
"""Single-prompt chat generation on the PyTorch/CUDA port
(`magicpig_tpu_torch`), the counterpart of `examples/generation.py`.

    python examples/generation_torch.py --model llama-tiny --device cpu
    python examples/generation_torch.py --model /path/to/hf_checkpoint

The arguments mirror `examples/generation.py` (--model/--M/--G/--K/--L/--t/
--template/--data/--weight-quant), plus --device (default cuda). --model is
a preset name (random weights, drawn from seed 0) or a local HF checkpoint
directory (config.json and *.safetensors, `models/loader.py`), whose
sliding window, if its config sets one, the engine applies. The tokenizer
is the checkpoint's own when `transformers` can load it, else the byte
tokenizer. Imports only the port.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", type=str, default="llama-tiny",
                   help="preset name or HF checkpoint dir")
    p.add_argument("--M", type=int, default=4096, help="max length")
    p.add_argument("--G", type=int, default=64, help="generation length")
    p.add_argument("--K", type=int, default=10)
    p.add_argument("--L", type=int, default=150)
    p.add_argument("--t", type=float, default=0.6, help="temperature")
    p.add_argument("--template", type=str, default="None",
                   choices=["meta-llama2", "meta-llama3", "None"])
    p.add_argument("--data", type=str, default=None,
                   help="text file to use as the prompt")
    p.add_argument("--weight-quant", type=str, default="none",
                   choices=["none", "int8", "int4"],
                   help="W8A8 / W4A8 weight quantization")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (the kernels) or cpu (their "
                        "plain versions)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import dataclasses

    from magicpig_tpu_torch.config import PRESETS, LSHConfig, preset
    from magicpig_tpu_torch.models.template import Templates
    from magicpig_tpu_torch.runtime.engine import LLM
    from magicpig_tpu_torch.utils.tokenizer import get_tokenizer

    if args.data:
        with open(args.data) as f:
            text = f.read()
    else:
        text = "Tell me a story about a tiny TPU that learned to hash."
    text = Templates[args.template].format(text)

    local = os.path.isdir(args.model)
    tok = get_tokenizer(args.model if local else None)
    ids = tok.encode(text)
    lsh = LSHConfig(K=args.K, L=args.L)

    if local:
        from magicpig_tpu_torch.models.loader import load_checkpoint

        cfg, params = load_checkpoint(args.model, args.M,
                                      weight_quant=args.weight_quant,
                                      device=args.device)
        llm = LLM(cfg, max_length=args.M, lsh=lsh, params=params,
                  device=args.device)
    else:
        if args.model not in PRESETS:
            raise SystemExit(f"unknown preset {args.model!r}; known: "
                             f"{sorted(PRESETS)}")
        cfg = preset(args.model)
        if args.weight_quant != "none":
            cfg = dataclasses.replace(cfg, weight_quant=args.weight_quant)
        llm = LLM(cfg, max_length=args.M, lsh=lsh, device=args.device)

    ids = ids[: args.M - args.G - 1]
    out = llm.generate(ids, max_tokens=args.G, temperature=args.t,
                       verbose=True)
    print(tok.decode(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Generate the offline data assets (see data/README.md) with the PyTorch
port's generators, the counterpart of `examples/make_data.py`: the same
files, byte for byte, from `magicpig_tpu_torch/evals/ruler/tasks.py`.

    python examples/make_data_torch.py --out data --samples 8

Imports only the port (the generators themselves are plain Python).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from magicpig_tpu_torch.evals.ruler.tasks import gen_niah  # noqa: E402

STORY_OPENING = """\
The cartographer of Vel kept two maps of the same coast. The first she drew
as the surveyors reported it, all soundings and bearings, initialed at each
revision. The second she drew from the stories sailors told in the tea house
by the quay: a reef that sang in north wind, a channel that silted shut the
year of the comet, an island that appeared only on the charts of those who
had wrecked there. When the harbor master demanded to know which map was
true, she said both, and neither, and that the only honest chart was the one
still being corrected.

Her apprentice, who had come from the inland city to learn the coast,
believed at first that the second map was a joke at his expense. He checked
its reef against the first map and found no reef. He sailed the channel it
called shut and passed through easily. But in his third winter a storm drove
the ferry onto a bar that no surveyor had ever sounded, exactly where the
tea-house map showed a drowned forest, and he began to keep his own second
map, folded inside the first.
"""


def make_story(path: str, approx_words: int = 4000):
    from magicpig_tpu_torch.evals.ruler.tasks import _essay_text  # noqa
    import random

    rng = random.Random("story")
    body = " ".join(_essay_text(rng, approx_words))
    with open(path, "w") as f:
        f.write(STORY_OPENING + "\n" + body + "\n")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", type=str, default="data")
    p.add_argument("--samples", type=int, default=8)
    args = p.parse_args()
    os.makedirs(args.out, exist_ok=True)

    make_story(os.path.join(args.out, "story.txt"))
    print(f"wrote {args.out}/story.txt")

    for name, tokens in [("data4k", 4096), ("data16k", 16384),
                         ("data32k", 32768), ("data64k", 65536),
                         ("data96k", 98304)]:
        rows = gen_niah(args.samples, tokens, seed=11)
        path = os.path.join(args.out, f"{name}.jsonl")
        with open(path, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
        print(f"wrote {path} ({args.samples} samples @ ~{tokens} tokens)")


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Compare two RULER runs task by task: the score of each (string match,
as `evals/ruler/score.py` scores them), the 13-task averages, and how many
predictions are equal string for string, with the first sample of each
task where they part.

    python examples/ruler_compare.py results/ruler_r5/ruler-byte-lm_seq1152_lsh_K0L150 \
        ruler_out/ruler-byte-lm_seq1152_lsh_K0L150

Each directory holds one `<task>.jsonl` of predictions per task
(`examples/ruler_eval.py`, `examples/ruler_eval_torch.py`). Only the tasks
both hold are compared. Imports only the port's copy of the scorer.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _rows(path: str) -> dict[int, dict]:
    with open(path) as f:
        return {r["index"]: r for r in map(json.loads, f)}


def compare(dir_a: str, dir_b: str) -> dict:
    """{"tasks": {task: {"score_a", "score_b", "n", "equal",
    "first_diff"}}, "avg_a", "avg_b", "equal", "n"}."""
    from magicpig_tpu_torch.evals.ruler import TASK_SUITE
    from magicpig_tpu_torch.evals.ruler.score import score_predictions

    tasks = {}
    for task, spec in TASK_SUITE.items():
        pa, pb = (os.path.join(d, f"{task}.jsonl") for d in (dir_a, dir_b))
        if not (os.path.exists(pa) and os.path.exists(pb)):
            continue
        a, b = _rows(pa), _rows(pb)
        common = sorted(set(a) & set(b))
        differ = [i for i in common if a[i]["pred"] != b[i]["pred"]]
        tasks[task] = {
            "score_a": score_predictions(pa, spec.metric)["score"],
            "score_b": score_predictions(pb, spec.metric)["score"],
            "n": len(common), "equal": len(common) - len(differ),
            "first_diff": differ[0] if differ else None}
    n = max(len(tasks), 1)
    return {"tasks": tasks,
            "avg_a": round(sum(t["score_a"] for t in tasks.values()) / n, 2),
            "avg_b": round(sum(t["score_b"] for t in tasks.values()) / n, 2),
            "equal": sum(t["equal"] for t in tasks.values()),
            "n": sum(t["n"] for t in tasks.values())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("dir_a")
    p.add_argument("dir_b")
    args = p.parse_args(argv)
    r = compare(args.dir_a, args.dir_b)
    print(f"{'task':18s} {'A':>7s} {'B':>7s}  equal  first differing sample")
    for task, t in r["tasks"].items():
        print(f"{task:18s} {t['score_a']:7.2f} {t['score_b']:7.2f}  "
              f"{t['equal']:2d}/{t['n']:2d}  {t['first_diff']}")
    print(f"{'average':18s} {r['avg_a']:7.2f} {r['avg_b']:7.2f}  "
          f"{r['equal']}/{r['n']} predictions equal "
          f"({r['equal'] / max(r['n'], 1):.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

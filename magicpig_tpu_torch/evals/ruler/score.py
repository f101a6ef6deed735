"""String-match scoring + summary (reference `eval/evaluate.py` +
`eval/synthetic/constants.py:25-48`): the port's own copy of
`magicpig_tpu/evals/ruler/score.py`."""

from __future__ import annotations

import csv
import json
import os


def string_match_part(preds: list[str], refs: list[list[str]]) -> float:
    """Score = % of samples where ANY reference appears in the prediction
    (case-insensitive substring) — the reference's qa metric."""
    score = sum(
        max(1.0 if r.lower() in p.lower() else 0.0 for r in ref)
        for p, ref in zip(preds, refs)
    ) / max(len(preds), 1) * 100
    return round(score, 2)


def string_match_all(preds: list[str], refs: list[list[str]]) -> float:
    """Score = mean fraction of references contained in each prediction —
    the reference's niah/vt/cwe/fwe metric."""
    score = sum(
        sum(1.0 if r.lower() in p.lower() else 0.0 for r in ref) / len(ref)
        for p, ref in zip(preds, refs)
    ) / max(len(preds), 1) * 100
    return round(score, 2)


METRICS = {
    "string_match_all": string_match_all,
    "string_match_part": string_match_part,
}


def score_predictions(pred_file: str, metric: str) -> dict:
    """Score one predictions jsonl ({"pred", "outputs", ...} rows). Returns
    {"score", "n", "nulls"} (null counting mirrors `evaluate.py:15-24`)."""
    preds, refs, nulls = [], [], 0
    with open(pred_file) as f:
        for line in f:
            row = json.loads(line)
            p = row.get("pred", "")
            if not p.strip():
                nulls += 1
            preds.append(p)
            refs.append(row["outputs"])
    return {"score": METRICS[metric](preds, refs), "n": len(preds),
            "nulls": nulls}


def write_summary(results: dict[str, dict], out_dir: str) -> str:
    """Write summary.csv (task, score, n, nulls) like the reference's
    `eval/evaluate.py` summary output."""
    path = os.path.join(out_dir, "summary.csv")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["task", "score", "n", "nulls"])
        for task, r in sorted(results.items()):
            w.writerow([task, r["score"], r["n"], r["nulls"]])
        if results:
            avg = sum(r["score"] for r in results.values()) / len(results)
            w.writerow(["average", round(avg, 2), "", ""])
    return path

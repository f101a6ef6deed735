"""Log-sum-exp merge of attention partials (port of
`magicpig_tpu/ops/merge.py`).

Partials over disjoint token sets, each returning (out, lse), combine
exactly; a partial with no tokens passes lse = -inf and contributes nothing.
"""

from __future__ import annotations

import torch


def merge_partials(outs, lses):
    """outs: sequence of [..., d]; lses: sequence of [...] natural-log LSE.
    Returns (out [..., d] f32, lse [...] f32)."""
    lse = torch.stack([l.float() for l in lses], dim=0)     # [N, ...]
    out = torch.stack([o.float() for o in outs], dim=0)     # [N, ..., d]
    m = torch.max(lse, dim=0).values
    empty = torch.isneginf(m)
    safe_m = torch.where(empty, torch.zeros_like(m), m)
    w = torch.exp(lse - safe_m.unsqueeze(0))
    denom = torch.sum(w, dim=0)
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    merged = torch.sum(out * w.unsqueeze(-1), dim=0) / safe.unsqueeze(-1)
    merged_lse = torch.where(empty, torch.full_like(m, -torch.inf),
                             safe_m + torch.log(safe))
    return merged, merged_lse

"""Row gathers over column lanes.

Counterpart of trino_tpu/ops/filter_project.py; filters and projections
themselves run in exec/local.py's visitors (masks stay with the batch).
"""
from __future__ import annotations

from typing import Dict

import torch

from ..expr.lower import Lane


def permute_lanes(
    lanes: Dict[str, Lane], idx: torch.Tensor, extra_ok=None
) -> Dict[str, Lane]:
    """Gather every lane (values, and limbs of wide lanes, alike) at
    `idx`; `extra_ok` optionally ANDs a mask into every validity lane."""
    out: Dict[str, Lane] = {}
    for s, (v, ok) in lanes.items():
        okg = ok[idx]
        if extra_ok is not None:
            okg = okg & extra_ok
        out[s] = (v[idx], okg)
    return out

"""Filter + project over column lanes, and row gathers.

Counterpart of trino_tpu/ops/filter_project.py.  The executor's visitors
(exec/local.py) filter and project node by node; compile_filter_project
is the fused form over one batch: the filter narrows the selection mask
(no compaction: the mask stays with the batch) and the projections are
lowered expressions.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..expr import ir
from ..expr.lower import Lane, LoweringContext, compile_expr

Batch = Tuple[Dict[str, Lane], torch.Tensor]  # (columns, selection mask)


def compile_filter_project(
    filter_expr: Optional[ir.Expr],
    projections: List[Tuple[str, ir.Expr]],
    ctx: Optional[LoweringContext] = None,
) -> Callable[[Dict[str, Lane], torch.Tensor], Batch]:
    """Compile to a function (cols, sel) -> (out_cols, sel')."""
    fil = compile_expr(filter_expr, ctx) if filter_expr is not None else None
    projs = [(name, compile_expr(e, ctx)) for name, e in projections]

    def apply(cols: Dict[str, Lane], sel: torch.Tensor) -> Batch:
        if fil is not None:
            v, ok = fil(cols)
            sel = sel & v & ok
        return {name: p(cols) for name, p in projs}, sel

    return apply


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

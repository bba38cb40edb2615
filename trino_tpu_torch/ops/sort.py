"""Sort / TopN / Limit.

Counterpart of trino_tpu/ops/sort.py.  The JAX package sorts with one
multi-operand lax.sort; here the same operands (selection flag, then per
key a null bit and the value, descending keys complemented) are sorted
least-significant first with stable argsorts, which yields the same
permutation (ties keep row order, as lax.sort's trailing row index does).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch

from ..expr.lower import Lane


@dataclasses.dataclass(frozen=True)
class SortKey:
    column: str
    ascending: bool = True
    nulls_first: bool = False  # Trino default: NULLS LAST for ASC


def _operand(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.int8) if v.dtype == torch.bool else v


def sort_perm(
    keys: Sequence[SortKey],
    lanes: Dict[str, Lane],
    sel: torch.Tensor,
) -> torch.Tensor:
    """Permutation ordering selected rows by keys; unselected rows last."""
    operands: List[torch.Tensor] = [torch.logical_not(sel)]
    for k in keys:
        v, ok = lanes[k.column]
        nullbit = torch.logical_not(ok) if not k.nulls_first else ok
        operands.append(nullbit)
        if v.dim() == 2:
            from . import wide_decimal as wd

            operands.extend(wd.order_operands(v, not k.ascending))
            continue
        vv = _operand(v)
        operands.append(vv if k.ascending else _negate_for_desc(vv))
    return lex_perm(operands)


def lex_perm(operands: Sequence[torch.Tensor]) -> torch.Tensor:
    """Permutation sorting rows by the operands, the first most
    significant (the JAX package's multi-operand lax.sort): stable
    argsorts from the last operand to the first."""
    perm = torch.arange(operands[0].shape[0], dtype=torch.int64,
                        device=operands[0].device)
    for op in reversed(operands):
        perm = perm[torch.argsort(_operand(op)[perm], stable=True)]
    return perm


def _negate_for_desc(v: torch.Tensor) -> torch.Tensor:
    if v.is_floating_point():
        return -v
    if v.dtype == torch.bool:
        return torch.logical_not(v)
    # bitwise complement, not negation: -INT64_MIN wraps to itself
    return ~v.to(torch.int64)


def apply_perm(
    lanes: Dict[str, Lane], perm: torch.Tensor, sel: torch.Tensor
) -> Tuple[Dict[str, Lane], torch.Tensor]:
    from .filter_project import permute_lanes

    return permute_lanes(lanes, perm), sel[perm]


def topn(
    keys: Sequence[SortKey],
    lanes: Dict[str, Lane],
    sel: torch.Tensor,
    n: int,
) -> Tuple[Dict[str, Lane], torch.Tensor, None]:
    """Sorted first-n rows.  Eager execution has no compile cost to
    avoid, so this is one exact full sort and a slice (the JAX package's
    two-phase top_k candidate scheme and its tie check are not needed);
    the third result is always None (no capacity check)."""
    perm = sort_perm(keys, lanes, sel)
    out, s = apply_perm(lanes, perm, sel)
    out = {name: (v[:n], ok[:n]) for name, (v, ok) in out.items()}
    return out, s[:n], None


def limit(
    lanes: Dict[str, Lane], sel: torch.Tensor, n: int, offset: int = 0
) -> Tuple[Dict[str, Lane], torch.Tensor]:
    """Keep selected rows (offset, offset+n] by running count."""
    running = torch.cumsum(sel.to(torch.int64), dim=0)
    keep = sel & (running <= offset + n)
    if offset:
        keep = keep & (running > offset)
    return lanes, keep

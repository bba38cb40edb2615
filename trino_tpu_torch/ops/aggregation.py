"""Group-by aggregation on PyTorch tensors.

Counterpart of trino_tpu/ops/aggregation.py, for the subset TPC-H Q1/Q6
reach: the direct (mixed-radix dictionary/boolean key) grouping and the
count / count_if / sum / avg / min / max accumulators, with the exact
decimal(38) chunked sums of ops/wide_decimal.  Segment reductions are
``index_add_`` (sums) and ``scatter_reduce`` (min/max); per-group counts
at small capacities go through the grouped-count kernel
(ops/kernels.seg_count_maybe).  The TPU-only masked one-hot reductions
are gone: CUDA has native atomics.

Not in this slice (NotImplementedError): hash-sort grouping of
high-cardinality keys, DISTINCT aggregates, moments, bitwise, checksum,
arbitrary, min_by/max_by, sketches, host-staged aggregates and the
PARTIAL/FINAL accumulator merge.

NULL semantics: a NULL key is its own group (the validity bit is an
extra radix slot); sum/min/max ignore NULL inputs and return NULL for
empty groups; count counts non-NULL only.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import types as T
from ..expr.lower import Lane
from . import kernels

I64_MAX = 2**62

MOMENT_KINDS = ("var_samp", "var_pop", "stddev_samp", "stddev_pop")
BINARY_MOMENT_KINDS = (
    "covar_pop", "covar_samp", "corr", "regr_slope", "regr_intercept",
)
BITWISE_KINDS = ("bitwise_and_agg", "bitwise_or_agg", "bitwise_xor_agg")
NON_DECOMPOSABLE = ("array_agg", "map_agg", "listagg")
HOST_STAGED_KINDS = ("array_agg", "map_agg", "listagg")
SKETCHED_KINDS = ("approx_distinct", "approx_percentile")
TWO_ARG_KINDS = ("min_by", "max_by") + BINARY_MOMENT_KINDS


def _not_in_slice(what: str):
    return NotImplementedError(f"{what} is not in this slice of the port")


def _sum_overflow_flag(vv: torch.Tensor, gid: torch.Tensor, cap: int):
    """Count of groups whose int64 sum magnitude approaches the wrap
    point (flags the query until wider storage takes over).  A scalar
    sum(|v|) gate first; the per-group float64 shadow runs only when it
    fires."""
    gate = torch.sum(torch.abs(vv).to(torch.float64)) > 9.0e18
    if not bool(gate):
        return torch.zeros((), dtype=torch.int64, device=vv.device)
    shadow = _seg_sum(vv.to(torch.float64), gid, cap)
    return torch.sum(torch.abs(shadow) > 9.0e18).to(torch.int64)


def _sum_could_overflow(nrows: int, input_type) -> bool:
    """Can nrows values of this type exceed int64?"""
    digits = (
        input_type.precision
        if input_type is not None and input_type.is_decimal
        else 19
    )
    return nrows * (10.0 ** digits) > 9.0e18


@dataclasses.dataclass(frozen=True)
class AggSpec:
    """One aggregate function instance (AggregatorFactory analog)."""

    kind: str
    input: Optional[str]  # input column name (None for count_star)
    output: str
    input_type: Optional[T.Type] = None
    output_type: Optional[T.Type] = None
    distinct: bool = False
    input2: Optional[str] = None
    input2_type: Optional[T.Type] = None
    param: Optional[float] = None

    @property
    def _wide_sum(self) -> bool:
        """Wide chunked accumulation: any decimal sum/avg (sum outputs are
        typed decimal(38, s))."""
        from . import wide_decimal as wd

        if self.kind == "sum":
            return wd.is_wide_type(self.output_type)
        if self.kind == "avg":
            return (
                self.input_type is not None
                and self.input_type.is_decimal
                and self.output_type is not None
                and self.output_type.is_decimal
            )
        return False

    @property
    def accumulator_names(self) -> List[str]:
        o = self.output
        if self.kind == "avg":
            if self._wide_sum:
                return [f"{o}$c0", f"{o}$c1", f"{o}$c2", f"{o}$c3",
                        f"{o}$count"]
            return [f"{o}$sum", f"{o}$count"]
        if self.kind == "sum" and self._wide_sum:
            return [f"{o}$c0", f"{o}$c1", f"{o}$c2", f"{o}$c3",
                    f"{o}$valid"]
        if self.kind in ("sum", "min", "max"):
            return [f"{o}$val", f"{o}$valid"]
        if self.kind in ("count", "count_star", "count_if"):
            return [f"{o}$count"]
        raise _not_in_slice(f"aggregate {self.kind}")


def direct_group_ids(
    key_lanes: Sequence[Lane], domains: Sequence[int]
) -> Tuple[torch.Tensor, int]:
    """Mixed-radix dense group id from small-domain keys; each key
    contributes radix (domain+1), slot `domain` encodes NULL."""
    gid = None
    cap = 1
    for (v, ok), dom in zip(key_lanes, domains):
        radix = dom + 1
        code = torch.where(
            ok, torch.clamp(v.to(torch.int64), 0, dom - 1),
            torch.full_like(v, dom, dtype=torch.int64),
        )
        gid = code if gid is None else gid * radix + code
        cap *= radix
    return gid, cap


def _seg_sum(v: torch.Tensor, gid: torch.Tensor, cap: int) -> torch.Tensor:
    out = torch.zeros((cap,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
    return out.index_add_(0, gid, v)


def _seg_count(mask: torch.Tensor, gid: torch.Tensor, cap: int) -> torch.Tensor:
    """Per-group count of a boolean mask: the grouped-count kernel at
    small capacities (ops/kernels), else a segment sum."""
    ps = kernels.seg_count_maybe(mask, gid, cap)
    if ps is not None:
        return ps
    return _seg_sum(mask.to(torch.int64), gid, cap)


def _seg_extreme(v: torch.Tensor, gid: torch.Tensor, cap: int, take_min: bool):
    if v.is_floating_point():
        sent = float("inf") if take_min else float("-inf")
    else:
        info = torch.iinfo(v.dtype)
        sent = info.max if take_min else info.min
    out = torch.full((cap,), sent, dtype=v.dtype, device=v.device)
    return out.scatter_reduce(0, gid, v, "amin" if take_min else "amax")


def _seg_min(v, gid, cap):
    return _seg_extreme(v, gid, cap, True)


def _seg_max(v, gid, cap):
    return _seg_extreme(v, gid, cap, False)


def accumulate(
    specs: Sequence[AggSpec],
    lanes: Dict[str, Lane],
    gid: torch.Tensor,
    sel: torch.Tensor,
    capacity: int,
    step: str = "single",
    overflow_flags: Optional[list] = None,
    wide_flags: Optional[list] = None,
    force_wide: bool = True,
    seg=None,
) -> Dict[str, torch.Tensor]:
    """Accumulator tensors (shape [capacity]) per spec.

    wide_flags/force_wide drive the decimal(38) sum fast path as in the
    JAX package: one int64 segment sum plus a shadow overflow flag, and
    the chunked 128-bit sums when the executor's retry forces them."""
    if seg is not None:
        raise _not_in_slice("sorted-segment grouping")
    out: Dict[str, torch.Tensor] = {}
    cap = capacity
    for s in specs:
        o = s.output
        if getattr(s, "distinct", False):
            raise _not_in_slice(f"{s.kind}(DISTINCT)")
        if s.kind == "count_star":
            out[f"{o}$count"] = _seg_count(sel, gid, cap)
            continue
        v, ok = lanes[s.input]
        live = sel & ok
        if s.kind == "count":
            out[f"{o}$count"] = _seg_count(live, gid, cap)
        elif s.kind == "count_if":
            out[f"{o}$count"] = _seg_count(live & v.to(torch.bool), gid, cap)
        elif s.kind in ("sum", "avg"):
            cnt = _seg_count(live, gid, cap)
            if s._wide_sum:
                from . import wide_decimal as wd

                if wd.is_wide(v) or force_wide:
                    chunks = (
                        wd.wide_row_chunks(v, live)
                        if wd.is_wide(v)
                        else wd.narrow_row_chunks(v, live)
                    )
                    cs = wd.seg_sum_chunks(chunks, gid, cap)
                else:
                    vv = torch.where(live, v.to(torch.int64), 0)
                    ssum = _seg_sum(vv, gid, cap)
                    if wide_flags is not None and _sum_could_overflow(
                        v.shape[0], s.input_type
                    ):
                        wide_flags.append(_sum_overflow_flag(vv, gid, cap))
                    cs = wd.normalize_chunks([
                        ssum & 0xFFFFFFFF, ssum >> 32,
                        torch.zeros_like(ssum), torch.zeros_like(ssum),
                    ])
                for i, c in enumerate(cs):
                    out[f"{o}$c{i}"] = c
                out[f"{o}$valid" if s.kind == "sum" else f"{o}$count"] = cnt
                continue
            if v.is_floating_point():
                vv = torch.where(live, v, 0.0)
            else:
                vv = torch.where(live, v.to(torch.int64), 0)
            ssum = _seg_sum(vv, gid, cap)
            if (
                not v.is_floating_point()
                and overflow_flags is not None
                and _sum_could_overflow(v.shape[0], s.input_type)
            ):
                overflow_flags.append(_sum_overflow_flag(vv, gid, cap))
            if s.kind == "sum":
                out[f"{o}$val"] = ssum
                out[f"{o}$valid"] = cnt
            else:
                out[f"{o}$sum"] = ssum
                out[f"{o}$count"] = cnt
        elif s.kind in ("min", "max"):
            if v.dim() == 2:
                raise _not_in_slice("min/max over wide decimals")
            if v.is_floating_point():
                sentinel = float("inf") if s.kind == "min" else float("-inf")
                vv = torch.where(live, v, sentinel)
            else:
                sentinel = I64_MAX if s.kind == "min" else -I64_MAX
                vv = torch.where(live, v.to(torch.int64), sentinel)
            out[f"{o}$val"] = _seg_extreme(vv, gid, cap, s.kind == "min")
            out[f"{o}$valid"] = _seg_count(live, gid, cap)
        else:
            raise _not_in_slice(f"aggregate {s.kind}")
    return out


def finalize(
    specs: Sequence[AggSpec], accs: Dict[str, torch.Tensor]
) -> Dict[str, Lane]:
    """Accumulators -> output lanes (SINGLE/FINAL output step)."""
    out: Dict[str, Lane] = {}
    for s in specs:
        o = s.output
        if s.kind in ("count", "count_star", "count_if"):
            c = accs[f"{o}$count"]
            out[o] = (c, torch.ones(c.shape, dtype=torch.bool, device=c.device))
        elif s.kind == "sum":
            if s._wide_sum:
                from . import wide_decimal as wd

                cs = wd.normalize_chunks([accs[f"{o}$c{i}"] for i in range(4)])
                out[o] = (wd.chunks_to_wide(cs), accs[f"{o}$valid"] > 0)
                continue
            out[o] = (accs[f"{o}$val"], accs[f"{o}$valid"] > 0)
        elif s.kind in ("min", "max"):
            v = accs[f"{o}$val"]
            has = accs[f"{o}$valid"] > 0
            out[o] = (torch.where(has, v, torch.zeros_like(v)), has)
        elif s.kind == "avg":
            if s._wide_sum:
                from . import wide_decimal as wd

                cs = wd.normalize_chunks([accs[f"{o}$c{i}"] for i in range(4)])
                cnt = accs[f"{o}$count"]
                den = torch.clamp(cnt, min=1)
                ot, it = s.output_type, s.input_type
                num = wd.rescale(wd.chunks_to_wide(cs), ot.scale - it.scale)
                q = wd.div_round(num, den)
                out[o] = (q if wd.is_wide_type(ot) else wd.narrow(q), cnt > 0)
                continue
            ssum = accs[f"{o}$sum"]
            cnt = accs[f"{o}$count"]
            den = torch.clamp(cnt, min=1)
            ot = s.output_type
            if ssum.is_floating_point():
                v = ssum / den
            elif ot is not None and ot.name in ("double", "real"):
                v = ssum.to(torch.float64) / den
            elif ot is not None and ot.is_decimal and s.input_type is not None:
                num = ssum * 10 ** (ot.scale - s.input_type.scale)
                sign = torch.sign(num)
                anum = torch.abs(num)
                q = torch.div(anum, den, rounding_mode="floor")
                rem = anum - q * den
                v = sign * (q + (2 * rem >= den).to(torch.int64))
            else:
                v = torch.div(ssum, den, rounding_mode="floor")
            out[o] = (v, cnt > 0)
        else:
            raise _not_in_slice(f"aggregate {s.kind}")
    return out


def group_keys_output(
    key_lanes: Sequence[Lane],
    gid: torch.Tensor,
    sel: torch.Tensor,
    capacity: int,
) -> List[Lane]:
    """Representative key values per group id (first selected row)."""
    n = gid.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=gid.device)
    first = _seg_min(torch.where(sel, idx, n), gid, capacity)
    present = first < n
    safe = torch.clamp(first, 0, max(n - 1, 0))
    out = []
    for v, ok in key_lanes:
        if n == 0:
            out.append((torch.zeros((capacity,) + tuple(v.shape[1:]), dtype=v.dtype,
                                    device=v.device), present))
            continue
        out.append((v[safe], ok[safe] & present))
    return out

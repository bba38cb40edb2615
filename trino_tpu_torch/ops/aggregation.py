"""Group-by aggregation on PyTorch tensors.

Counterpart of trino_tpu/ops/aggregation.py, for the subset TPC-H
Q1/Q3/Q6 reach: the direct (mixed-radix dictionary/boolean key)
grouping, the hash-sort grouping of high-cardinality keys
(sort_group_ids + SortedSegments) and the count / count_if / sum / avg /
min / max / arbitrary accumulators, with the exact decimal(38) chunked
sums of ops/wide_decimal.  Segment reductions at small capacities go
through the CUDA kernels (counts: ops/kernels.seg_count_maybe; int64
sums: ops/kernels.grouped_sum_i64), the others are ``index_add_`` (sums)
and ``scatter_reduce`` (min/max).  The TPU-only masked one-hot
reductions are gone: CUDA has native atomics.

DISTINCT aggregates (distinct_first_mask / distinct_count): count(DISTINCT)
takes one sort over (liveness, group, value); sum/avg/count_if(DISTINCT)
run their normal accumulators over a first-occurrence mask; DISTINCT is a
no-op for min/max/arbitrary.

Not in this slice (NotImplementedError): moments, bitwise, checksum,
min_by/max_by, sketches, host-staged aggregates and the PARTIAL/FINAL
accumulator merge.

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
from .int128 import SIGN64, as_i64, srl
from .sort import lex_perm

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
        if self.kind in ("sum", "min", "max", "arbitrary"):
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


# uint64 hash constants as the int64 values with the same bits
_GOLDEN = as_i64(0x9E3779B97F4A7C15)
_SALT_C = as_i64(0x632BE59BD9B4E019)
_DBL_MIN = 2.2250738585072014e-308  # smallest normal double


def f64_order_bits(v: torch.Tensor) -> torch.Tensor:
    """The JAX package's order-preserving uint64 code of doubles (held
    in int64): the IEEE-754 bit pattern of |v| (subnormals and -0 as 0,
    one NaN above +inf), sign folded in by the radix-sortable transform.
    The JAX package rebuilds the pattern arithmetically (no f64 bitcast
    on its TPU); here it is a bit view, with the same result."""
    v = v.to(torch.float64)
    av = torch.abs(v)
    bits = av.contiguous().view(torch.int64)
    bits = torch.where(av < _DBL_MIN, 0, bits)
    bits = torch.where(torch.isinf(av), 0x7FF0000000000000, bits)
    bits = torch.where(torch.isnan(v), 0x7FF8000000000000, bits)
    # XLA flushes subnormals in comparisons (both of the JAX package's
    # backends), so a negative subnormal is not negative there
    neg = v <= -_DBL_MIN
    pattern = bits | torch.where(neg, SIGN64, 0)
    return torch.where(neg, ~pattern, pattern | SIGN64)


def _key_bits(v: torch.Tensor) -> torch.Tensor:
    """Key column as uint64 bit material (held in int64): floats get the
    injective order-preserving encoding, integers their two's-complement
    bits."""
    if v.is_floating_point():
        return f64_order_bits(v)
    return v.to(torch.int64)


def _key_bit_lanes(v: torch.Tensor):
    """Key column as one or two uint64 bit-material lanes (wide decimals
    contribute each limb as its own hashing/verification round)."""
    if v.dim() == 2:
        return [v[:, 0].to(torch.int64), v[:, 1].to(torch.int64)]
    return [_key_bits(v)]


def _group_hash(key_lanes: Sequence[Lane], salt: int) -> torch.Tensor:
    """Salted 64-bit key-tuple locator, bit-identical to the JAX
    package's (uint64 arithmetic in int64: multiply/add wrap alike, the
    right shift is logical, mod 2^61 keeps the low 61 bits).  The NULL
    flag is mixed as its own round, so a salt change re-randomizes every
    collision."""
    n = key_lanes[0][0].shape[0]
    dev = key_lanes[0][0].device
    h = torch.full((n,), as_i64((salt * 2 + 1) * 0x9E3779B97F4A7C15),
                   dtype=torch.int64, device=dev)
    for v, ok in key_lanes:
        h = h * _GOLDEN + ok.to(torch.int64) + _SALT_C
        h = h ^ srl(h, 31)
        for bits in _key_bit_lanes(v):
            h = h * _GOLDEN + torch.where(ok, bits, 0)
            h = h ^ srl(h, 29)
    return h & (2**61 - 1)


def sort_group_ids(
    key_lanes: Sequence[Lane],
    sel: torch.Tensor,
    capacity: int,
    salt: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Hash-sort grouping: returns (perm, gid_sorted, ngroups, collisions).

    Rows sort (stably) by one salted 64-bit locator of the key tuple, so
    equal keys are adjacent and unselected rows last; gid_sorted[i] is
    the group id of sorted row i (unselected rows get capacity-1 and are
    excluded by weight later).  Adjacent rows of one hash run are
    verified equal on the real key columns: `collisions` counts the
    mismatches, and the executor re-runs under a fresh salt when it is
    ever nonzero, so grouping is exact."""
    n = key_lanes[0][0].shape[0]
    dev = key_lanes[0][0].device
    hk = _group_hash(key_lanes, salt)
    key = torch.where(sel, hk, 2**61)  # dead rows sort last
    sorted_key, perm = torch.sort(key, stable=True)
    sel_sorted = sorted_key < 2**61
    one = torch.ones(1, dtype=torch.bool, device=dev)
    diff = torch.cat([one, sorted_key[1:] != sorted_key[:-1]])[:n]
    boundary = diff & sel_sorted
    # exact adjacent verification (PagesHashStrategy positionEquals analog)
    prev = torch.cat([perm[:1], perm[:-1]])
    same_run = (~diff) & sel_sorted
    all_eq = torch.ones(n, dtype=torch.bool, device=dev)
    for v, ok in key_lanes:
        okp, okq = ok[perm], ok[prev]
        vals_eq = torch.ones(n, dtype=torch.bool, device=dev)
        for bits in _key_bit_lanes(v):
            vals_eq = vals_eq & (bits[perm] == bits[prev])
        lane_eq = (okp == okq) & (~okp | vals_eq)
        all_eq = all_eq & lane_eq
    collisions = torch.sum(same_run & ~all_eq)
    gid = torch.cumsum(boundary.to(torch.int64), 0) - 1
    ngroups = boundary.sum()
    gid = torch.where(sel_sorted, torch.clamp(gid, 0, capacity - 1), capacity - 1)
    return perm, gid, ngroups, collisions


def distinct_first_mask(
    gid: torch.Tensor, lane: Lane, live: torch.Tensor
) -> torch.Tensor:
    """First-occurrence mask per (group, value) over live rows, in the
    caller's row order (MarkDistinctOperator analog): one sort by
    (liveness, gid, value bits), adjacent-first flags, and a scatter back
    through the permutation.  An aggregate then runs its normal
    accumulator over `live & mask`."""
    v, _ok = lane
    n = gid.shape[0]
    bit_lanes = list(_key_bit_lanes(v))
    dead = torch.logical_not(live)
    perm = lex_perm([dead, gid] + bit_lanes)
    g2 = gid[perm]
    neq = g2[1:] != g2[:-1]
    for b in bit_lanes:
        b2 = b[perm]
        neq = neq | (b2[1:] != b2[:-1])
    one = torch.ones(1, dtype=torch.bool, device=gid.device)
    first = torch.cat([one, neq])[:n] & torch.logical_not(dead[perm])
    out = torch.zeros(n, dtype=torch.bool, device=gid.device)
    out[perm] = first
    return out


# DISTINCT is semantically a no-op for these kinds (duplicates cannot
# change an extremum / boolean fold / arbitrary pick)
_DISTINCT_NOOP = ("min", "max", "bool_and", "bool_or", "arbitrary",
                  "approx_distinct")
# kinds whose accumulators correctly consume a dedup-refined live mask
_DISTINCT_MASKED = ("sum", "avg", "count_if", "geometric_mean") + MOMENT_KINDS


def distinct_count(
    gid: torch.Tensor, lane: Lane, sel: torch.Tensor, capacity: int
) -> torch.Tensor:
    """count(DISTINCT x) per group: sort by (liveness, gid, x), count the
    live first occurrences (MarkDistinctOperator + count, in one sort)."""
    v, ok = lane
    live = sel & ok
    n = gid.shape[0]
    vv = v if v.is_floating_point() else v.to(torch.int64)
    dead = torch.logical_not(live)
    perm = lex_perm([dead, gid, vv])
    g2, v2 = gid[perm], vv[perm]
    one = torch.ones(1, dtype=torch.bool, device=gid.device)
    first = torch.cat([one, (g2[1:] != g2[:-1]) | (v2[1:] != v2[:-1])])[:n]
    flags = (first & live[perm]).to(torch.int64)
    out = torch.zeros(capacity, dtype=torch.int64, device=gid.device)
    return out.index_add_(0, torch.clamp(g2, 0, capacity - 1), flags)


class SortedSegments:
    """Grouped reductions over a SORTED gid lane (the hash-sort grouping
    path: rows arrive permuted so equal groups are adjacent, gid
    non-decreasing): each group's [start, end) row range from two ranks
    of arange(cap) among the gids, then sums and counts as differences
    of one prefix sum, and min/max as the extreme of the run that ends at
    the group's last row, as the JAX package's segmented scan reads it."""

    def __init__(self, gid: torch.Tensor, cap: int):
        from .join import merge_rank

        self.gid = gid
        self.cap = cap
        self.n = gid.shape[0]
        probe = torch.arange(cap, dtype=torch.int64, device=gid.device)
        self.starts = merge_rank(gid, probe, side="left")
        self.ends = merge_rank(gid, probe, side="right")
        self.counts_all = self.ends - self.starts  # incl. non-live rows

    def _range_diff(self, cs: torch.Tensor) -> torch.Tensor:
        """cs = inclusive prefix over rows -> per-group range totals."""
        cs0 = torch.cat([torch.zeros(1, dtype=cs.dtype, device=cs.device), cs])
        return cs0[self.ends] - cs0[self.starts]

    def sum(self, v: torch.Tensor) -> torch.Tensor:
        return self._range_diff(torch.cumsum(v, 0))

    def count(self, mask: torch.Tensor) -> torch.Tensor:
        return self._range_diff(torch.cumsum(mask.to(torch.int64), 0))

    def _scan_extreme(self, v: torch.Tensor, take_min: bool) -> torch.Tensor:
        """The JAX package's segmented running extreme read at each
        group's last row ends-1 (clipped to row 0: an empty group reads
        the previous run's extreme, or row 0 itself when none precedes
        it).  The running extreme at a run's last row is the run's
        extreme, so one scatter over run ids gives it."""
        if self.n == 0:
            return torch.zeros(self.cap, dtype=v.dtype, device=v.device)
        g = self.gid
        one = torch.ones(1, dtype=torch.bool, device=g.device)
        boundary = torch.cat([one, g[1:] != g[:-1]])
        run = torch.cumsum(boundary.to(torch.int64), 0) - 1
        nruns = int(run[-1]) + 1
        if v.is_floating_point():
            sent = float("inf") if take_min else float("-inf")
        else:
            info = torch.iinfo(v.dtype)
            sent = info.max if take_min else info.min
        ext = torch.full((nruns,), sent, dtype=v.dtype, device=v.device)
        ext = ext.scatter_reduce(0, run, v, "amin" if take_min else "amax")
        last = self.ends - 1
        safe = torch.clamp(last, 0, self.n - 1)
        return torch.where(last >= 0, ext[run[safe]], v[0])

    def min(self, v: torch.Tensor) -> torch.Tensor:
        return self._scan_extreme(v, True)

    def max(self, v: torch.Tensor) -> torch.Tensor:
        return self._scan_extreme(v, False)


def _seg_sum(v: torch.Tensor, gid: torch.Tensor, cap: int) -> torch.Tensor:
    """Per-group sum: the grouped int64 sum kernel for 1-D int64 values
    at small capacities (ops/kernels), else a segment sum."""
    if v.dtype == torch.int64 and v.dim() == 1 and cap <= kernels.MAX_GROUPS:
        return kernels.grouped_sum_i64(v, gid.to(torch.int64), cap)
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


def _seg_minmax_wide(v, live, gid, cap, take_min: bool):
    """Lexicographic segment min/max of a wide (two-limb) decimal lane:
    extreme high limb first, then the extreme unsigned low limb among
    rows whose high limb attains it (two exact segment passes).  The
    sentinels are the true int64 extremes: limbs span the full 64-bit
    domain."""
    from . import wide_decimal as wd

    lo, hi = wd.limbs(v)
    lo_u = lo ^ SIGN64  # unsigned order, signed domain
    sent = 2**63 - 1 if take_min else -(2**63)
    hi_ext = _seg_extreme(torch.where(live, hi, sent), gid, cap, take_min)
    on_ext = live & (hi == hi_ext[gid])
    lo_ext = _seg_extreme(torch.where(on_ext, lo_u, sent), gid, cap, take_min)
    return wd.make_wide(lo_ext ^ SIGN64, hi_ext)


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
    the chunked 128-bit sums when the executor's retry forces them.
    With `seg` (SortedSegments over a sorted gid) integer sums, counts
    and min/max run as sorted-run reductions, as in the JAX package."""
    out: Dict[str, torch.Tensor] = {}
    cap = capacity

    def seg_cnt(mask):
        if seg is not None:
            return seg.count(mask)
        return _seg_count(mask, gid, cap)

    def seg_isum(vv):
        if seg is not None and not vv.is_floating_point():
            return seg.sum(vv)
        return _seg_sum(vv, gid, cap)

    def seg_ext(vv, take_min):
        if seg is not None and not vv.is_floating_point():
            return seg.min(vv) if take_min else seg.max(vv)
        return _seg_extreme(vv, gid, cap, take_min)

    # one dedup mask per DISTINCT input column, shared across specs
    # (sum(DISTINCT x) + avg(DISTINCT x) sort once, not twice)
    distinct_masks: Dict[str, torch.Tensor] = {}
    for s in specs:
        o = s.output
        if s.distinct and s.kind == "count":
            # count(DISTINCT x): the one-sort path
            out[f"{o}$count"] = distinct_count(gid, lanes[s.input], sel, cap)
            continue
        if s.kind == "count_star":
            out[f"{o}$count"] = seg_cnt(sel)
            continue
        v, ok = lanes[s.input]
        live = sel & ok
        if s.distinct and s.kind not in _DISTINCT_NOOP:
            if s.kind not in _DISTINCT_MASKED:
                raise NotImplementedError(f"{s.kind}(DISTINCT) not supported")
            if step != "single":
                raise NotImplementedError(
                    "DISTINCT aggregates are non-decomposable: the "
                    "planner must not split them PARTIAL/FINAL"
                )
            m = distinct_masks.get(s.input)
            if m is None:
                m = distinct_masks[s.input] = distinct_first_mask(
                    gid, (v, ok), live
                )
            live = live & m
        if s.kind == "count":
            out[f"{o}$count"] = seg_cnt(live)
        elif s.kind == "count_if":
            out[f"{o}$count"] = seg_cnt(live & v.to(torch.bool))
        elif s.kind in ("sum", "avg"):
            cnt = seg_cnt(live)
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
                    ssum = seg_isum(vv)
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
            ssum = seg_isum(vv)
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
                out[f"{o}$val"] = _seg_minmax_wide(
                    v, live, gid, cap, s.kind == "min"
                )
                out[f"{o}$valid"] = _seg_count(live, gid, cap)
                continue
            if v.is_floating_point():
                sentinel = float("inf") if s.kind == "min" else float("-inf")
                vv = torch.where(live, v, sentinel)
            else:
                sentinel = I64_MAX if s.kind == "min" else -I64_MAX
                vv = torch.where(live, v.to(torch.int64), sentinel)
            out[f"{o}$val"] = seg_ext(vv, s.kind == "min")
            out[f"{o}$valid"] = seg_cnt(live)
        elif s.kind == "arbitrary":
            # the first live row of each group, in the caller's row order
            n = gid.shape[0]
            idx = torch.arange(n, dtype=torch.int64, device=gid.device)
            ridx = _seg_min(torch.where(live, idx, n), gid, cap)
            has = ridx < n
            safe = torch.clamp(ridx, 0, max(n - 1, 0))
            val = v[safe] if n else torch.zeros((cap,) + tuple(v.shape[1:]),
                                                dtype=v.dtype, device=v.device)
            out[f"{o}$val"] = torch.where(
                has.reshape((cap,) + (1,) * (val.dim() - 1)), val,
                torch.zeros_like(val))
            out[f"{o}$valid"] = has.to(torch.int64)
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
            sel_has = has[:, None] if v.dim() == 2 else has
            out[o] = (torch.where(sel_has, v, torch.zeros_like(v)), has)
        elif s.kind == "arbitrary":
            out[o] = (accs[f"{o}$val"], accs[f"{o}$valid"] > 0)
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
    starts: Optional[torch.Tensor] = None,
) -> List[Lane]:
    """Representative key values per group id (first selected row).
    With `starts` (sorted-gid run starts from SortedSegments), the
    representative is the run-head row — no segment pass."""
    n = gid.shape[0]
    if starts is not None:
        present = starts < n
        safe = torch.clamp(starts, 0, max(n - 1, 0))
        return [(v[safe], ok[safe] & present & sel[safe]) for v, ok in key_lanes]
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

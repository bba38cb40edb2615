"""Group-by aggregation on PyTorch tensors.

Counterpart of trino_tpu/ops/aggregation.py, for the subset TPC-H
Q1/Q3/Q6 reach: the direct (mixed-radix dictionary/boolean key)
grouping, the hash-sort grouping of high-cardinality keys
(sort_group_ids + SortedSegments) and the count / count_if / sum / avg /
min / max / arbitrary accumulators, with the exact decimal(38) chunked
sums of ops/wide_decimal.  Segment reductions at small capacities go
through the CUDA kernels (counts: ops/kernels.seg_count_maybe; int64
sums: ops/kernels.grouped_sum_i64), the others are ``index_add_``,
sorted-run prefix sums (_GroupOrder: float64 sums in an order the rows
fix, and integer sums beyond 32 groups) and ``scatter_reduce``
(min/max).  The TPU-only masked one-hot
reductions are gone: CUDA has native atomics.

DISTINCT aggregates (distinct_first_mask / distinct_count): count(DISTINCT)
takes one sort over (liveness, group, value); sum/avg/count_if(DISTINCT)
run their normal accumulators over a first-occurrence mask; DISTINCT is a
no-op for min/max/arbitrary.

The other families follow the JAX package at the SINGLE step: the
moments (var/stddev, covar/corr/regr) and geometric_mean as float64
segment sums, bool_and/bool_or, the bitwise aggregates from per-bit
group counts (one bit plane at a time, never an [n, 64] matrix),
checksum as the wrapping sum of splitmix64 hashes, min_by/max_by as a
two-pass argmin, and approx_distinct / approx_percentile exact (one
sort each) at the SINGLE step.

PARTIAL, INTERMEDIATE and FINAL follow the JAX package's accumulator
layout column for column (AggSpec.accumulator_names, the plan's
AggInfo.accumulator_schema): accumulate(step="partial") emits the
states, merge_accumulators merges shipped states and finalize reads
either form.  approx_distinct and approx_percentile ship mergeable
sketches at those steps (ops/sketches.py: HLL registers, k-min-hash
samples).  Merges of float64 states run in group order (_GroupOrder),
so a streamed or spilled query repeats bit for bit on the card.

array_agg, map_agg and listagg are host-staged (host_staged_lanes, the
executor's call): the selected rows go into group order on the device,
one copy of the lanes reaches the host, and each group's value becomes
an entry of a fresh dictionary; accumulate refuses them, as the JAX
package's traced kernels do, and they never split PARTIAL/FINAL.

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
SKETCHED_KINDS = ("approx_distinct", "approx_percentile")
NON_DECOMPOSABLE = ("array_agg", "map_agg", "listagg")
HOST_STAGED_KINDS = ("array_agg", "map_agg", "listagg")
TWO_ARG_KINDS = ("min_by", "max_by") + BINARY_MOMENT_KINDS


def _not_in_slice(what: str):
    return NotImplementedError(f"{what} is not in this slice of the port")


def _host_staged(kind: str):
    return NotImplementedError(
        f"{kind} is host-staged (host_staged_lanes, at the SINGLE step)"
        " and cannot run inside a PARTIAL/FINAL step (mesh path)"
    )


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
        if self.kind in ("sum", "min", "max", "arbitrary", "bool_and",
                         "bool_or", "checksum") or self.kind in BITWISE_KINDS:
            return [f"{o}$val", f"{o}$valid"]
        if self.kind in MOMENT_KINDS:
            return [f"{o}$sum", f"{o}$sumsq", f"{o}$count"]
        if self.kind == "geometric_mean":
            return [f"{o}$sumlog", f"{o}$count"]
        if self.kind in BINARY_MOMENT_KINDS:
            return [f"{o}$sy", f"{o}$sx", f"{o}$sxy", f"{o}$sxx",
                    f"{o}$syy", f"{o}$n"]
        if self.kind in ("min_by", "max_by"):
            return [f"{o}$val", f"{o}$key", f"{o}$valid", f"{o}$has"]
        if self.kind == "approx_distinct":
            from . import sketches

            return [f"{o}$hll{i}" for i in range(sketches.HLL_LANES)]
        if self.kind == "approx_percentile":
            from . import sketches

            K = sketches.KMV_K
            return ([f"{o}$pv{i}" for i in range(K)]
                    + [f"{o}$ph{i}" for i in range(K)]
                    + [f"{o}$pmin", f"{o}$pmax"])
        if self.kind in HOST_STAGED_KINDS:
            return [f"{o}$val", f"{o}$valid"]  # host-staged; not shipped
        if self.kind in ("count", "count_star", "count_if"):
            return [f"{o}$count"]
        raise _not_in_slice(f"aggregate {self.kind}")

    def psum_kind(self, name: str) -> Optional[str]:
        """How the mesh merges this accumulator across shards with one
        collective: 'sum' | 'min' | 'max', or None when no collective can
        (the mesh then gathers the partial states and merges them)."""
        if self.kind in ("min", "max") and name.endswith("$val"):
            from . import wide_decimal as wd

            if wd.is_wide_type(self.output_type):
                # per-limb min/max is not the 128-bit min/max
                return None
            return self.kind
        if self.kind == "bool_and" and name.endswith("$val"):
            return "min"
        if self.kind == "bool_or" and name.endswith("$val"):
            return "max"
        if self.kind in ("arbitrary", "min_by", "max_by") or (
            self.kind in BITWISE_KINDS
        ):
            if not (name.endswith("$valid") or name.endswith("$has")
                    or name.endswith("$count")):
                return None
        if self.kind in SKETCHED_KINDS:
            # packed registers and sample slots merge by unpacking
            return None
        return "sum"


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


_MIX1 = as_i64(0xBF58476D1CE4E5B9)
_MIX2 = as_i64(0x94D049BB133111EB)


def _splitmix64(v: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer of each value's 64-bit pattern, the JAX
    package's order-independent per-value hash behind checksum.  uint64
    arithmetic in int64: add and multiply wrap alike, the right shifts
    are logical (srl)."""
    z = v.to(torch.int64) + _GOLDEN
    z = (z ^ srl(z, 30)) * _MIX1
    z = (z ^ srl(z, 27)) * _MIX2
    return z ^ srl(z, 31)


def _bit_counts(v, live, gid, cap, order=None):
    """The 64 per-group counts of live rows with bit b set, b = 0..63.
    Without `order`, one bit plane at a time through _seg_count.  With
    a _GroupOrder, the lane is put in group order once and bits b and
    b + 32 share one int64 prefix sum (a group's count of either stays
    below 2^32, so the low half never carries into the high one)."""
    if order is None:
        # arithmetic shift then & 1 reads bit b of negatives too
        return [_seg_count(live & (((v >> b) & 1) == 1), gid, cap)
                for b in range(64)]
    vs, ls = order.take(v), order.take(live)
    segs = order.segments()
    lo_counts, hi_counts = [], []
    for b in range(32):
        packed = ((vs >> b) & 1) | (((vs >> (b + 32)) & 1) << 32)
        c = segs.sum(torch.where(ls, packed, 0))
        lo_counts.append(c & 0xFFFFFFFF)
        hi_counts.append(c >> 32)
    return lo_counts + hi_counts


def _segment_bitwise(vals, live, gid, cap, op: str, live_cnt=None, order=None):
    """Per-group bitwise and/or/xor from per-bit group counts: bit b of
    the result is (count == live rows) for AND, (count > 0) for OR and
    (count odd) for XOR.  The JAX package counts all 64 bits at once
    through an [n, 64] int32 matrix; here the counts come a bit plane or
    two at a time (_bit_counts), so memory stays at one lane (28.8 M
    rows would need 7.4 GB as a matrix)."""
    v = vals.to(torch.int64)
    if live_cnt is None:
        live_cnt = _seg_count(live, gid, cap)
    live_cnt = live_cnt.to(torch.int64)
    out = torch.zeros(cap, dtype=torch.int64, device=v.device)
    for b, cnt in enumerate(_bit_counts(v, live, gid, cap, order)):
        if op == "or":
            bit = cnt > 0
        elif op == "and":
            bit = (cnt == live_cnt) & (live_cnt > 0)
        else:  # xor
            bit = (cnt & 1) == 1
        out = out | (bit.to(torch.int64) << b)
    return out


def _first_by_key(xlane, key, live, gid, cap, take_min: bool):
    """Per-group x at the row of the group's min/max key (min_by /
    max_by): the key's segment extreme, then the first row whose key
    equals it, then a gather of x there.  Returns (x, key extreme,
    x valid, group has a keyed row)."""
    x, xok = xlane
    n = gid.shape[0]
    if key.is_floating_point():
        sentinel = float("inf") if take_min else float("-inf")
        kv = torch.where(live, key, sentinel)
    else:
        sentinel = I64_MAX if take_min else -I64_MAX
        kv = torch.where(live, key.to(torch.int64), sentinel)
    extremum = _seg_extreme(kv, gid, cap, take_min)
    cand = live & (kv == extremum[gid])
    idx = torch.arange(n, dtype=torch.int64, device=gid.device)
    ridx = _seg_min(torch.where(cand, idx, n), gid, cap)
    has = ridx < n
    safe = torch.clamp(ridx, 0, max(n - 1, 0))
    if n == 0:
        xv = torch.zeros((cap,) + tuple(x.shape[1:]), dtype=x.dtype,
                         device=x.device)
        xvalid = torch.zeros(cap, dtype=torch.bool, device=x.device)
    else:
        xv = x[safe]
        xvalid = xok[safe] & has
    hx = has.reshape((cap,) + (1,) * (xv.dim() - 1))
    return (
        torch.where(hx, xv, torch.zeros_like(xv)),
        torch.where(has, extremum, torch.zeros_like(extremum)),
        xvalid,
        has,
    )


def _percentile(lane: Lane, sel, gid, cap, frac: float):
    """Exact per-group percentile by one sort over (dead, gid, value):
    the value at rank floor(frac * (count - 1) + 0.5) of each group's
    live rows (approx_percentile at the SINGLE step)."""
    v, ok = lane
    live = sel & ok
    n = gid.shape[0]
    vv = v if v.is_floating_point() else v.to(torch.int64)
    perm = lex_perm([torch.logical_not(live), gid, vv])
    live2, g2, v2 = live[perm], gid[perm], vv[perm]
    g2c = torch.clamp(g2, 0, cap - 1)
    cnt = _seg_sum(live2.to(torch.int64), g2c, cap)
    # live rows come first, grouped by gid: group g starts after the
    # live rows of the groups below it
    start = torch.cumsum(cnt, 0) - cnt
    rank = torch.arange(n, dtype=torch.int64, device=gid.device) - start[g2c]
    target = torch.floor(
        frac * (cnt - 1).to(torch.float64) + 0.5
    ).to(torch.int64)
    target = torch.minimum(torch.clamp(target, min=0),
                           torch.clamp(cnt - 1, min=0))
    pick = live2 & (rank == target[g2c])
    if v2.is_floating_point():
        out = _seg_max(torch.where(pick, v2, float("-inf")), g2c, cap)
        out = torch.where(cnt > 0, out, 0.0)
    else:
        out = _seg_max(torch.where(pick, v2, -I64_MAX), g2c, cap)
        out = torch.where(cnt > 0, out, 0).to(v.dtype)
    return out, cnt > 0


def _as_double(v: torch.Tensor, t: Optional[T.Type]) -> torch.Tensor:
    """Numeric lane -> float64, unscaling fixed-point decimals."""
    if t is None:
        return v.to(torch.float64)
    from ..expr.functions import to_double

    return to_double(v, t)


class _GroupOrder:
    """Rows in group order, for the reductions that atomics make
    order-dependent or slow on the card: float64 sums in an order the
    rows fix (one segmented reduction per group, the same bits on every
    run, where `index_add_`'s atomics give a different last bit from run
    to run and cancellation can magnify it), and integer sums over more
    groups than the grouped kernels take as SortedSegments prefix-sum
    differences (an `index_add_` into a few dozen slots serializes on
    their atomics).  The order is the caller's sorted gid (`seg`), or
    one stable sort of the gid, made on first use and shared by every
    aggregate of the call."""

    def __init__(self, gid: torch.Tensor, cap: int, seg=None):
        self.gid, self.cap, self.seg = gid, cap, seg
        self.perm = None

    def segments(self) -> "SortedSegments":
        if self.seg is None:
            self.perm = torch.argsort(self.gid, stable=True)
            self.seg = SortedSegments(self.gid[self.perm], self.cap)
        return self.seg

    def take(self, x: torch.Tensor) -> torch.Tensor:
        self.segments()
        return x if self.perm is None else x[self.perm]

    def fsum(self, x: torch.Tensor) -> torch.Tensor:
        """Per-group float sums, the rows of a group in their order (on
        the CPU the JAX package's sequential scatter-add order).  One
        group on the card is one tree reduction: a segmented reduction
        gives each segment one thread block."""
        if self.cap == 1 and x.is_cuda:
            return x.sum(0, keepdim=True)
        return torch.segment_reduce(self.take(x), "sum",
                                    lengths=self.segments().counts_all,
                                    unsafe=True, initial=0.0)

    def isum(self, x: torch.Tensor) -> torch.Tensor:
        """Per-group exact integer sums (a bool lane counts)."""
        return self.segments().sum(self.take(x).to(torch.int64))


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
    and min/max run as sorted-run reductions, as in the JAX package.
    Float64 sums, and integer sums beyond the grouped kernels' 32 groups,
    run in group order (_GroupOrder): the same bits on every run of the
    card, and on the CPU the JAX package's."""
    out: Dict[str, torch.Tensor] = {}
    cap = capacity
    order = _GroupOrder(gid, cap, seg)
    many = cap > kernels.MAX_GROUPS  # beyond the grouped kernels

    def seg_cnt(mask):
        if seg is not None:
            return seg.count(mask)
        if many:
            return order.isum(mask)
        return _seg_count(mask, gid, cap)

    def seg_isum(vv):
        if vv.is_floating_point():
            return order.fsum(vv)
        if seg is not None:
            return seg.sum(vv)
        if many and vv.dim() == 1:
            return order.isum(vv)
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
        elif s.kind == "approx_distinct":
            if step == "single":
                out[f"{o}$count"] = distinct_count(gid, (v, ok), sel, cap)
            else:
                from . import sketches

                packed = sketches.hll_accumulate(_key_bits(v), live, gid, cap)
                for i, arr in packed.items():
                    out[f"{o}$hll{i}"] = arr
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
        elif s.kind in MOMENT_KINDS:
            x = torch.where(live, _as_double(v, s.input_type), 0.0)
            out[f"{o}$sum"] = order.fsum(x)
            out[f"{o}$sumsq"] = order.fsum(x * x)
            out[f"{o}$count"] = seg_isum(live.to(torch.int64))
        elif s.kind == "geometric_mean":
            x = _as_double(v, s.input_type)
            lx = torch.where(live & (x > 0),
                             torch.log(torch.clamp(x, min=1e-300)), 0.0)
            out[f"{o}$sumlog"] = order.fsum(lx)
            out[f"{o}$count"] = seg_cnt(live)
        elif s.kind in BINARY_MOMENT_KINDS:
            y, yok = v, ok
            x, xok = lanes[s.input2]
            both = sel & yok & xok
            xf = torch.where(both, _as_double(x, s.input2_type), 0.0)
            yf = torch.where(both, _as_double(y, s.input_type), 0.0)
            out[f"{o}$sy"] = order.fsum(yf)
            out[f"{o}$sx"] = order.fsum(xf)
            out[f"{o}$sxy"] = order.fsum(xf * yf)
            out[f"{o}$sxx"] = order.fsum(xf * xf)
            out[f"{o}$syy"] = order.fsum(yf * yf)
            out[f"{o}$n"] = seg_cnt(both)
        elif s.kind in ("bool_and", "bool_or"):
            cnt = seg_cnt(live)
            if s.kind == "bool_and":
                out[f"{o}$val"] = _seg_min(
                    torch.where(live, v.to(torch.int64), 1), gid, cap)
            else:
                out[f"{o}$val"] = _seg_max(
                    torch.where(live, v.to(torch.int64), 0), gid, cap)
            out[f"{o}$valid"] = cnt
        elif s.kind in BITWISE_KINDS:
            op = s.kind.split("_")[1]  # and | or | xor
            cnt = seg_cnt(live)
            out[f"{o}$val"] = _segment_bitwise(
                v, live, gid, cap, op, cnt,
                order=order if many or seg is not None else None)
            out[f"{o}$valid"] = cnt
        elif s.kind == "checksum":
            # a NULL input hashes to a fixed constant, as in the JAX package
            addend = torch.where(ok, _splitmix64(v), 0x6E676C6C7561)
            out[f"{o}$val"] = seg_isum(torch.where(sel, addend, 0))
            out[f"{o}$valid"] = seg_cnt(sel)
        elif s.kind in ("min_by", "max_by"):
            key, kok = lanes[s.input2]
            xv, kv, xvalid, has = _first_by_key(
                (v, ok), key, sel & kok, gid, cap, s.kind == "min_by"
            )
            out[f"{o}$val"] = xv
            out[f"{o}$key"] = kv
            out[f"{o}$valid"] = xvalid.to(torch.int64)
            out[f"{o}$has"] = has.to(torch.int64)
        elif s.kind == "approx_percentile" and step == "single":
            val, valid = _percentile((v, ok), sel, gid, cap, float(s.param))
            out[f"{o}$val"] = val
            out[f"{o}$valid"] = valid.to(torch.int64)
        elif s.kind == "approx_percentile":
            from . import sketches

            K = sketches.KMV_K
            vals, hs = sketches.kmv_accumulate(v, live, gid, cap)
            vals2, hs2 = vals.reshape(cap, K), hs.reshape(cap, K)
            for i in range(K):
                out[f"{o}$pv{i}"] = vals2[:, i]
                out[f"{o}$ph{i}"] = hs2[:, i]
            if v.is_floating_point():
                lo = torch.where(live, v, float("inf"))
                hi = torch.where(live, v, float("-inf"))
            else:
                lo = torch.where(live, v.to(torch.int64), I64_MAX)
                hi = torch.where(live, v.to(torch.int64), -I64_MAX)
            out[f"{o}$pmin"] = _seg_min(lo, gid, cap)
            out[f"{o}$pmax"] = _seg_max(hi, gid, cap)
        elif s.kind in HOST_STAGED_KINDS:
            raise _host_staged(s.kind)
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
        if s.kind == "approx_distinct" and f"{o}$count" not in accs:
            # sketched (PARTIAL/FINAL) form: the HLL estimator
            from . import sketches

            lanes = {i: accs[f"{o}$hll{i}"] for i in range(sketches.HLL_LANES)}
            c = sketches.hll_cardinality(lanes, lanes[0].shape[0])
            out[o] = (c, torch.ones(c.shape, dtype=torch.bool, device=c.device))
        elif s.kind == "approx_percentile" and f"{o}$val" not in accs:
            from . import sketches

            K = sketches.KMV_K
            lo, hi = accs[f"{o}$pmin"], accs[f"{o}$pmax"]
            vals = torch.stack([accs[f"{o}$pv{i}"] for i in range(K)], 1)
            hs = torch.stack([accs[f"{o}$ph{i}"] for i in range(K)], 1)
            q = float(s.param)
            v, has = sketches.kmv_quantile(
                vals.reshape(-1), hs.reshape(-1), lo.shape[0], q)
            # p = 0 and p = 1 are exact; estimates clamp into the range
            if q <= 0.0:
                v = lo
            elif q >= 1.0:
                v = hi
            else:
                v = torch.clamp(v.to(lo.dtype), lo, hi)
            out[o] = (v, has)
        elif s.kind in ("count", "count_star", "count_if", "approx_distinct"):
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
        elif s.kind in ("arbitrary", "approx_percentile", "checksum", "min_by",
                        "max_by") or s.kind in BITWISE_KINDS:
            out[o] = (accs[f"{o}$val"], accs[f"{o}$valid"] > 0)
        elif s.kind in ("bool_and", "bool_or"):
            out[o] = (accs[f"{o}$val"].to(torch.bool), accs[f"{o}$valid"] > 0)
        elif s.kind in MOMENT_KINDS:
            sm = accs[f"{o}$sum"]
            sq = accs[f"{o}$sumsq"]
            cnt = accs[f"{o}$count"]
            n = torch.clamp(cnt, min=1).to(torch.float64)
            m2 = torch.clamp(sq - sm * sm / n, min=0.0)
            if s.kind in ("var_pop", "stddev_pop"):
                var, valid = m2 / n, cnt > 0
            else:
                var, valid = m2 / torch.clamp(n - 1, min=1.0), cnt > 1
            v = torch.sqrt(var) if s.kind.startswith("stddev") else var
            out[o] = (v, valid)
        elif s.kind == "geometric_mean":
            cnt = accs[f"{o}$count"]
            n = torch.clamp(cnt, min=1).to(torch.float64)
            out[o] = (torch.exp(accs[f"{o}$sumlog"] / n), cnt > 0)
        elif s.kind in BINARY_MOMENT_KINDS:
            sy, sx = accs[f"{o}$sy"], accs[f"{o}$sx"]
            sxy, sxx, syy = accs[f"{o}$sxy"], accs[f"{o}$sxx"], accs[f"{o}$syy"]
            cnt = accs[f"{o}$n"]
            n = torch.clamp(cnt, min=1).to(torch.float64)
            cxy = sxy - sx * sy / n
            cxx = torch.clamp(sxx - sx * sx / n, min=0.0)
            cyy = torch.clamp(syy - sy * sy / n, min=0.0)
            if s.kind == "covar_pop":
                v, valid = cxy / n, cnt > 0
            elif s.kind == "covar_samp":
                v, valid = cxy / torch.clamp(n - 1, min=1.0), cnt > 1
            elif s.kind == "corr":
                den = torch.sqrt(cxx * cyy)
                v = torch.where(den > 0, cxy / torch.clamp(den, min=1e-300), 0.0)
                valid = (cnt > 0) & (den > 0)
            else:
                slope = torch.where(
                    cxx > 0, cxy / torch.clamp(cxx, min=1e-300), 0.0)
                v = slope if s.kind == "regr_slope" else (sy - slope * sx) / n
                valid = (cnt > 0) & (cxx > 0)
            out[o] = (v, valid)
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


def merge_accumulators(
    specs: Sequence[AggSpec],
    acc_lanes: Dict[str, Lane],
    gid: torch.Tensor,
    sel: torch.Tensor,
    capacity: int,
    overflow_flags: Optional[list] = None,
) -> Dict[str, torch.Tensor]:
    """FINAL / INTERMEDIATE step: merge shipped accumulator rows grouped
    by gid (the JAX package's merge, state for state).  Float64 states
    sum in group order (_GroupOrder: the rows of a group in their order,
    which is tile order for streamed partials), integer states beyond
    the grouped kernels' 32 groups as sorted-run sums."""
    out: Dict[str, torch.Tensor] = {}
    cap = capacity
    w = sel
    order = _GroupOrder(gid, cap)
    many = cap > kernels.MAX_GROUPS

    def gsum(vv):
        if vv.is_floating_point():
            return order.fsum(vv)
        if many:
            return order.isum(vv)
        return _seg_sum(vv.to(torch.int64), gid, cap)

    def msum(name):
        v, _ = acc_lanes[name]
        out[name] = gsum(torch.where(w, v, 0.0 if v.is_floating_point() else 0))

    def overflow_check(name):
        vals = acc_lanes[name][0]
        if overflow_flags is not None and not vals.is_floating_point():
            overflow_flags.append(
                _sum_overflow_flag(torch.where(w, vals, 0), gid, cap))

    def valid_sum(o):
        cv, _ = acc_lanes[f"{o}$valid"]
        out[f"{o}$valid"] = gsum(torch.where(w, cv, 0))
        return w & (cv > 0)

    for s in specs:
        o = s.output
        if s.kind == "approx_distinct":
            from . import sketches

            packed = sketches.hll_merge(
                {i: acc_lanes[f"{o}$hll{i}"][0] for i in range(sketches.HLL_LANES)},
                w, gid, cap)
            for i, arr in packed.items():
                out[f"{o}$hll{i}"] = arr
        elif s.kind == "approx_percentile":
            from . import sketches

            K = sketches.KMV_K
            vals = torch.stack([acc_lanes[f"{o}$pv{i}"][0] for i in range(K)], 1)
            hs = torch.stack([acc_lanes[f"{o}$ph{i}"][0] for i in range(K)], 1)
            hs = torch.where(w[:, None], hs, sketches._H_EMPTY)
            mv, mh = sketches.kmv_merge(vals, hs, w, gid, cap)
            mv2, mh2 = mv.reshape(cap, K), mh.reshape(cap, K)
            for i in range(K):
                out[f"{o}$pv{i}"] = mv2[:, i]
                out[f"{o}$ph{i}"] = mh2[:, i]
            lo, _ = acc_lanes[f"{o}$pmin"]
            hi, _ = acc_lanes[f"{o}$pmax"]
            if lo.is_floating_point():
                lo = torch.where(w, lo, float("inf"))
                hi = torch.where(w, hi, float("-inf"))
            else:
                lo = torch.where(w, lo, I64_MAX)
                hi = torch.where(w, hi, -I64_MAX)
            out[f"{o}$pmin"] = _seg_min(lo, gid, cap)
            out[f"{o}$pmax"] = _seg_max(hi, gid, cap)
        elif s.kind in ("count", "count_star", "count_if"):
            msum(f"{o}$count")
        elif s.kind in ("sum", "avg") and s._wide_sum:
            from . import wide_decimal as wd

            merged = wd.merge_chunk_lanes(
                [acc_lanes[f"{o}$c{i}"][0] for i in range(4)], w, gid, cap)
            for i, c in enumerate(merged):
                out[f"{o}$c{i}"] = c
            msum(f"{o}$valid" if s.kind == "sum" else f"{o}$count")
        elif s.kind == "avg":
            msum(f"{o}$sum")
            msum(f"{o}$count")
            overflow_check(f"{o}$sum")
        elif s.kind == "sum":
            msum(f"{o}$val")
            msum(f"{o}$valid")
            overflow_check(f"{o}$val")
        elif s.kind in MOMENT_KINDS:
            for suf in ("$sum", "$sumsq", "$count"):
                msum(o + suf)
        elif s.kind == "geometric_mean":
            msum(f"{o}$sumlog")
            msum(f"{o}$count")
        elif s.kind in BINARY_MOMENT_KINDS:
            for suf in ("$sy", "$sx", "$sxy", "$sxx", "$syy", "$n"):
                msum(o + suf)
        elif s.kind in ("min", "max"):
            sv, _ = acc_lanes[f"{o}$val"]
            has = valid_sum(o)
            if sv.dim() == 2:
                out[f"{o}$val"] = _seg_minmax_wide(
                    sv, has, gid, cap, s.kind == "min")
                continue
            if sv.is_floating_point():
                sentinel = float("inf") if s.kind == "min" else float("-inf")
            else:
                # within the lane's dtype (varchar ranks ship as int32
                # codes, where the JAX package's 2^62 wraps to 0)
                info = torch.iinfo(sv.dtype)
                sentinel = (min(I64_MAX, info.max) if s.kind == "min"
                            else max(-I64_MAX, info.min))
            out[f"{o}$val"] = _seg_extreme(
                torch.where(has, sv, sentinel), gid, cap, s.kind == "min")
        elif s.kind in ("bool_and", "bool_or"):
            sv, _ = acc_lanes[f"{o}$val"]
            has = valid_sum(o)
            if s.kind == "bool_and":
                out[f"{o}$val"] = _seg_min(torch.where(has, sv, 1), gid, cap)
            else:
                out[f"{o}$val"] = _seg_max(torch.where(has, sv, 0), gid, cap)
        elif s.kind in BITWISE_KINDS:
            sv, _ = acc_lanes[f"{o}$val"]
            has = valid_sum(o)
            out[f"{o}$val"] = _segment_bitwise(
                sv, has, gid, cap, s.kind.split("_")[1])
        elif s.kind == "checksum":
            msum(f"{o}$val")
            msum(f"{o}$valid")
        elif s.kind == "arbitrary":
            sv, _ = acc_lanes[f"{o}$val"]
            cv, _ = acc_lanes[f"{o}$valid"]
            has = w & (cv > 0)
            n = gid.shape[0]
            idx = torch.arange(n, dtype=torch.int64, device=gid.device)
            ridx = _seg_min(torch.where(has, idx, n), gid, cap)
            ok2 = ridx < n
            val = sv[torch.clamp(ridx, 0, max(n - 1, 0))] if n else torch.zeros(
                (cap,) + tuple(sv.shape[1:]), dtype=sv.dtype, device=sv.device)
            out[f"{o}$val"] = torch.where(
                ok2.reshape((cap,) + (1,) * (val.dim() - 1)), val,
                torch.zeros_like(val))
            out[f"{o}$valid"] = ok2.to(torch.int64)
        elif s.kind in ("min_by", "max_by"):
            sv, _ = acc_lanes[f"{o}$val"]
            kv, _ = acc_lanes[f"{o}$key"]
            xval, _ = acc_lanes[f"{o}$valid"]
            hv, _ = acc_lanes[f"{o}$has"]
            xv, kk, xvalid, has2 = _first_by_key(
                (sv, xval > 0), kv, w & (hv > 0), gid, cap, s.kind == "min_by")
            out[f"{o}$val"] = xv
            out[f"{o}$key"] = kk
            out[f"{o}$valid"] = xvalid.to(torch.int64)
            out[f"{o}$has"] = has2.to(torch.int64)
        elif s.kind in HOST_STAGED_KINDS:
            raise _host_staged(s.kind)
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
    if starts is not None and n > 0:
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


def _host_values(lane: Lane, rows: torch.Tensor, d) -> list:
    """The lane's values at `rows` as Python values in IR-constant form
    (None for NULL; a dictionary column's entry as str), from one copy
    of the lane to the host."""
    import numpy as np

    v, ok = lane
    vv = v[rows].cpu().numpy()
    oo = ok[rows].cpu().numpy()
    if d is not None:
        strs = np.empty(len(d), dtype=object)
        strs[:] = [str(x) for x in d]
        vals = strs[vv].tolist() if len(d) else [None] * len(vv)
    else:
        vals = vv.tolist()
    for i in np.flatnonzero(~oo):
        vals[i] = None
    return vals


def host_staged_lanes(spec: AggSpec, lanes, gid, sel, cap, dicts):
    """array_agg / map_agg / listagg over the selected rows: one group
    value per group as an entry of a fresh dictionary (the JAX package's
    _host_agg_lanes, without its Python walk over every row).  The
    selected rows are put in group order by one stable sort on the
    device, so each group's rows keep their order; the lanes come to
    the host once and split at the group bounds.  Dictionary entries
    follow the order in which the groups first appear among the
    selected rows (map_agg: among those with a non-NULL key); array_agg
    keeps every value in row order, listagg joins the non-NULL ones as
    str() of their IR-constant form, map_agg skips NULL keys, keeps the
    first value per key and sorts the pairs by repr(key).  Returns the
    (codes, present) lane on gid's device and the dictionary."""
    import numpy as np

    live = sel
    if spec.kind == "map_agg":
        live = sel & lanes[spec.input][1]  # NULL keys are skipped
    rows = torch.nonzero(live).flatten()
    g = gid[rows]
    rows = rows[torch.argsort(g, stable=True)]
    gs = gid[rows].cpu().numpy()
    pos = rows.cpu().numpy()
    vals = _host_values(lanes[spec.input], rows, dicts.get(spec.input))
    if spec.kind == "map_agg":
        # spec.input is the KEY, input2 the VALUE (map_agg(key, value))
        mvals = _host_values(lanes[spec.input2], rows, dicts.get(spec.input2))
    starts = np.flatnonzero(np.diff(gs)) + 1 if len(gs) else np.zeros(0, np.int64)
    starts = np.concatenate([[0], starts]) if len(gs) else starts
    ends = np.append(starts[1:], len(gs))
    entries: list = []
    index: dict = {}
    codes = np.zeros(cap, dtype=np.int32)
    has = np.zeros(cap, dtype=bool)
    # a run's first row is its group's first selected row
    for r in np.argsort(pos[starts], kind="stable"):
        a, b = int(starts[r]), int(ends[r])
        if spec.kind == "array_agg":
            obj = tuple(vals[a:b])
        elif spec.kind == "listagg":
            obj = str(spec.param).join(str(x) for x in vals[a:b] if x is not None)
        else:  # the first value per key wins: reversed, later rows lose
            m = dict(zip(reversed(vals[a:b]), reversed(mvals[a:b])))
            obj = tuple(sorted(m.items(), key=lambda kv: repr(kv[0])))
        code = index.setdefault(obj, len(entries))
        if code == len(entries):
            entries.append(obj)
        gi = int(gs[a])
        codes[gi] = code
        has[gi] = True
    d_out = np.empty(len(entries), dtype=object)
    d_out[:] = entries
    dev = gid.device
    return (torch.as_tensor(codes).to(dev), torch.as_tensor(has).to(dev)), d_out

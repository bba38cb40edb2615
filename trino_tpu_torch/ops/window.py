"""Window functions on PyTorch tensors.

Counterpart of trino_tpu/ops/window.py (plain jnp there, no Pallas).
One sort (ops/sort.sort_perm, in the executor) groups partitions and
orders peers; every window function is then a closed-form vector program
over the sorted lanes:

  - partition/peer boundaries by adjacent difference,
  - partition/peer starts and ends from segment sizes (a cumsum numbers
    the segments, an index_add_ counts their rows),
  - ranking functions as index arithmetic on those bounds,
  - framed sums and counts as exclusive-prefix-sum differences (exact
    128-bit decimal sums through 32-bit chunk prefix sums), running
    min/max as segmented scans, sliding min/max as a sparse-table range
    reduction.

The JAX package's segmented scan is a `lax.associative_scan` with
resets; torch has cumsum/cummax but no segmented scan, so `_segscan`
runs the same combine as log2(n) Hillis-Steele doubling steps, which
gives the same result for any associative op (the limb-wise wide
decimal min/max included).

Frames: ROWS with UNBOUNDED / k PRECEDING|FOLLOWING / CURRENT bounds,
RANGE with UNBOUNDED / CURRENT bounds (value-offset RANGE frames are
rejected at analysis).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..expr.lower import Lane

I64_MAX = 2**62


@dataclasses.dataclass(frozen=True)
class WindowBounds:
    """Per-row partition/peer geometry over the sorted batch."""

    idx: torch.Tensor         # [n] row index
    gid: torch.Tensor         # [n] partition id (0-based, unselected rows last)
    part_start: torch.Tensor  # [n] first row index of this row's partition
    part_end: torch.Tensor    # [n] last row index of this row's partition
    peer_start: torch.Tensor  # [n] first row of this row's peer group
    peer_end: torch.Tensor    # [n] last row of this row's peer group
    peer_boundary: torch.Tensor  # [n] bool, first row of a peer group
    n: int


def _segments(boundary: torch.Tensor):
    """Per-row segment id, first and last row index of the contiguous
    segments that start where `boundary` is set (row 0 must be set):
    one cumsum numbers the segments, an index_add_ sizes them and a
    second cumsum over the sizes gives their ends."""
    n = boundary.shape[0]
    seg = torch.cumsum(boundary.to(torch.int64), 0) - 1
    size = torch.zeros(n, dtype=torch.int64, device=boundary.device)
    size.index_add_(0, seg, torch.ones_like(seg))
    end = torch.cumsum(size, 0) - 1
    return seg, (end - size + 1)[seg], end[seg]


def _shifted_neq(v: torch.Tensor) -> torch.Tensor:
    """[n-1] bool: row i+1 differs from row i (either limb of a wide
    decimal)."""
    vv = v.to(torch.int8) if v.dtype == torch.bool else v
    neq = vv[1:] != vv[:-1]
    return neq.any(dim=-1) if neq.dim() == 2 else neq


def compute_bounds(
    part_lanes: Sequence[Lane],
    order_lanes: Sequence[Lane],
    sel: torch.Tensor,
) -> WindowBounds:
    """Boundary geometry for rows already sorted by (sel desc, partition
    keys, order keys).  A change in `sel` also opens a partition so the
    unselected tail never merges with a real partition."""
    n = sel.shape[0]
    dev = sel.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    first = torch.zeros(n, dtype=torch.bool, device=dev)
    first[:1] = True
    zero = torch.zeros(1, dtype=torch.bool, device=dev)

    def changes(lanes):
        ch = torch.zeros(n, dtype=torch.bool, device=dev)
        for v, ok in lanes:
            ch = ch | torch.cat([zero, _shifted_neq(v) | (ok[1:] != ok[:-1])])[:n]
        return ch

    sel_change = torch.cat([zero, sel[1:] != sel[:-1]])[:n]
    pb = first | changes(part_lanes) | sel_change
    peer_b = pb | changes(order_lanes)

    gid, part_start, part_end = _segments(pb)
    _, peer_start, peer_end = _segments(peer_b)
    return WindowBounds(
        idx, gid, part_start, part_end, peer_start, peer_end, peer_b, n
    )


# --- frame resolution ---------------------------------------------------


def frame_range(frame, b: WindowBounds) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row inclusive [start, end] row-index tensors for a plan
    WindowFrame (unit rows|range; bounds validated by the analyzer)."""
    if frame.unit == "rows":
        start = {
            "unbounded_preceding": lambda: b.part_start,
            "preceding": lambda: torch.maximum(b.idx - frame.start_offset,
                                               b.part_start),
            "current": lambda: b.idx,
            "following": lambda: b.idx + frame.start_offset,
        }[frame.start_kind]()
        end = {
            "current": lambda: b.idx,
            "preceding": lambda: b.idx - frame.end_offset,
            "following": lambda: torch.minimum(b.idx + frame.end_offset,
                                               b.part_end),
            "unbounded_following": lambda: b.part_end,
        }[frame.end_kind]()
    else:  # range / groups with unbounded|current bounds only
        start = {
            "unbounded_preceding": b.part_start,
            "current": b.peer_start,
        }[frame.start_kind]
        end = {
            "current": b.peer_end,
            "unbounded_following": b.part_end,
        }[frame.end_kind]
    return start, end


def _prefix_unbounded(frame) -> bool:
    return frame.start_kind == "unbounded_preceding"


def _suffix_unbounded(frame) -> bool:
    return frame.end_kind == "unbounded_following"


def _all_valid(b: WindowBounds) -> torch.Tensor:
    return torch.ones(b.n, dtype=torch.bool, device=b.idx.device)


# --- ranking ------------------------------------------------------------


def row_number(b: WindowBounds) -> Lane:
    return b.idx - b.part_start + 1, _all_valid(b)


def rank(b: WindowBounds) -> Lane:
    return b.peer_start - b.part_start + 1, _all_valid(b)


def dense_rank(b: WindowBounds) -> Lane:
    cpeer = torch.cumsum(b.peer_boundary.to(torch.int64), 0)
    safe = torch.clamp(b.part_start, 0, max(b.n - 1, 0))
    return cpeer - cpeer[safe] + 1, _all_valid(b)


def percent_rank(b: WindowBounds, sel: torch.Tensor) -> Lane:
    size = _partition_size(b, sel)
    r = (b.peer_start - b.part_start).to(torch.float64)
    den = torch.clamp(size - 1, min=1).to(torch.float64)
    v = torch.where(size > 1, r / den, 0.0)
    return v, _all_valid(b)


def cume_dist(b: WindowBounds, sel: torch.Tensor) -> Lane:
    size = _partition_size(b, sel)
    covered = (b.peer_end - b.part_start + 1).to(torch.float64)
    v = covered / torch.clamp(size, min=1).to(torch.float64)
    return v, _all_valid(b)


def _partition_size(b: WindowBounds, sel: torch.Tensor) -> torch.Tensor:
    cnt = torch.zeros(b.n, dtype=torch.int64, device=sel.device)
    cnt.index_add_(0, b.gid, sel.to(torch.int64))
    return cnt[torch.clamp(b.gid, 0, max(b.n - 1, 0))]


def ntile(b: WindowBounds, sel: torch.Tensor, buckets: int) -> Lane:
    size = _partition_size(b, sel)
    rn0 = b.idx - b.part_start
    q, r = size // buckets, size % buckets
    threshold = (q + 1) * r
    big = rn0 // torch.clamp(q + 1, min=1)
    small = r + (rn0 - threshold) // torch.clamp(q, min=1)
    v = torch.where(rn0 < threshold, big, small) + 1
    return v, _all_valid(b)


# --- value functions ----------------------------------------------------


def shift_value(
    lane: Lane,
    b: WindowBounds,
    offset: int,
    default: Optional[object],
    lead: bool,
) -> Lane:
    """lag/lead: value `offset` rows behind/ahead within the partition,
    else the (constant) default."""
    v, ok = lane
    j = b.idx + offset if lead else b.idx - offset
    in_part = (j <= b.part_end) if lead else (j >= b.part_start)
    safe = torch.clamp(j, 0, max(b.n - 1, 0))
    vj, okj = v[safe], ok[safe]
    if default is None:
        dv = torch.zeros((), dtype=v.dtype, device=v.device)
        dok = torch.zeros((), dtype=torch.bool, device=v.device)
    else:
        dv = torch.tensor(default, dtype=v.dtype, device=v.device)
        dok = torch.ones((), dtype=torch.bool, device=v.device)
    take = in_part[:, None] if vj.dim() == 2 else in_part
    return torch.where(take, vj, dv), torch.where(in_part, okj, dok)


def value_at(lane: Lane, at: torch.Tensor, nonempty: torch.Tensor) -> Lane:
    """first_value/last_value: gather the frame-start/end row's value."""
    v, ok = lane
    safe = torch.clamp(at, 0, max(v.shape[0] - 1, 0))
    return v[safe], ok[safe] & nonempty


def nth_value(
    lane: Lane, start: torch.Tensor, end: torch.Tensor, nth: int
) -> Lane:
    v, ok = lane
    at = start + (nth - 1)
    inside = at <= end
    safe = torch.clamp(at, 0, max(v.shape[0] - 1, 0))
    return v[safe], ok[safe] & inside


# --- framed aggregates --------------------------------------------------


def _excl_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros(1, dtype=x.dtype, device=x.device),
                      torch.cumsum(x, 0)])


def _frame_index(start, end, n):
    """(nonempty, clipped start, clipped end + 1) of inclusive frames."""
    nonempty = end >= start
    s = torch.clamp(start, 0, max(n - 1, 0))
    e1 = torch.clamp(end + 1, 0, n)
    return nonempty, s, e1


def framed_sum_count(
    lane: Optional[Lane],
    sel: torch.Tensor,
    start: torch.Tensor,
    end: torch.Tensor,
    count_star: bool = False,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """(sum, count) of lane over the inclusive [start, end] frame.
    lane None (count(*)): counts selected rows."""
    nonempty, s, e1 = _frame_index(start, end, sel.shape[0])
    if count_star or lane is None:
        c = _excl_cumsum(sel.to(torch.int64))
        return None, torch.where(nonempty, c[e1] - c[s], 0)
    v, ok = lane
    live = sel & ok
    if v.is_floating_point():
        masked = torch.where(live, v, 0.0)
    else:
        masked = torch.where(live, v.to(torch.int64), 0)
    cs = _excl_cumsum(masked)
    cc = _excl_cumsum(live.to(torch.int64))
    ssum = torch.where(nonempty, cs[e1] - cs[s],
                       torch.zeros((), dtype=masked.dtype, device=v.device))
    cnt = torch.where(nonempty, cc[e1] - cc[s], 0)
    return ssum, cnt


def framed_sum_wide(
    lane: Lane, sel: torch.Tensor, start: torch.Tensor, end: torch.Tensor
):
    """Exact 128-bit framed SUM over (narrow or wide) decimal lanes:
    32-bit chunk exclusive prefix sums, frame-end differences, one carry
    normalization (the windowed form of the chunked group SUM)."""
    from . import wide_decimal as wd

    v, ok = lane
    live = sel & ok
    nonempty, s, e1 = _frame_index(start, end, sel.shape[0])
    chunks = (
        wd.wide_row_chunks(v, live) if wd.is_wide(v)
        else wd.narrow_row_chunks(v, live)
    )
    diffs = []
    for c in chunks:
        cs = _excl_cumsum(c)
        diffs.append(torch.where(nonempty, cs[e1] - cs[s], 0))
    while len(diffs) < 4:
        diffs.append(torch.zeros_like(diffs[0]))
    wide = wd.chunks_to_wide(wd.normalize_chunks(diffs))
    cc = _excl_cumsum(live.to(torch.int64))
    cnt = torch.where(nonempty, cc[e1] - cc[s], 0)
    return wide, cnt


def _segscan(v: torch.Tensor, reset: torch.Tensor, op, reverse: bool):
    """Segmented prefix scan: op-combine values left-to-right (or right-to-
    left), restarting at rows where reset is True (in scan direction).
    Values may carry trailing dims (wide-decimal limb pairs); the reset
    flag broadcasts over them.  Hillis-Steele doubling with the JAX
    package's combine (f1, v1) . (f2, v2) = (f1 | f2, f2 ? v2 : op(v1, v2)),
    ceil(log2(n)) steps."""
    if reverse:
        return torch.flip(_segscan(torch.flip(v, [0]), torch.flip(reset, [0]),
                                   op, False), [0])
    n = v.shape[0]
    f, out = reset, v
    step = 1
    while step < n:
        f_prev, v_prev = f[:-step], out[:-step]
        f_cur, v_cur = f[step:], out[step:]
        fb = f_cur[:, None] if v_cur.dim() > f_cur.dim() else f_cur
        merged = torch.where(fb, v_cur, op(v_prev, v_cur))
        out = torch.cat([out[:step], merged])
        f = torch.cat([f[:step], f_prev | f_cur])
        step *= 2
    return out


def _floor_log2(width: torch.Tensor, levels: int) -> torch.Tensor:
    """floor(log2(width)) for width >= 1, -1 for width < 1 (the JAX
    package's 63 - clz(width)), as a count of powers of two <= width."""
    lev = torch.full_like(width, -1)
    for k in range(levels + 1):
        lev = lev + (width >= (1 << k)).to(lev.dtype)
    return lev


def _range_extreme(
    masked: torch.Tensor, start: torch.Tensor, end: torch.Tensor, op,
    identity,
) -> torch.Tensor:
    """Per-row range reduction masked[start[i]..end[i]] for arbitrary
    per-row ranges: a sparse-table (binary-lifting) reduction.  Level k
    holds T_k[i] = op(masked[i .. i+2^k-1]); a range of width w is two
    overlapping 2^k blocks where k = floor(log2(w)).  Empty ranges keep
    the identity (the caller's count masks them to NULL)."""
    n = masked.shape[0]
    width = torch.clamp(end - start + 1, min=0)
    # levels must include k = floor(log2(n)): a frame spanning the whole
    # batch has width n and queries that top level
    levels = max(1, n.bit_length())
    lev = _floor_log2(width, levels)
    ident = torch.as_tensor(np.asarray(identity), dtype=masked.dtype,
                            device=masked.device)
    out = ident.expand(masked.shape).clone()
    tbl = masked
    s_clip = torch.clamp(start, 0, max(n - 1, 0))
    for k in range(levels):
        hit = lev == k
        if masked.dim() > 1:
            hit = hit[:, None]
        # two overlapping 2^k blocks: [s, s+2^k-1] and [e-2^k+1, e]
        second = torch.clamp(end - (1 << k) + 1, 0, max(n - 1, 0))
        cand = op(tbl[s_clip], tbl[second])
        out = torch.where(hit, cand, out)
        # next level: T_{k+1}[i] = op(T_k[i], T_k[i + 2^k]) (tail rows
        # keep their shorter suffix block, never queried past n-1)
        step = 1 << k
        if step < n:
            shifted = torch.cat([tbl[step:], tbl[n - step:]])
            tbl = op(tbl, shifted)
    return out


def _part_resets(b: WindowBounds, reverse: bool) -> torch.Tensor:
    """Rows where a forward (or reverse) scan restarts: each partition's
    first (or last) row."""
    one = torch.ones(1, dtype=torch.bool, device=b.idx.device)
    change = b.part_start[1:] != b.part_start[:-1]
    if reverse:
        return torch.cat([change, one])[: b.n]
    return torch.cat([one, change])[: b.n]


def _framed_extreme(masked, b: WindowBounds, frame, op, identity):
    start, end = frame_range(frame, b)
    last = max(b.n - 1, 0)
    if _prefix_unbounded(frame):
        running = _segscan(masked, _part_resets(b, False), op, reverse=False)
        return running[torch.clamp(end, 0, last)]
    if _suffix_unbounded(frame):
        running = _segscan(masked, _part_resets(b, True), op, reverse=True)
        return running[torch.clamp(start, 0, last)]
    # sliding frame (bounded both ends): per-row range reduction
    return _range_extreme(masked, start, end, op, identity)


def framed_minmax(
    lane: Lane,
    sel: torch.Tensor,
    b: WindowBounds,
    frame,
    kind: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(value, count) min/max over frames: prefix/suffix segmented scans
    gathered at the bounded end, or the sliding range reduction."""
    v, ok = lane
    live = sel & ok
    if v.is_floating_point():
        sentinel = float("inf") if kind == "min" else float("-inf")
        masked = torch.where(live, v, sentinel)
    else:
        sentinel = I64_MAX if kind == "min" else -I64_MAX
        masked = torch.where(live, v.to(torch.int64), sentinel)
    op = torch.minimum if kind == "min" else torch.maximum
    start, end = frame_range(frame, b)
    _, cnt = framed_sum_count(lane, sel, start, end)
    return _framed_extreme(masked, b, frame, op, sentinel), cnt


# --- wide (two-limb) decimal min/max ------------------------------------
# decimal(19..38) lanes are (n, 2) int64: limb 0 the low 64 bits
# (unsigned), limb 1 the high 64 bits (signed).  Ordering is limb-wise:
# compare high limbs signed, tie-break on low limbs unsigned (XOR the
# sign bit turns the unsigned compare into a signed one).

_WIDE_SIGN = -(2**63)


def _wide_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    lo_a = a[..., 0] ^ _WIDE_SIGN
    lo_b = b[..., 0] ^ _WIDE_SIGN
    return (a[..., 1] < b[..., 1]) | ((a[..., 1] == b[..., 1]) & (lo_a < lo_b))


def _wide_min_op(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.where(_wide_less(x, y)[..., None], x, y)


def _wide_max_op(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.where(_wide_less(y, x)[..., None], x, y)


def wide_sentinel(kind: str) -> np.ndarray:
    """Identity limb pair for wide min/max.  hi = +-(2^63 - 1) strictly
    dominates every decimal(38) value; min/max only compare and select,
    so the full int64 range is safe here."""
    hi = np.int64(2**63 - 1)
    if kind == "min":
        return np.array([-1, hi], dtype=np.int64)  # lo = all ones
    return np.array([0, -hi], dtype=np.int64)


def framed_minmax_wide(
    lane: Lane,
    sel: torch.Tensor,
    b: WindowBounds,
    frame,
    kind: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(value, count) min/max over wide-decimal (n, 2) lanes: the same
    scans and range reduction as framed_minmax with the limb-wise
    compare, whole limb pairs selected per combine."""
    v, ok = lane
    live = sel & ok
    sent = wide_sentinel(kind)
    masked = torch.where(live[:, None], v,
                         torch.as_tensor(sent, device=v.device))
    op = _wide_min_op if kind == "min" else _wide_max_op
    start, end = frame_range(frame, b)
    # frame count inline (framed_sum_count sums scalar lanes only)
    nonempty, s, e1 = _frame_index(start, end, b.n)
    cc = _excl_cumsum(live.to(torch.int64))
    cnt = torch.where(nonempty, cc[e1] - cc[s], 0)
    return _framed_extreme(masked, b, frame, op, sent), cnt

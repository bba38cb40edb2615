"""Equi-join kernels: sorted-build lookup, direct-address lookup and
the duplicate-key expansion.

Counterpart of trino_tpu/ops/join.py, with the same functions and the
same results bit for bit:
  - build_unique/probe: the build side sorted by key (dead rows last),
    each probe key located by rank among the build keys (merge_rank);
  - build_direct/probe_direct: a dense table of build row + 1 indexed
    by key - lo, probed by one gather per row (the CUDA kernel
    ops/kernels.direct_probe on the card);
  - build_multi/probe_counts/expand_join_slots: duplicate build keys,
    each probe row expanded by its match count;
  - composite_key/verify_rows: multi-column keys locate candidates by a
    64-bit mix and are then verified on the real columns.

merge_rank is torch.searchsorted: the JAX package ranks by one stable
sort of build ++ probe because XLA:TPU's per-lane binary search was
slow; both give the count of build keys below (left) or at-or-below
(right) each probe key of a sorted build array.  Hashes use uint64
arithmetic held in int64 tensors: multiply and add wrap alike, the
logical right shift masks off the sign extension, and the reductions
mod 2^k keep the low k bits.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from ..expr.lower import Lane
from . import kernels
from .int128 import as_i64, srl

# dead (unselected/NULL-key) build rows sort to the very end: their key is
# pinned to int64 max AND a live-before-dead flag breaks the tie, so the
# first `nvalid` sorted slots are exactly the live rows
_SENTINEL = 2**63 - 1
_GOLDEN = as_i64(0x9E3779B97F4A7C15)
_MIX_C = as_i64(0x632BE59BD9B4E019)


def _sort_live_first(kv: torch.Tensor, live: torch.Tensor):
    """Stable sort by (kv, dead): two stable passes, the minor key first."""
    p = torch.sort(torch.logical_not(live).to(torch.int8), stable=True).indices
    s = torch.sort(kv[p], stable=True)
    return s.values, p[s.indices]


def merge_rank(sorted_build: torch.Tensor, probe: torch.Tensor, side: str):
    """For each probe key: the number of build keys strictly below it
    (side='left') or at-or-below it (side='right')."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    return torch.searchsorted(sorted_build.contiguous(), probe.contiguous(),
                              side=side).to(torch.int64)


class LookupSource(NamedTuple):
    sorted_keys: torch.Tensor  # [n] int64, dead rows pushed to the end
    perm: torch.Tensor  # [n] original row index per sorted slot
    nvalid: torch.Tensor  # scalar: number of valid build rows
    dup_count: torch.Tensor  # scalar: number of duplicate keys (0 required)


def build_unique(key: Lane, sel: torch.Tensor) -> LookupSource:
    """Sort build rows by key; unselected/null rows sort to the end."""
    v, ok = key
    n = v.shape[0]
    live = sel & ok
    kv = torch.where(live, v.to(torch.int64), _SENTINEL)
    sorted_keys, perm = _sort_live_first(kv, live)
    nvalid = live.sum()
    idx = torch.arange(1, n, dtype=torch.int64, device=v.device)
    dup = torch.sum((sorted_keys[1:] == sorted_keys[:-1]) & (idx < nvalid))
    return LookupSource(sorted_keys, perm, nvalid, dup)


def take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[idx], reading zeros from an empty t (an empty build side) where
    PyTorch indexing would raise."""
    if t.shape[0] == 0:
        return torch.zeros(idx.shape, dtype=t.dtype, device=t.device)
    return t[idx]


def probe(
    source: LookupSource, key: Lane, sel: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vectorized lookup: returns (build_row_index, matched mask)."""
    v, ok = key
    pk = v.to(torch.int64)
    idx = merge_rank(source.sorted_keys, pk, side="left")
    safe = torch.clamp(idx, 0, max(source.sorted_keys.shape[0] - 1, 0))
    hit = (take(source.sorted_keys, safe) == pk) & (safe < source.nvalid)
    matched = sel & ok & hit
    return take(source.perm, safe), matched


def gather_build(
    build_cols: Dict[str, Lane], build_row: torch.Tensor, matched: torch.Tensor
) -> Dict[str, Lane]:
    """Build-side payload lanes for each probe row."""
    from .filter_project import permute_lanes

    return permute_lanes(build_cols, build_row, extra_ok=matched)


class DirectLookupSource(NamedTuple):
    """Dense-domain build table: rowid+1 scattered at (key - lo), 0 =
    empty slot; usable only when the planner proved the build key unique
    and bounded its domain.  `violations` counts live build keys outside
    the domain plus overwritten (duplicate) rows: nonzero reroutes the
    join to the sorted kernels, so stale stats never give a wrong row."""

    table: torch.Tensor  # [domain] int32: build row + 1, 0 = empty
    lo: int
    violations: torch.Tensor  # scalar int64


def build_direct(key: Lane, sel: torch.Tensor, lo: int, domain: int
                 ) -> DirectLookupSource:
    v, ok = key
    live = sel & ok
    kv = v.to(torch.int64) - lo
    in_dom = (kv >= 0) & (kv < domain)
    viol = torch.sum(live & ~in_dom).to(torch.int64)
    idx = torch.where(live & in_dom, kv, domain)  # slot `domain` is dropped
    n = v.shape[0]
    rowid1 = torch.arange(1, n + 1, dtype=torch.int32, device=v.device)
    table = torch.zeros(domain + 1, dtype=torch.int32, device=v.device)
    table.scatter_reduce_(0, idx, rowid1, "amax")
    table = table[:domain]
    # duplicate detector: each live row reads its slot back; an
    # overwritten row reads another row's id
    readback = table[torch.clamp(kv, 0, domain - 1)]
    dups = torch.sum(live & in_dom & (readback != rowid1)).to(torch.int64)
    return DirectLookupSource(table, lo, viol + dups)


def probe_direct(
    source: DirectLookupSource, key: Lane, sel: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One gather (the direct_probe kernel): build row index + matched
    mask per probe row.  Out-of-domain probe keys match nothing."""
    v, ok = key
    return kernels.direct_probe(source.table, v, ok, sel, source.lo)


class MultiLookupSource(NamedTuple):
    """Build side with duplicate keys allowed."""

    sorted_keys: torch.Tensor
    perm: torch.Tensor
    nvalid: torch.Tensor


def build_multi(key: Lane, sel: torch.Tensor) -> MultiLookupSource:
    v, ok = key
    live = sel & ok
    kv = torch.where(live, v.to(torch.int64), _SENTINEL)
    sorted_keys, perm = _sort_live_first(kv, live)
    return MultiLookupSource(sorted_keys, perm, live.sum())


def probe_counts(
    source: MultiLookupSource, key: Lane, sel: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-probe-row match count and first-match slot ([lo,hi) range);
    dead build slots (beyond nvalid) and dead probe rows count zero."""
    v, ok = key
    pk = v.to(torch.int64)
    sk = source.sorted_keys
    lo = merge_rank(sk, pk, side="left")
    nb = sk.shape[0]
    dev = sk.device
    one = torch.ones(1, dtype=torch.bool, device=dev)
    boundary = torch.cat([one, sk[1:] != sk[:-1]])[:nb]
    idx = torch.arange(nb, dtype=torch.int64, device=dev)
    run_start = torch.cummax(torch.where(boundary, idx, 0), 0).values
    nxt = torch.cat([boundary[1:], one])[:nb]
    run_end = torch.flip(
        torch.cummin(torch.flip(torch.where(nxt, idx, nb - 1), [0]), 0).values,
        [0])
    run_len = run_end - run_start + 1
    safe = torch.clamp(lo, 0, max(nb - 1, 0))
    eq = take(sk, safe) == pk
    hi = torch.where(eq, lo + take(run_len, safe), lo)
    lo = torch.minimum(lo, source.nvalid)
    hi = torch.minimum(hi, source.nvalid)
    counts = torch.where(sel & ok, hi - lo, 0).to(torch.int64)
    return counts, lo


def expand_join_slots(
    source: MultiLookupSource,
    counts: torch.Tensor,
    lo: torch.Tensor,
    capacity: int,
    outer: bool = False,
):
    """Expand probe rows by their match multiplicity into `capacity`
    output slots.  Returns (probe_row, build_row, matched, total, k) as
    the JAX package does: k == 0 marks the one slot per probe row that
    carries an outer join's null-extended row."""
    dev = counts.device
    eff = torch.clamp(counts, min=1) if outer else counts
    offsets = torch.cumsum(eff, 0)
    nrows = counts.shape[0]
    total = offsets[-1] if nrows else torch.zeros((), dtype=torch.int64, device=dev)
    j = torch.arange(capacity, dtype=torch.int64, device=dev)
    # output slot -> probe row: each row's id at its start offset, then a
    # running max fills the row's range (rows with eff=0 own no slots)
    starts = offsets - eff
    seed = torch.zeros(capacity + 1, dtype=torch.int64, device=dev)
    seed.scatter_reduce_(
        0, torch.where(eff > 0, torch.clamp(starts, max=capacity), capacity),
        torch.arange(nrows, dtype=torch.int64, device=dev), "amax")
    probe_row = torch.cummax(seed[:capacity], 0).values if capacity else seed[:0]
    probe_row = torch.clamp(probe_row, 0, max(nrows - 1, 0))
    start = take(offsets, probe_row) - take(eff, probe_row)
    k = j - start
    slot = torch.clamp(take(lo, probe_row) + k, 0,
                       max(source.sorted_keys.shape[0] - 1, 0))
    build_row = take(source.perm, slot)
    within = j < total
    matched = within & (k < take(counts, probe_row))
    return probe_row, build_row, matched, total, k


def needs_verification(key_lanes) -> bool:
    """True when the locator is a lossy hash that candidates must be
    re-checked against: multi-column keys, or any wide (two-limb)
    decimal key."""
    return len(key_lanes) > 1 or any(v.dim() == 2 for v, _ in key_lanes)


def verify_rows(
    build_keys, probe_keys, build_row: torch.Tensor, probe_row=None,
) -> torch.Tensor:
    """Exact key equality of candidate pairs; NULL keys never match."""
    eq = None
    for (bv, bok), (pv, pok) in zip(build_keys, probe_keys):
        b, bo = take(bv, build_row), take(bok, build_row)
        p = pv if probe_row is None else take(pv, probe_row)
        po = pok if probe_row is None else take(pok, probe_row)
        if b.dim() == 2 or p.dim() == 2:
            from . import wide_decimal as wd

            veq = wd.compare(wd.promote(b), wd.promote(p), "==")
        else:
            veq = b == p
        e = veq & bo & po
        eq = e if eq is None else (eq & e)
    return eq


def _canonical_bits(v: torch.Tensor) -> torch.Tensor:
    """Lane value -> one uint64 (held in int64) of hash material,
    identical for a narrow lane and a two-limb lane holding the same
    value; genuinely 128-bit values fold in the high limb."""
    if v.dim() == 2:
        from . import wide_decimal as wd

        lo = v[:, 0].to(torch.int64)
        hi = v[:, 1].to(torch.int64)
        folded = lo ^ (hi * _GOLDEN)
        return torch.where(wd.fits_narrow(v), lo, folded)
    return v.to(torch.int64)


def _mix(h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One splitmix-style mixing round.  Module-level so adversarial tests
    can patch in a deliberately weak hash and prove the exact-verification
    path (verify_rows) absorbs collisions."""
    h = h * _GOLDEN + x + _MIX_C
    return h ^ srl(h, 31)


def composite_key(key_lanes, sel, force_hash: bool = False) -> Lane:
    """Combine a multi-column equi-join key into one int64 locator lane.
    Single-column narrow keys pass through; otherwise a 64-bit mix that
    callers must verify with `verify_rows` (see the JAX package).
    `force_hash` imposes the joint decision of both join sides."""
    if not force_hash and not needs_verification(key_lanes):
        return key_lanes[0]
    n = key_lanes[0][0].shape[0]
    h = torch.zeros(n, dtype=torch.int64, device=key_lanes[0][0].device)
    allok = None
    for v, ok in key_lanes:
        h = _mix(h, _canonical_bits(v))
        allok = ok if allok is None else (allok & ok)
    # into the non-negative int64 range: h mod 2^62 of the uint64
    return (h & (2**62 - 1), allok)

"""Output page partitioning for the exchange (shuffle-write).

Counterpart of trino_tpu/exec/partitioner.py (hash_rows, take_rows,
partition_page, partition_page_round_robin, chunk_page, concat_pages and
the SkewedPartitionRebalancer of the hive connector's scaled writer,
copied; host-side numpy).  Reference parity:
operator/output/PagePartitioner.java:55 (partitionPage:134): rows of an
output page are routed to one buffer per consumer by a hash of the
partition keys.  Dictionary-coded varchar keys hash their string values,
so codes assigned by different producers agree.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..page import Column, Page

_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (vectorized)."""
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9) & _M64
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB) & _M64
        return x ^ (x >> np.uint64(31))


def _fnv_str(s: str) -> int:
    h = 0xCBF29CE484222325
    for ch in s.encode():
        h = ((h ^ ch) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def hash_rows(page: Page, keys: Sequence[str]) -> np.ndarray:
    """uint64 partition hash per row over the named key columns."""
    n = page.count
    h = np.full(n, 0x9E3779B97F4A7C15, dtype=np.uint64)
    for k in keys:
        col = page.by_name(k)
        vals = np.asarray(col.values)[:n]
        if col.dictionary is not None:
            # hash string values for cross-producer stability
            dict_hash = np.array(
                [_fnv_str(str(s)) for s in col.dictionary], dtype=np.uint64
            )
            safe = np.clip(vals, 0, max(len(dict_hash) - 1, 0))
            ch = np.where(
                vals >= 0,
                dict_hash[safe] if len(dict_hash) else np.uint64(0),
                np.uint64(0),
            )
        elif vals.ndim == 2:
            # wide (two-limb) decimal: fold both limbs into one chunk
            with np.errstate(over="ignore"):
                ch = _mix64(
                    vals[:, 0].astype(np.int64).view(np.uint64)
                    ^ (vals[:, 1].astype(np.int64).view(np.uint64)
                       * np.uint64(0x9E3779B97F4A7C15))
                )
        elif vals.dtype.kind == "f":
            ch = _mix64(vals.view(np.uint64) if vals.dtype == np.float64
                        else vals.astype(np.float64).view(np.uint64))
        else:
            ch = _mix64(vals.astype(np.int64).view(np.uint64))
        if col.validity is not None:
            ch = np.where(np.asarray(col.validity)[:n], ch, np.uint64(0))
        with np.errstate(over="ignore"):
            h = (h * np.uint64(31) + ch) & _M64
    return _mix64(h)


def take_rows(page: Page, idx: np.ndarray) -> Page:
    cols = []
    for c in page.columns:
        vals = np.asarray(c.values)[:page.count][idx]
        ok = (
            None
            if c.validity is None
            else np.asarray(c.validity)[:page.count][idx]
        )
        cols.append(Column(c.type, vals, ok, c.dictionary))
    return Page(cols, len(idx), page.names)


def partition_page(page: Page, keys: Sequence[str], nparts: int) -> List[Page]:
    """Split a page into nparts pages by hash(keys) % nparts."""
    if nparts == 1:
        return [page]
    part = (hash_rows(page, keys) % np.uint64(nparts)).astype(np.int64)
    return [take_rows(page, np.nonzero(part == p)[0]) for p in range(nparts)]


def partition_page_round_robin(page: Page, nparts: int) -> List[Page]:
    """Split a page into nparts pages row-round-robin (RandomExchanger /
    FIXED_ARBITRARY_DISTRIBUTION): balances load with no key affinity."""
    if nparts == 1:
        return [page]
    idx = np.arange(page.count)
    return [take_rows(page, idx[p::nparts]) for p in range(nparts)]


def chunk_page(page: Page, rows_per_chunk: int = 65536) -> List[Page]:
    """Split a page into bounded-size wire chunks (output buffer frames)."""
    if page.count <= rows_per_chunk:
        return [page]
    out = []
    for start in range(0, page.count, rows_per_chunk):
        idx = np.arange(start, min(start + rows_per_chunk, page.count))
        out.append(take_rows(page, idx))
    return out


def concat_pages(pages: List[Page]) -> Page:
    """Concatenate pages with identical schema (single-producer merge)."""
    assert pages, "no pages"
    if len(pages) == 1:
        return pages[0]
    first = pages[0]
    cols = []
    for i in range(first.num_columns):
        vals = np.concatenate(
            [np.asarray(p.columns[i].values)[: p.count] for p in pages]
        )
        oks = [
            np.ones(p.count, bool)
            if p.columns[i].validity is None
            else np.asarray(p.columns[i].validity)[: p.count]
            for p in pages
        ]
        ok = np.concatenate(oks)
        cols.append(
            Column(
                first.columns[i].type,
                vals,
                None if ok.all() else ok,
                first.columns[i].dictionary,
            )
        )
    return Page(cols, sum(p.count for p in pages), first.names)


class SkewedPartitionRebalancer:
    """Skew-aware partition assignment for scaled writes.

    Reference parity: operator/output/SkewedPartitionRebalancer.java:55 +
    ScaleWriterPartitioningExchanger — when one partition receives a
    disproportionate share of the rows, it is assigned EXTRA writers and
    its rows round-robin across them.  Writer affinity is a clustering
    preference for writes, not a correctness requirement, so splitting a
    hot partition is safe (the reference applies the same relaxation).

    Stateful across pages: observed per-partition row counts accumulate,
    and every `rebalance_interval` rows the hottest partitions (above
    `skew_factor` x the mean) get one more bucket each, drawn from the
    least-loaded buckets.
    """

    def __init__(self, nparts: int, skew_factor: float = 2.0,
                 rebalance_interval: int = 65536):
        self.nparts = nparts
        self.skew_factor = skew_factor
        self.rebalance_interval = rebalance_interval
        self.part_rows = np.zeros(nparts, dtype=np.int64)
        self.bucket_rows = np.zeros(nparts, dtype=np.int64)
        # partition -> list of buckets its rows cycle through
        self.assignments: List[List[int]] = [[p] for p in range(nparts)]
        self._since_rebalance = 0
        self._rr = np.zeros(nparts, dtype=np.int64)

    def scaled_partitions(self) -> List[int]:
        return [p for p, a in enumerate(self.assignments) if len(a) > 1]

    def _maybe_rebalance(self):
        if self._since_rebalance < self.rebalance_interval:
            return
        self._since_rebalance = 0
        total = self.part_rows.sum()
        if total == 0:
            return
        mean = total / self.nparts
        for p in np.argsort(-self.part_rows):
            if self.part_rows[p] <= self.skew_factor * mean:
                break
            if len(self.assignments[p]) >= self.nparts:
                continue
            # grant the least-loaded bucket not already assigned
            for b in np.argsort(self.bucket_rows):
                if int(b) not in self.assignments[p]:
                    self.assignments[p].append(int(b))
                    break

    def assign(self, page: Page, keys: Sequence[str]) -> np.ndarray:
        """Per-row OUTPUT bucket; hot partitions cycle their buckets."""
        part = (
            hash_rows(page, keys) % np.uint64(self.nparts)
        ).astype(np.int64)
        np.add.at(self.part_rows, part, 1)
        self._since_rebalance += page.count
        self._maybe_rebalance()
        bucket = part.copy()
        for p in self.scaled_partitions():
            rows = np.nonzero(part == p)[0]
            if len(rows) == 0:
                continue
            buckets = np.array(self.assignments[p], dtype=np.int64)
            offs = (self._rr[p] + np.arange(len(rows))) % len(buckets)
            bucket[rows] = buckets[offs]
            self._rr[p] += len(rows)
        np.add.at(self.bucket_rows, bucket, 1)
        return bucket

    def partition_page(self, page: Page, keys: Sequence[str]) -> List[Page]:
        """Feed the page through assign() in rebalance_interval-sized
        chunks so hot partitions can escalate to MULTIPLE extra buckets
        within one large write (a single assign call would rebalance at
        most once)."""
        buckets = np.empty(page.count, dtype=np.int64)
        step = self.rebalance_interval
        for start in range(0, page.count, step):
            idx = np.arange(start, min(start + step, page.count))
            buckets[idx] = self.assign(take_rows(page, idx), keys)
        return [
            take_rows(page, np.nonzero(buckets == b)[0])
            for b in range(self.nparts)
        ]

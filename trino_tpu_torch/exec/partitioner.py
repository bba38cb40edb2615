"""Output page partitioning for the exchange (shuffle-write).

Counterpart of trino_tpu/exec/partitioner.py (hash_rows, take_rows and
partition_page, copied; host-side numpy).  Reference parity:
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

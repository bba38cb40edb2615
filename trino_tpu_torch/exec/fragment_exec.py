"""Fragment execution: assigned splits and remote exchange inputs.

Counterpart of trino_tpu/exec/fragment_exec.py.  Reference parity:
execution/SqlTaskExecution.java:85 (splits -> drivers over one
fragment's operator chain) and operator/ExchangeOperator.java:44 (remote
source pages pulled from upstream tasks).  This subclass of the eager
executor only changes where leaf data comes from (exec/scan.py loads it):

  - TableScans read only the splits assigned to this task;
  - RemoteSources read the pages of upstream fragments, with
    per-producer string dictionaries merged and codes remapped, merged
    and uploaded once for a streaming run's tiles (`remote_inputs`);
  - dynamic filters (exec/dynamic_filter.py) prune scan rows on the host
    before they reach the device.

Streaming tiles (exec/streaming.py) stage their inputs ahead: `preload`
loads the tile's leaves on the prefetch thread (host arrays, or the
on-device generation spec of a device-generated scan), and `preupload`
puts its scan lanes on the card on a side CUDA stream (generating them
there, or copying host arrays through page-locked memory), recording an
event the executing stream waits on before the tile's first use; the
tile then runs `execute(plan, scans)`.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..catalog import CatalogManager
from ..page import Page
from ..plan import nodes as P
from ..spi import Split
from .local import LocalExecutor
from .scan import (
    LoadedScan,
    LoadedScans,
    RemoteInputs,
    load_remote,
    load_table_scan,
    pages_bytes,
    plan_leaves,
)


class FragmentExecutor(LocalExecutor):
    """Executes one PlanFragment's local plan for one task."""

    def __init__(
        self,
        catalogs: CatalogManager,
        config: Optional[dict],
        splits_by_scan: Dict[int, List[Split]],
        remote_pages: Dict[int, List[Page]],
        dynamic_filters: Optional[Dict] = None,
        remote_inputs: Optional[RemoteInputs] = None,
    ):
        super().__init__(catalogs, config)
        self.splits_by_scan = splits_by_scan
        self.remote_pages = remote_pages
        # exchange buffers are held for the whole execution, so they
        # count toward this task's host reservation in _account_memory
        self.exchange_bytes = pages_bytes(remote_pages)
        # {(scan_preorder_index, symbol): [Domain]} from exec/dynamic_filter
        self.dynamic_filters = dynamic_filters or {}
        self.df_rows_pruned = 0
        self.remote_inputs = remote_inputs

    # ------------------------------------------------------------------
    def preload(self, plan: P.Output) -> LoadedScans:
        """Load this tile's leaves ahead of time (prefetch thread): split
        generation overlaps the previous tile's device work."""
        return self._load_scans(plan)

    def preupload(self, scans: LoadedScans, stream=None) -> None:
        """Generate or copy the lanes of this tile's scans on the device
        from the prefetch thread, staging them in `scans`.  On CUDA the
        copies run on `stream` (a side stream: a worker thread's current
        stream is the default one, where the copies would wait for the
        executing tile's kernels), and an event recorded after them
        orders the executing stream at the tile's first use
        (LoadedScan.lanes).  Remote sources are uploaded once per run by
        the executing thread (`remote_inputs`)."""
        cuda = self.device.type == "cuda" and stream is not None
        prof = self.kernel_profile
        for leaf in scans.leaves.values():
            if not isinstance(leaf.node, P.TableScan) or leaf.staged is not None:
                continue
            if cuda:
                with torch.cuda.stream(stream):
                    lanes = leaf.lanes(self)
                    event = torch.cuda.Event()
                    event.record(stream)
            else:
                lanes, event = leaf.lanes(self), None
            leaf.staged = (lanes, event)
            # lanes generated on the card are counted apart from copies
            key = "pregenerated_bytes" if leaf.generated else "preupload_bytes"
            prof["preuploads"] = prof.get("preuploads", 0) + 1
            prof[key] = prof.get(key, 0) + sum(
                v.numel() * v.element_size() + ok.numel() for v, ok in lanes.values()
            )

    # ------------------------------------------------------------------
    def _load_scans(self, plan: P.PlanNode) -> LoadedScans:
        """This task's leaves: a TableScan reads the splits assigned to it
        (by its place among the plan's scans), pruned by dynamic filters;
        a RemoteSource the pages of its upstream fragment."""
        scans = LoadedScans()
        idx = 0
        for node in plan_leaves(plan):
            if isinstance(node, P.RemoteSource):
                scans.add(load_remote(node, self.remote_pages.get(node.fragment_id, []),
                                      self.remote_inputs))
                continue
            leaf = scans.add(load_table_scan(self, node, self.splits_by_scan.get(idx, [])))
            self._apply_dynamic_filters(leaf, idx)
            idx += 1
        return scans

    def _apply_dynamic_filters(self, leaf: LoadedScan, scan_idx: int) -> None:
        """Prune loaded scan rows by build-side domains before upload (the
        DynamicFilter SPI's pushdown point: rows never reach the card)."""
        doms_by_sym = {
            sym: doms
            for (i, sym), doms in self.dynamic_filters.items()
            if i == scan_idx
        }
        n = leaf.rows
        if not doms_by_sym or n == 0:
            return
        if leaf.generated:
            # a device-generated scan has no host arrays to prune; the join
            # still drops the rows that do not match (dynamic filtering is
            # an optimization, never needed for the answer)
            return
        keep = np.ones(n, bool)
        for sym, doms in doms_by_sym.items():
            v, ok = leaf.arrays[sym]
            m = np.ones(n, bool)
            for d in doms:
                m &= d.keep_mask(v[:n], leaf.dicts.get(sym))
            if ok is not None:
                m &= ok[:n]  # NULL keys never match an inner equi-join
            keep &= m
        kept = int(keep.sum())
        if kept == n:
            return
        self.df_rows_pruned += n - kept
        idx = np.nonzero(keep)[0]
        leaf.arrays = {sym: (v[:n][idx], None if ok is None else ok[:n][idx])
                       for sym, (v, ok) in leaf.arrays.items()}
        leaf.rows = kept
        leaf.entry = leaf.store = None  # cached device lanes hold every row

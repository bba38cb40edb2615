"""Fragment execution: assigned splits and remote exchange inputs.

Counterpart of trino_tpu/exec/fragment_exec.py.  Reference parity:
execution/SqlTaskExecution.java:85 (splits -> drivers over one
fragment's operator chain) and operator/ExchangeOperator.java:44 (remote
source pages pulled from upstream tasks).  This subclass of the eager
executor only changes where leaf data comes from:

  - TableScans read only the splits assigned to this task;
  - RemoteSources read the pages of upstream fragments, with
    per-producer string dictionaries merged and codes remapped
    (merge_pages_to_arrays), cached per streaming run;
  - dynamic filters (exec/dynamic_filter.py) prune scan rows on the host
    before they reach the device.

Streaming tiles (exec/streaming.py) stage their inputs ahead: `preload`
loads the tile's scans on the prefetch thread (host arrays, or the
on-device generation spec of a device-generated scan), and `preupload`
puts its scan lanes on the card on a side CUDA stream (generating them
there, or copying host arrays through page-locked memory), recording an
event the executing stream waits on before the tile's first use.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..catalog import CatalogManager
from ..page import Page
from ..plan import nodes as P
from ..spi import Split
from .local import LocalExecutor, _LazyDeviceLane, merge_pages_to_arrays


class FragmentExecutor(LocalExecutor):
    """Executes one PlanFragment's local plan for one task."""

    def __init__(
        self,
        catalogs: CatalogManager,
        config: Optional[dict],
        splits_by_scan: Dict[int, List[Split]],
        remote_pages: Dict[int, List[Page]],
        dynamic_filters: Optional[Dict] = None,
    ):
        super().__init__(catalogs, config)
        self.splits_by_scan = splits_by_scan
        self.remote_pages = remote_pages
        # exchange buffers are held for the whole execution, so they
        # count toward this task's host reservation in _account_memory
        self.exchange_bytes = sum(
            int(np.asarray(c.values).nbytes)
            + (int(np.asarray(c.validity).nbytes) if c.validity is not None else 0)
            for pages in (remote_pages or {}).values()
            for p in pages
            for c in p.columns
        )
        # {(scan_preorder_index, symbol): [Domain]} from exec/dynamic_filter
        self.dynamic_filters = dynamic_filters or {}
        self.df_rows_pruned = 0
        self._preuploaded: Dict[int, tuple] = {}

    # ------------------------------------------------------------------
    def preload(self, plan: P.Output) -> None:
        """Load this tile's host arrays ahead of time (prefetch thread):
        split generation overlaps the previous tile's device work."""
        scans: Dict[int, dict] = {}
        dicts: Dict[str, np.ndarray] = {}
        counts: Dict[int, int] = {}
        self._load_scans(plan, scans, dicts, counts)
        self._preloaded = (plan, scans, dicts, counts)

    def preupload(self, plan: P.Output, stream=None) -> None:
        """Generate or copy this tile's scan lanes on the device from the
        prefetch thread.  On CUDA the copies run on `stream` (a side stream: a
        worker thread's current stream is the default one, where the
        copies would wait for the executing tile's kernels), and an
        event recorded after them orders the executing stream at the
        tile's first use (_device_lanes).  Remote sources are uploaded
        once per run by the executing thread (the run cache)."""
        if self._preloaded is None:
            return
        _plan, scans, _dicts, counts = self._preloaded
        nodes = {}

        def walk(n):
            if isinstance(n, P.TableScan):
                nodes[id(n)] = n
            for s in n.sources:
                walk(s)

        walk(plan)
        cuda = self.device.type == "cuda" and stream is not None
        for nid, arrays in scans.items():
            if nid not in nodes or nid in self._preuploaded:
                continue
            if cuda:
                with torch.cuda.stream(stream):
                    lanes = self._device_lanes(nodes[nid], arrays, counts[nid])
                    event = torch.cuda.Event()
                    event.record(stream)
            else:
                lanes, event = self._device_lanes(nodes[nid], arrays, counts[nid]), None
            self._preuploaded[nid] = (lanes, event)
            # lanes generated on the card are counted apart from copies
            generated = any(isinstance(v, _LazyDeviceLane) for v, _ok in arrays.values())
            key = "pregenerated_bytes" if generated else "preupload_bytes"
            prof = self.kernel_profile
            prof["preuploads"] = prof.get("preuploads", 0) + 1
            prof[key] = prof.get(key, 0) + sum(
                v.numel() * v.element_size() + ok.numel() for v, ok in lanes.values()
            )

    # ------------------------------------------------------------------
    def _load_scans(self, node: P.PlanNode, scans, dicts, counts):
        self._scan_idx = 0
        self._load_walk(node, scans, dicts, counts)

    def _load_walk(self, node: P.PlanNode, scans, dicts, counts):
        if isinstance(node, P.TableScan):
            idx = self._scan_idx
            self._scan_idx += 1
            self._load_one_scan(node, self.splits_by_scan.get(idx, []),
                                scans, dicts, counts)
            self._apply_dynamic_filters(node, idx, scans, dicts, counts)
            return
        if isinstance(node, P.RemoteSource):
            # streaming tiles read the same remote pages every tile: the
            # host merge and the device upload are cached per fragment id
            # for the run (a fresh cache object per run, shared by the
            # prefetch threads, so its check-then-put holds the run's lock)
            cache = getattr(self, "_streaming_cache", None)
            if cache is not None:
                with self._streaming_lock:
                    self._load_remote(node, scans, dicts, counts, cache)
            else:
                self._load_remote(node, scans, dicts, counts, None)
            return
        for s in node.sources:
            self._load_walk(s, scans, dicts, counts)

    def _load_remote(self, node: P.RemoteSource, scans, dicts, counts, cache):
        key = ("__remote__", node.fragment_id)
        hit = cache.get(key) if cache is not None else None
        if hit is not None:
            scans[id(node)] = dict(hit["merged"])
            dicts.update(hit["dicts"])
            counts[id(node)] = hit["total"]
            self._scan_keys[id(node)] = key
            return
        pages = self.remote_pages.get(node.fragment_id, [])
        local_dicts: Dict[str, np.ndarray] = {}
        merged, total = merge_pages_to_arrays(
            pages, node.symbols, node.types_, local_dicts
        )
        for s, t in node.types_:
            if t.is_dictionary and s not in local_dicts:
                local_dicts[s] = np.array([], dtype=object)
        dicts.update(local_dicts)
        scans[id(node)] = merged
        counts[id(node)] = total
        if cache is not None:
            nbytes = sum(
                int(v.nbytes) + (int(ok.nbytes) if ok is not None else 0)
                for v, ok in merged.values()
            )
            cache.put(key, {"merged": dict(merged), "dicts": local_dicts,
                            "total": total, "dev": {}}, nbytes)
            self._scan_keys[id(node)] = key

    def _apply_dynamic_filters(self, node, scan_idx, scans, dicts, counts):
        """Prune loaded scan rows by build-side domains before upload (the
        DynamicFilter SPI's pushdown point: rows never reach the card)."""
        doms_by_sym = {
            sym: doms
            for (i, sym), doms in self.dynamic_filters.items()
            if i == scan_idx
        }
        if not doms_by_sym:
            return
        arrays = scans[id(node)]
        n = counts[id(node)]
        if n == 0:
            return
        if any(isinstance(v, _LazyDeviceLane) for v, _ok in arrays.values()):
            # a device-generated scan has no host arrays to prune; the join
            # still drops the rows that do not match (dynamic filtering is
            # an optimization, never needed for the answer)
            return
        keep = np.ones(n, bool)
        for sym, doms in doms_by_sym.items():
            v, ok = arrays[sym]
            m = np.ones(n, bool)
            for d in doms:
                m &= d.keep_mask(v[:n], dicts.get(sym))
            if ok is not None:
                m &= ok[:n]  # NULL keys never match an inner equi-join
            keep &= m
        kept = int(keep.sum())
        if kept == n:
            return
        self.df_rows_pruned += n - kept
        idx = np.nonzero(keep)[0]
        for sym, (v, ok) in arrays.items():
            arrays[sym] = (v[:n][idx], None if ok is None else ok[:n][idx])
        counts[id(node)] = kept
        self._scan_keys[id(node)] = None  # cached device lanes hold every row

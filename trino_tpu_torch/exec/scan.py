"""The scan layer: how a plan leaf's columns reach the device.

Three types own it:
  - DeviceScanCache, the session's cache of table data across queries.
    Its CacheEntry holds one scan's columns by name (host arrays, or
    placeholders of lanes the connector generates on the device), their
    dictionaries, the row count, the generation spec or None, and the
    device lanes made from them;
  - LoadedScan, one plan leaf (TableScan or RemoteSource) for one run:
    its arrays and dictionaries by symbol, its rows, the entry it was
    bound to, and `lanes`, which puts its columns on the device;
  - LoadedScans, a run's leaves (one set a mesh shard), which the memory
    accounting, the kernel profile and the executor's dictionaries read.

`load_table_scan` reads one scan's splits (a `scan_load` span): from the
cache where the session keeps one, else generated on the device where
the connector can (connectors/tpch_device.py: no host array exists),
else read on the host with per-split dictionaries merged.  `load_remote`
merges an exchange input's pages; a streaming run merges and uploads
each once for all its tiles (RemoteInputs).  A leaf's lanes are made at
its first visit (`scan_generate` spans the generation), or ahead of it
by a streaming prefetch on a side stream (FragmentExecutor.preupload).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import device as D
from ..page import Column, Page
from ..plan import nodes as P
from ..utils.tracing import TRACER

Lane = Tuple[torch.Tensor, torch.Tensor]


class LazyDeviceLane:
    """Placeholder for a scan column that will be generated on the device
    (no host array exists).  Carries the byte size of the lane it becomes
    so memory accounting sees the device footprint."""

    __slots__ = ("nbytes",)

    def __init__(self, nbytes: int):
        self.nbytes = int(nbytes)


def lane_bytes(arrays) -> int:
    """Bytes of one scan's columns: host arrays, device-generated lanes by
    their size, validity lanes included."""
    return sum(int(v.nbytes) + (int(ok.nbytes) if ok is not None else 0)
               for v, ok in arrays.values())


@dataclasses.dataclass(eq=False)
class CacheEntry:
    """The data one scan reads, by column name.  `nbytes` (the cache's
    budget) counts `columns`; `lanes` are the device lanes made from them,
    which enter only through the store's `hold`."""

    columns: Dict[str, tuple]
    dicts: Dict[str, np.ndarray]
    rows: int
    spec: Optional[dict] = None
    lanes: Dict[str, Lane] = dataclasses.field(default_factory=dict)
    nbytes: int = 0


class DeviceScanCache:
    """Cross-query scan cache: host columns + device lanes, by column.

    An entry is the data one scan reads: its key is (catalog, table,
    splits, the connector's data version, device), never the constraint
    pushed into the scan nor its columns (pushdown reaches a cacheable
    connector's rows only through its splits).  It holds lanes by column
    and grows as later scans ask for more: a lookup hits only when every
    requested column is resident, and an entry's missing columns are
    made into it (`extend`, counted in `column_fills`) without reloading
    the others.  Entries evict in insertion order once the byte budget
    is exceeded: by default a quarter of the card's memory on CUDA (the
    lanes stay resident there beside the queries' working memory), 6 GiB
    of host arrays on the CPU.  Its hits, misses, puts and evictions are
    system.runtime.caches' scan_cache row."""

    def __init__(self, max_bytes: Optional[int] = None,
                 device: Optional[torch.device] = None):
        if max_bytes is None:
            max_bytes = 6 << 30
            if device is not None and device.type == "cuda":
                max_bytes = torch.cuda.get_device_properties(device).total_memory // 4
        self.max_bytes = max_bytes
        self.entries: Dict[tuple, CacheEntry] = {}
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.evictions = 0
        self.column_fills = 0

    def drop_all(self) -> int:
        """Evict everything; returns the bytes freed (the session's
        revocable listener: the scan cache goes first under pressure)."""
        freed = self.bytes
        self.evictions += len(self.entries)
        self.entries.clear()
        self.bytes = 0
        return freed

    def get(self, key: tuple, columns=()) -> Optional[CacheEntry]:
        """The entry of `key` or None.  A hit only when the entry holds
        every one of `columns`: an entry that lacks some is returned all
        the same, counted as a miss, for the caller to `extend`."""
        entry = self.entries.get(key)
        if entry is not None and all(c in entry.columns for c in columns):
            self.hits += 1
        else:
            self.misses += 1
        return entry

    def _make_room(self, nbytes: int, keep=None) -> None:
        """Evict the oldest entries but `keep` until `nbytes` more fit."""
        while self.bytes + nbytes > self.max_bytes:
            oldest = next((k for k in self.entries if k != keep), None)
            if oldest is None:
                return
            self.bytes -= self.entries.pop(oldest).nbytes
            self.evictions += 1

    def put(self, key: tuple, entry: CacheEntry) -> None:
        """Insert (or replace) the entry of `key`."""
        old = self.entries.pop(key, None)
        if old is not None:
            self.bytes -= old.nbytes
        entry.nbytes = lane_bytes(entry.columns)
        self._make_room(entry.nbytes)
        self.entries[key] = entry
        self.bytes += entry.nbytes
        self.puts += 1

    def extend(self, key: tuple, entry: CacheEntry, columns: dict,
               dicts: dict) -> None:
        """Add columns (and their `dicts`, by column name) to the entry
        `get` returned for `key`, evicting other entries, oldest first,
        to keep within the budget: never the entry itself."""
        entry.columns.update(columns)
        entry.dicts.update(dicts)
        self.column_fills += len(columns)
        if self.entries.get(key) is not entry:  # evicted meanwhile
            return
        nbytes = lane_bytes(columns)
        self._make_room(nbytes, keep=key)
        entry.nbytes += nbytes
        self.bytes += nbytes

    def hold(self, entry: CacheEntry, lanes: Dict[str, Lane]) -> None:
        """Keep device lanes (by column) made from `entry`'s columns."""
        entry.lanes.update(lanes)

    def stats(self) -> Dict[str, int]:
        return {
            "name": "scan_cache",
            "hits": self.hits,
            "misses": self.misses,
            "puts": self.puts,
            "evictions": self.evictions,
            "column_fills": self.column_fills,
            "entries": len(self.entries),
            "bytes": self.bytes,
            "max_bytes": self.max_bytes,
            "heals": 0,
            "invalidations": 0,
        }

    def evict_table(self, catalog: str, table: str) -> None:
        """Drop every scan of one table (after a write: its entries are
        keyed by the old data version and would only hold memory)."""
        for key in [k for k in self.entries if k[:2] == (catalog, table)]:
            self.bytes -= self.entries.pop(key).nbytes


class RemoteInputs:
    """A streaming run's exchange inputs, by upstream fragment id: each
    merged on the host and uploaded once for all of the run's tiles,
    whose prefetch threads share it under `lock`."""

    def __init__(self):
        self.lock = threading.Lock()
        self.entries: Dict[int, CacheEntry] = {}

    hold = DeviceScanCache.hold


@dataclasses.dataclass(eq=False)
class LoadedScan:
    """One plan leaf of one run: its arrays and dictionaries by symbol,
    its rows, the entry it was bound to (and the `store` holding it) or
    None, its device generation spec or None, and lanes a prefetch
    staged on a side stream with their event."""

    node: P.PlanNode
    arrays: Dict[str, tuple]
    dicts: Dict[str, np.ndarray]
    rows: int
    entry: Optional[CacheEntry] = None
    store: object = None
    spec: Optional[dict] = None
    staged: Optional[tuple] = None

    @property
    def generated(self) -> bool:
        return any(isinstance(v, LazyDeviceLane) for v, _ok in self.arrays.values())

    def lanes(self, ex) -> Dict[str, Lane]:
        """The leaf's lanes on `ex.device`, by symbol: the lanes a prefetch
        staged, else each column's lanes held in the entry, else every
        missing generated lane made in one pass, else a page-locked
        upload of the host array.  Lanes made here are held in the entry."""
        if self.staged is not None:
            # copied ahead on the prefetch thread's stream: order this
            # stream after the copies, and tell the caching allocator the
            # tensors are used here
            lanes, event = self.staged
            self.staged = None
            if event is not None:
                stream = torch.cuda.current_stream(ex.device)
                stream.wait_event(event)
                for v, ok in lanes.values():
                    v.record_stream(stream)
                    ok.record_stream(stream)
            return lanes
        col_of = dict(getattr(self.node, "assignments", ()))
        held = self.entry.lanes if self.entry is not None else {}
        lazy = [s for s, (a, _ok) in self.arrays.items()
                if isinstance(a, LazyDeviceLane) and col_of.get(s, s) not in held]
        generated = generate(ex, self.spec, lazy, col_of) if lazy else {}
        lanes, made = {}, {}
        for sym, (arr, valid) in self.arrays.items():
            col = col_of.get(sym, sym)
            if col in held:
                lanes[sym] = held[col]
                continue
            if sym in generated:
                lane = generated[sym]
            else:
                v = D.to_device(arr, ex.device, pin=True)
                lane = (v, torch.ones(self.rows, dtype=torch.bool, device=ex.device)
                        if valid is None else D.to_device(valid, ex.device, pin=True))
            lanes[sym] = made[col] = lane
        if made and self.entry is not None:
            self.store.hold(self.entry, made)
        return lanes


class LoadedScans:
    """The leaves one run reads, by id(node), and their dictionaries by
    symbol (the executor's `dicts`).  A mesh's run holds one set a shard
    in `shards`, its dictionaries unified across them."""

    def __init__(self, shards: Optional[List["LoadedScans"]] = None):
        self.leaves: Dict[int, LoadedScan] = {}
        self.dicts: Dict[str, np.ndarray] = {}
        self.shards = shards or []

    def add(self, leaf: LoadedScan) -> LoadedScan:
        self.leaves[id(leaf.node)] = leaf
        self.dicts.update(leaf.dicts)
        return leaf

    def each(self):
        yield from self.leaves.values()
        for shard in self.shards:
            yield from shard.each()

    def nbytes(self) -> int:
        """The scan working set: every leaf's columns, generated lanes by
        their size."""
        return sum(lane_bytes(leaf.arrays) for leaf in self.each())

    def upload_bytes(self) -> int:
        """The host arrays' bytes (generated lanes copy nothing)."""
        return sum(lane_bytes(leaf.arrays) for leaf in self.each() if not leaf.generated)

    def rows(self) -> int:
        return sum(int(leaf.rows) for leaf in self.each())


def plan_leaves(plan: P.PlanNode) -> List[P.PlanNode]:
    """The plan's TableScans and RemoteSources in preorder."""
    out: List[P.PlanNode] = []

    def walk(node: P.PlanNode):
        if isinstance(node, (P.TableScan, P.RemoteSource)):
            out.append(node)
            return
        for s in node.sources:
            walk(s)

    walk(plan)
    return out


def table_scans(plan: P.PlanNode) -> List[P.TableScan]:
    """The plan's TableScans in preorder: a scan's place here keys the
    splits a task assigns it (`splits_by_scan`) and its dynamic filters."""
    return [n for n in plan_leaves(plan) if isinstance(n, P.TableScan)]


# ---------------------------------------------------------------------------
# loading


def load_table_scan(ex, node: P.TableScan, splits, device=None) -> LoadedScan:
    """Load the splits of one scan for `device` (default the executor's),
    cached across queries for versioned connectors.  One `scan_load`
    span: its `table`, its `rows`, `cache` (hit, miss, or uncached where
    no cache or key applies) and, where the columns a cached entry lacked
    were made into it, `filled`."""
    with TRACER.span("scan_load", table=node.table, cache="uncached") as span:
        leaf = _read(ex, node, splits, device or ex.device, span.attributes)
        span.attributes["rows"] = int(leaf.rows)
    return leaf


def cache_key(catalogs, node: P.TableScan, splits, device):
    """The identity of the data a scan reads.  Neither its columns (an
    entry holds lanes by column) nor its pushed-down constraint: a
    cacheable connector's rows depend on that only through `splits`,
    whose reprs tell a pruned split list, and a worker's or a shard's
    share, apart.  `evict_table` matches the first two elements."""
    conn = catalogs.get(node.catalog)
    if not getattr(conn, "cacheable", False):
        return None
    return (
        node.catalog,
        node.table,
        tuple(repr(sp) for sp in splits),
        conn.data_version(node.table),
        str(device),
    )


def _read(ex, node: P.TableScan, splits, device, attrs) -> LoadedScan:
    cache: Optional[DeviceScanCache] = ex.config.get("scan_cache")
    key = cache_key(ex.catalogs, node, splits, device) if cache is not None else None
    cols = list(dict.fromkeys(c for _, c in node.assignments))
    if key is None:
        return bind(node, *load_columns(ex, node, splits, cols))
    entry = cache.get(key, columns=cols)
    missing = [c for c in cols if entry is None or c not in entry.columns]
    # the lookup that counts the hit or miss names it
    attrs["cache"] = "miss" if missing else "hit"
    loaded = None
    if entry is not None and missing:
        # the missing columns, made the way the entry's others were: on
        # the device from its counted ranges, or read on the host
        fill = (host_columns(ex, node, splits, missing) if entry.spec is None
                else device_columns(ex, node, splits, missing, entry.spec["ranges"]))
        if fill is not None and fill[2] == entry.rows:
            cache.extend(key, entry, fill[0], fill[1])
            attrs["filled"] = len(missing)
        else:
            # the entry's way cannot make them (generated on the device, a
            # column only the host formats): the host reads the scan
            # anew, and that replaces the entry
            entry, loaded = None, host_columns(ex, node, splits, cols)
    if entry is None:
        entry = CacheEntry(*(loaded or load_columns(ex, node, splits, cols)))
        cache.put(key, entry)
    return bind(node, entry.columns, entry.dicts, entry.rows, entry.spec, entry, cache)


def _symbols(node: P.TableScan) -> Dict[str, str]:
    """Each column's symbol (the first that assigns it)."""
    sym_of: Dict[str, str] = {}
    for s, c in node.assignments:
        sym_of.setdefault(c, s)
    return sym_of


def bind(node: P.TableScan, columns, dicts, rows, spec=None, entry=None,
         store=None) -> LoadedScan:
    """The scan's own columns (and dictionaries, by column name) bound to
    its symbols, in a fresh dict of arrays: dynamic filters prune that,
    never a cached entry."""
    tmap = dict(node.types)
    arrays, ldicts = {}, {}
    for c, s in _symbols(node).items():
        arrays[s] = columns[c]
        if c in dicts:
            ldicts[s] = dicts[c]
        elif tmap[s].is_dictionary:
            ldicts[s] = np.array([], dtype=object)
    return LoadedScan(node, arrays, ldicts, rows, entry, store, spec)


def load_columns(ex, node: P.TableScan, splits, cols):
    """(columns, dictionaries, row count, device generation spec or None)
    of a scan's columns by name: generated on the device where the
    connector can, else read on the host."""
    return (device_columns(ex, node, splits, cols)
            or host_columns(ex, node, splits, cols))


def host_columns(ex, node: P.TableScan, splits, cols):
    """Read columns from the connector's page sources into host arrays
    by column name, merging per-split dictionaries."""
    provider = ex.catalogs.get(node.catalog).page_source_provider()
    tmap = dict(node.types)
    pages: List[Page] = []
    for sp in splits:
        src = provider.create_page_source(sp, cols)
        for page in src.pages():
            src_dicts = src.dictionaries()
            new_cols = [
                Column(col.type, col.values, col.validity,
                       col.dictionary if col.dictionary is not None
                       else src_dicts.get(c))
                for c, col in zip(page.names, page.columns)
            ]
            pages.append(Page(new_cols, page.count, list(page.names)))
    sym_of = _symbols(node)
    types = [(c, tmap[sym_of[c]]) for c in cols]
    ldicts: Dict[str, np.ndarray] = {}
    merged, total = merge_pages_to_arrays(pages, cols, types, ldicts)
    for c, t in types:
        if t.is_dictionary and c not in ldicts:
            ldicts[c] = np.array([], dtype=object)
    return merged, ldicts, total, None


def device_columns(ex, node: P.TableScan, splits, cols, ranges=None):
    """On-device scan materialization: when the connector makes every
    requested column as a pure function of the row index
    (connectors/tpch_device.py), no host array is made; each column is a
    placeholder that LoadedScan.lanes generates on the device.  `ranges`
    (a cached spec's) spares the connector counting rows again.  None
    where generation is off or the connector cannot make a column (its
    `supports`): that scan takes the host generator, counted as
    hostGeneratedScans.  A generator that fails raises."""
    devgen_fn = getattr(ex.catalogs.get(node.catalog), "device_generation", None)
    if devgen_fn is None or not ex.config.get("device_generation", True):
        return None
    spec = devgen_fn(node.table, cols, splits, ranges=ranges)
    prof = ex.kernel_profile
    if spec is None:
        prof["hostGeneratedScans"] = prof.get("hostGeneratedScans", 0) + 1
        return None
    prof["deviceGeneratedScans"] = prof.get("deviceGeneratedScans", 0) + 1
    count = int(spec["count"])
    columns = {c: (LazyDeviceLane(count * spec["widths"].get(c, 8)), None)
               for c in cols}
    return columns, dict(spec["dicts"]), count, spec


def generate(ex, spec: dict, syms, col_of) -> Dict[str, Lane]:
    """Run the connector's on-device generator for the columns of `syms`
    on `ex.device` (one `scan_generate` span); {symbol: lane}."""
    from ..connectors import tpch_device
    from .streaming import DEVGEN_TEMP_LANES

    cols = [col_of.get(s, s) for s in syms]
    ex._devgen_temp_bytes += int(spec["count"]) * 8 * DEVGEN_TEMP_LANES
    with TRACER.span("scan_generate", table=spec["table"],
                     rows=int(spec["count"]), columns=",".join(cols)):
        parts = [
            tpch_device.device_lanes(
                spec["table"], cols, int(lo), int(hi), float(spec["sf"]),
                int(n), ex.device,
            )
            for lo, hi, n in spec["ranges"]
        ]
        if len(parts) == 1:
            lanes = parts[0]
        else:  # the splits' contiguous runs, in split order
            lanes = {
                c: (torch.cat([p[c][0] for p in parts]),
                    torch.cat([p[c][1] for p in parts]))
                for c in cols
            }
    return {s: lanes[c] for s, c in zip(syms, cols)}


def load_remote(node: P.RemoteSource, pages,
                inputs: Optional[RemoteInputs] = None) -> LoadedScan:
    """An exchange input: the upstream fragment's pages merged on the
    host, per-producer dictionaries unified.  A streaming run's `inputs`
    merge each fragment's once for all its tiles, and keep its lanes."""
    if inputs is None:
        e = _merge_remote(node, pages)
        return LoadedScan(node, e.columns, e.dicts, e.rows)
    with inputs.lock:
        e = inputs.entries.get(node.fragment_id)
        if e is None:
            e = inputs.entries[node.fragment_id] = _merge_remote(node, pages)
    return LoadedScan(node, dict(e.columns), e.dicts, e.rows, e, inputs)


def pages_bytes(pages_by_fragment) -> int:
    """Host bytes of a task's fetched exchange pages, validity included."""
    return sum(
        int(np.asarray(c.values).nbytes)
        + (int(np.asarray(c.validity).nbytes) if c.validity is not None else 0)
        for pages in (pages_by_fragment or {}).values()
        for p in pages
        for c in p.columns
    )


def _merge_remote(node: P.RemoteSource, pages) -> CacheEntry:
    dicts: Dict[str, np.ndarray] = {}
    merged, total = merge_pages_to_arrays(pages, node.symbols, node.types_, dicts)
    for s, t in node.types_:
        if t.is_dictionary and s not in dicts:
            dicts[s] = np.array([], dtype=object)
    return CacheEntry(merged, dicts, total)


def _valid_of(col: Column, n: int) -> np.ndarray:
    return (
        np.ones(n, bool)
        if col.validity is None
        else np.asarray(col.validity)[:n]
    )


def merge_pages_to_arrays(pages, symbols, types, dicts):
    """Concatenate pages column-wise into host arrays; varchar
    dictionaries from different splits are merged with codes remapped.
    Fast path: pages sharing one dictionary pass codes through."""
    tmap = dict(types)
    merged = {}
    total = sum(p.count for p in pages)
    for sym in symbols:
        t = tmap[sym]
        vals_parts: List[np.ndarray] = []
        ok_parts: List[np.ndarray] = []
        live = [p for p in pages if p.count > 0]
        if t.is_dictionary:
            page_dicts = []
            for p in live:
                d = p.by_name(sym).dictionary
                if d is None:
                    from .local import ExecutionError

                    raise ExecutionError(f"varchar column {sym} without dict")
                page_dicts.append(d)
            shared = all(
                d is page_dicts[0] or np.array_equal(page_dicts[0], d)
                for d in page_dicts[1:]
            )
            if shared:
                dicts[sym] = (
                    page_dicts[0] if page_dicts else np.array([], dtype=object)
                )
                for p in live:
                    col = p.by_name(sym)
                    vals_parts.append(
                        np.asarray(col.values)[: p.count].astype(np.int32)
                    )
                    ok_parts.append(_valid_of(col, p.count))
            else:
                index: Dict[str, int] = {}
                entries: List[str] = []
                for p, d in zip(live, page_dicts):
                    col = p.by_name(sym)
                    codes = np.asarray(col.values)[: p.count]
                    # an all-NULL page's dictionary is empty: its codes
                    # map to no entry (-1)
                    remap = np.full(max(len(d), 1), -1, dtype=np.int32)
                    for i, s in enumerate(d):
                        s = str(s)
                        if s not in index:
                            index[s] = len(entries)
                            entries.append(s)
                        remap[i] = index[s]
                    safe = np.clip(codes, 0, max(len(d) - 1, 0))
                    vals_parts.append(
                        np.where(codes >= 0, remap[safe], -1).astype(np.int32)
                    )
                    ok_parts.append(_valid_of(col, p.count))
                dicts[sym] = np.array(entries, dtype=object)
        else:
            for p in live:
                col = p.by_name(sym)
                vals_parts.append(np.asarray(col.values)[: p.count])
                ok_parts.append(_valid_of(col, p.count))
        if vals_parts:
            vals = np.concatenate(vals_parts)
            ok = np.concatenate(ok_parts)
        else:
            vals = np.zeros(0, dtype=t.np_dtype)
            ok = np.zeros(0, dtype=bool)
        merged[sym] = (vals, None if ok.all() else ok)
    return merged, total

"""Lakehouse connector: snapshot table format on the object store.

Counterpart of trino_tpu/connectors/lakehouse.py, copied but for the
sink, which builds each data file's arrays from the appended pages'
lanes (connectors/memory.rebuild_column, equal to column_from_pylist
over their Python values) instead of one Python object per value, so the
files equal the JAX package's array for array.  Its counters and the
commit-latency histogram carry the JAX package's names and labels, and
``snapshots_rows`` feeds ``system.runtime.snapshots``.

Reference parity: plugin/trino-iceberg reduced to its load-bearing core —
a table is (1) immutable data files, (2) per-snapshot manifests listing
them, and (3) ONE mutable object, the metadata pointer, replaced only by
compare-and-swap.  Everything ACID about Iceberg follows from that
split: writers prepare a whole new snapshot out of line (new data files,
new manifest, new metadata document) and then race a single CAS; the
loser journals ``SNAPSHOT_CONFLICT``, re-reads the winner's metadata and
retries with its already-written data files (they are immutable, so
re-use is safe), which is exactly Iceberg's optimistic-concurrency
commit loop.

Time travel: every committed snapshot stays addressable.  ``FOR VERSION
AS OF n`` / ``FOR TIMESTAMP AS OF t`` resolve to a snapshot id in the
analyzer (via :meth:`LakehouseMetadata.resolve_snapshot`) and pin the
scan by suffixing the table handle — ``"orders@3"`` — so splits, page
sources, statistics and ``data_version`` all key on the pinned snapshot
with no new plumbing.  ``data_version`` of an unpinned table IS its
current snapshot id, which makes the fragment result cache and the
stats sidecars invalidate per-snapshot for free.

Data files are numpy ``.npz`` objects (no parquet dependency): per
column the value array (2-D for wide decimals), optional validity, and
optional varchar dictionary.  The engine merges divergent per-split
dictionaries already (exec/scan.host_columns), so each file keeps the
dictionary it was written with.

Chaos composes: the store underneath carries the ``objstore_*`` fault
sites, and the commit loop exposes ``lake_commit_crash`` — a kill-point
BETWEEN data-file write and metadata CAS, honored only in sacrificial
subprocess writers (``TRINO_TPU_CRASH_FAULTS=1``) — so crash tests can
prove torn commits are invisible: the pointer still names the old
metadata, the table reads at the prior snapshot, and the orphaned data
files are detectable by :meth:`LakehouseConnector.orphaned_files`.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import time
import uuid
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import types as T
from ..fs import LocalObjectStore, ObjectStoreError
from ..obs import journal
from ..page import Column, Page, column_from_pylist
from .memory import rebuild_column
from ..spi import (
    ColumnSchema,
    ColumnStatistics,
    Connector,
    ConnectorFactory,
    ConnectorMetadata,
    PageSink,
    PageSinkProvider,
    PageSource,
    PageSourceProvider,
    Split,
    SplitManager,
    TableSchema,
    TableStatistics,
)
from ..utils.metrics import counter, histogram

# snapshot wire schema (system.runtime.snapshots detail + metadata JSON)
SNAPSHOT_FIELDS = (
    "snapshotId",
    "parentId",
    "ts",
    "operation",
    "manifest",
    "dataFiles",
    "rows",
)

MAX_COMMIT_RETRIES = 10


def _split_handle(handle: str) -> Tuple[str, Optional[int]]:
    """``"orders@3"`` -> ("orders", 3); ``"orders"`` -> ("orders", None)."""
    if "@" in handle:
        name, _, snap = handle.rpartition("@")
        return name, int(snap)
    return handle, None


def _ptr_key(table: str) -> str:
    return f"{table}/metadata/ptr"


def _now_us() -> int:
    return time.time_ns() // 1000


class _TableState:
    """One consistent read of a table: the pointer bytes it was loaded
    from (the CAS expectation) plus the decoded metadata document."""

    def __init__(self, ptr: bytes, meta: dict):
        self.ptr = ptr
        self.meta = meta

    @property
    def current(self) -> int:
        return int(self.meta["currentSnapshotId"])

    def snapshot(self, snap_id: int) -> dict:
        for s in self.meta["snapshots"]:
            if int(s["snapshotId"]) == snap_id:
                return s
        raise ValueError(
            f"no snapshot {snap_id} for table {self.meta['table']} "
            f"(history: {[s['snapshotId'] for s in self.meta['snapshots']]})"
        )

    def schema(self) -> TableSchema:
        return TableSchema(
            self.meta["table"],
            tuple(
                ColumnSchema(n, T.parse_type(t))
                for n, t in self.meta["schema"]
            ),
        )


def _load_state(fs, table: str) -> _TableState:
    ptr = fs.read_file(_ptr_key(table))
    meta = json.loads(
        fs.read_file(f"{table}/metadata/{ptr.decode('ascii')}")
    )
    return _TableState(ptr, meta)


def _read_manifest(fs, table: str, snap: dict) -> List[dict]:
    return json.loads(
        fs.read_file(f"{table}/metadata/{snap['manifest']}")
    )["files"]


# -- data files: numpy .npz column serialization -----------------------
def _encode_data_file(schema: TableSchema, data: Dict[str, Column],
                      rows: int) -> bytes:
    """Columns -> one .npz object (immutable data file)."""
    arrays: Dict[str, np.ndarray] = {}
    for c in schema.columns:
        col = data[c.name]
        arrays[f"v.{c.name}"] = np.asarray(col.values)
        if col.validity is not None:
            arrays[f"k.{c.name}"] = np.asarray(col.validity)
        if col.dictionary is not None:
            # <U serialization round-trips strings without pickle
            arrays[f"d.{c.name}"] = np.asarray(
                [str(x) for x in col.dictionary], dtype=str
            )
    arrays["rows"] = np.array([rows], dtype=np.int64)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _decode_data_file(schema: TableSchema, blob: bytes, columns) -> Page:
    """One data file's page of a scan's `columns` (the file's other
    arrays stay unread)."""
    schema = TableSchema(schema.name, tuple(
        c for c in schema.columns if c.name in set(columns)))
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        rows = int(z["rows"][0])
        cols = []
        for c in schema.columns:
            values = z[f"v.{c.name}"]
            validity = z[f"k.{c.name}"] if f"k.{c.name}" in z else None
            dictionary = None
            if f"d.{c.name}" in z:
                raw = z[f"d.{c.name}"]
                dictionary = np.empty(len(raw), dtype=object)
                for i, s in enumerate(raw):
                    dictionary[i] = str(s)
            cols.append(Column(c.type, values, validity, dictionary))
    return Page(cols, rows, list(schema.column_names()))


def _empty_page(schema: TableSchema) -> Page:
    cols = [column_from_pylist(c.type, []) for c in schema.columns]
    return Page(cols, 0, list(schema.column_names()))


class LakehouseMetadata(ConnectorMetadata):
    def __init__(self, conn: "LakehouseConnector"):
        self.conn = conn
        self.fs = conn.fs

    def list_tables(self) -> List[str]:
        out = []
        for e in self.fs.list_files():
            parts = e.path.split("/")
            if parts[-2:] == ["metadata", "ptr"]:
                out.append("/".join(parts[:-2]))
        return sorted(out)

    def _state(self, handle: str) -> Tuple[_TableState, Optional[int]]:
        name, pinned = _split_handle(handle)
        try:
            return _load_state(self.fs, name), pinned
        except ObjectStoreError:
            raise KeyError(f"table {name} does not exist") from None

    def get_table_schema(self, table: str) -> TableSchema:
        state, _ = self._state(table)
        return state.schema()

    def get_table_statistics(self, table: str) -> TableStatistics:
        state, pinned = self._state(table)
        snap = pinned if pinned is not None else state.current
        name, _ = _split_handle(table)
        try:
            raw = json.loads(
                self.fs.read_file(f"{name}/metadata/stats-{snap}.json")
            )
            return _stats_from_json(raw)
        except ObjectStoreError:
            return TableStatistics(
                float(state.snapshot(snap)["rows"]), {}
            )

    def store_table_statistics(
        self, table: str, stats: TableStatistics, data_version: int
    ) -> None:
        """ANALYZE sidecar keyed BY SNAPSHOT (data_version == snapshot
        id here): stats written at snapshot N are served only for reads
        pinned at N or while N is still current — a later write moves
        the pointer and the stale sidecar becomes unaddressable."""
        name, _ = _split_handle(table)
        self.fs.write_file(
            f"{name}/metadata/stats-{int(data_version)}.json",
            json.dumps(_stats_to_json(stats)).encode(),
        )

    # -- time travel ----------------------------------------------------
    def resolve_snapshot(self, table: str, kind: str, value) -> int:
        """Resolve FOR VERSION|TIMESTAMP AS OF to a snapshot id; the
        analyzer turns ValueError into a SemanticError at the query."""
        state, _ = self._state(table)
        counter("trino_tpu_lake_time_travel_total").inc(kind=kind)
        if kind == "version":
            snap = int(value)
            state.snapshot(snap)  # raises ValueError if unknown
            return snap
        # timestamp: latest snapshot committed at or before the bound
        bound = _timestamp_us(value)
        best = None
        for s in state.meta["snapshots"]:
            if int(s["ts"]) <= bound and (
                best is None or int(s["snapshotId"]) > best
            ):
                best = int(s["snapshotId"])
        if best is None:
            raise ValueError(
                f"no snapshot of {state.meta['table']} at or before "
                f"timestamp {value!r} (oldest is "
                f"ts={state.meta['snapshots'][0]['ts']})"
            )
        return best

    # -- DDL -------------------------------------------------------------
    def create_table(self, schema: TableSchema) -> None:
        table = schema.name
        # same per-attempt token as the commit loop: two racing CREATEs
        # must not overwrite each other's snapshot-0 documents (the CAS
        # on the pointer picks the winner; the loser's files are inert)
        token = uuid.uuid4().hex[:8]
        manifest = f"manifest-0-{token}.json"
        self.fs.write_file(
            f"{table}/metadata/{manifest}",
            json.dumps({"snapshotId": 0, "files": []}).encode(),
        )
        meta = {
            "formatVersion": 1,
            "table": table,
            "schema": [[c.name, str(c.type)] for c in schema.columns],
            "currentSnapshotId": 0,
            "snapshots": [
                {
                    "snapshotId": 0,
                    "parentId": None,
                    "ts": _now_us(),
                    "operation": "create",
                    "manifest": manifest,
                    "dataFiles": 0,
                    "rows": 0,
                }
            ],
        }
        meta_name = f"v0-{token}.json"
        self.fs.write_file(
            f"{table}/metadata/{meta_name}", json.dumps(meta).encode()
        )
        if not self.fs.compare_and_swap(
            _ptr_key(table), None, meta_name.encode()
        ):
            raise ValueError(f"table {table} already exists")

    def drop_table(self, table: str) -> None:
        name, _ = _split_handle(table)
        entries = self.fs.list_files(name)
        if not any(e.path == _ptr_key(name) for e in entries):
            raise KeyError(f"table {name} does not exist")
        for e in entries:
            self.fs.delete_file(e.path)


def _stats_to_json(stats: TableStatistics) -> dict:
    return {
        "rowCount": stats.row_count,
        # the JAX package's encoding: ANALYZE's bounds are value units
        "columns": {
            name: {k: v for k, v in dataclasses.asdict(cs).items()
                   if k != "decimal_lanes"}
            for name, cs in stats.columns.items()
        },
    }


def _stats_from_json(raw: dict) -> TableStatistics:
    cols = {}
    for name, cs in raw.get("columns", {}).items():
        hist = cs.get("histogram")
        cols[name] = ColumnStatistics(
            distinct_count=cs.get("distinct_count"),
            null_fraction=cs.get("null_fraction", 0.0),
            min_value=cs.get("min_value"),
            max_value=cs.get("max_value"),
            histogram=(
                tuple(tuple(b) for b in hist) if hist else None
            ),
        )
    return TableStatistics(float(raw["rowCount"]), cols)


def _timestamp_us(value) -> int:
    """FOR TIMESTAMP AS OF operand -> epoch microseconds.  Accepts the
    engine's timestamp representation (int us) or a literal string."""
    if isinstance(value, (int, np.integer)):
        return int(value)
    return int(
        (
            np.datetime64(str(value).strip().replace(" ", "T"), "us")
            - np.datetime64("1970-01-01", "us")
        ).astype(np.int64)
    )


class LakehouseSplitManager(SplitManager):
    def __init__(self, conn: "LakehouseConnector"):
        self.conn = conn

    def get_splits(
        self, table: str, desired: int, constraint=None
    ) -> List[Split]:
        name, pinned = _split_handle(table)
        state = _load_state(self.conn.fs, name)
        snap = state.snapshot(
            pinned if pinned is not None else state.current
        )
        files = _read_manifest(self.conn.fs, name, snap)
        schema_wire = state.meta["schema"]
        if not files:
            return [
                Split(table, 0, 1, {"path": None, "schema": schema_wire})
            ]
        return [
            Split(
                table, i, len(files),
                {
                    "path": f["path"],
                    "rows": f["rows"],
                    "schema": schema_wire,
                },
            )
            for i, f in enumerate(files)
        ]


class LakehousePageSource(PageSource):
    """One data file per split; dictionaries are per-file and the engine
    remaps codes when merging splits."""

    def __init__(self, conn: "LakehouseConnector", split: Split,
                 columns: Sequence[str]):
        self.conn = conn
        self.split = split
        self.columns = list(columns)
        self._dicts: Dict[str, np.ndarray] = {}

    def pages(self):
        schema = TableSchema(
            _split_handle(self.split.table)[0],
            tuple(
                ColumnSchema(n, T.parse_type(t))
                for n, t in self.split.info["schema"]
            ),
        )
        path = self.split.info.get("path")
        if path is None:
            page = _empty_page(schema)
        else:
            page = _decode_data_file(
                schema, self.conn.fs.read_file(path), self.columns
            )
        cols = [page.by_name(c) for c in self.columns]
        for c, col in zip(self.columns, cols):
            if col.dictionary is not None:
                self._dicts[c] = col.dictionary
        yield Page(cols, page.count, self.columns)

    def dictionaries(self) -> Dict[str, np.ndarray]:
        return dict(self._dicts)


class LakehousePageSourceProvider(PageSourceProvider):
    def __init__(self, conn: "LakehouseConnector"):
        self.conn = conn

    def create_page_source(self, split: Split, columns):
        return LakehousePageSource(self.conn, split, columns)


class LakehousePageSink(PageSink):
    """The optimistic-concurrency commit loop (Iceberg
    SnapshotProducer.commit analog).  Data files written once, metadata
    raced via CAS, loser re-reads and retries with the same files."""

    def __init__(self, conn: "LakehouseConnector", table: str,
                 columns, overwrite: bool):
        self.conn = conn
        self.table = table
        self.columns = list(columns)
        self.overwrite = overwrite
        self.pages: List[Page] = []
        self.rows = 0

    def append(self, page: Page) -> None:
        self.pages.append(page)
        self.rows += page.count

    def finish(self) -> int:
        t0 = time.perf_counter()
        fs = self.conn.fs
        state = _load_state(fs, self.table)
        schema = state.schema()

        # 1. write the immutable data file ONCE, out of line — CAS
        #    losers reuse it across retries (immutability makes reuse
        #    safe; a crashed writer just leaves it orphaned)
        new_file: Optional[dict] = None
        if self.rows:
            data: Dict[str, Column] = {}
            for c in schema.columns:
                if c.name in self.columns:
                    pieces = [(p.by_name(c.name), p.count) for p in self.pages]
                else:
                    pieces = [(None, self.rows)]  # unmentioned -> NULL
                data[c.name] = rebuild_column(c.type, pieces)
            blob = _encode_data_file(schema, data, self.rows)
            path = (
                f"{self.table}/data/{uuid.uuid4().hex}.npz"
            )
            fs.write_file(path, blob)
            counter("trino_tpu_lake_written_bytes").inc(len(blob))
            new_file = {"path": path, "rows": self.rows}

        op = "overwrite" if self.overwrite else "append"
        for attempt in range(MAX_COMMIT_RETRIES):
            snap_id = state.current + 1
            self.conn.maybe_crash(f"{self.table}:{snap_id}")

            # 2. prepare the new snapshot's manifest + metadata document.
            #    Both filenames carry a per-attempt token (Iceberg's
            #    <version>-<uuid>.metadata.json): two writers racing to
            #    the same snapshot id must never collide on a filename,
            #    or the CAS loser's overwrite would replace the document
            #    the winner's pointer references
            token = uuid.uuid4().hex[:8]
            base_files = (
                []
                if self.overwrite
                else _read_manifest(
                    fs, self.table, state.snapshot(state.current)
                )
            )
            files = base_files + ([new_file] if new_file else [])
            manifest = f"manifest-{snap_id}-{token}.json"
            fs.write_file(
                f"{self.table}/metadata/{manifest}",
                json.dumps(
                    {"snapshotId": snap_id, "files": files}
                ).encode(),
            )
            meta = dict(state.meta)
            meta["currentSnapshotId"] = snap_id
            meta["snapshots"] = list(state.meta["snapshots"]) + [
                {
                    "snapshotId": snap_id,
                    "parentId": state.current,
                    "ts": _now_us(),
                    "operation": op,
                    "manifest": manifest,
                    "dataFiles": len(files),
                    "rows": sum(int(f["rows"]) for f in files),
                }
            ]
            meta_name = f"v{snap_id}-{token}.json"
            fs.write_file(
                f"{self.table}/metadata/{meta_name}",
                json.dumps(meta).encode(),
            )

            # 3. race the pointer
            if fs.compare_and_swap(
                _ptr_key(self.table), state.ptr,
                meta_name.encode(),
            ):
                counter("trino_tpu_lake_commits_total").inc(op=op)
                histogram("trino_tpu_lake_commit_seconds").observe(
                    time.perf_counter() - t0)
                return self.rows

            # lost the race: journal, re-read the winner, retry with the
            # SAME data file (it is immutable — only metadata re-derives)
            state = _load_state(fs, self.table)
            counter("trino_tpu_lake_conflicts_total").inc(op=op)
            journal.emit(
                journal.SNAPSHOT_CONFLICT,
                severity=journal.WARN,
                table=self.table,
                attempted=snap_id,
                winner=state.current,
                attempt=attempt + 1,
            )
        raise ObjectStoreError(
            f"commit to {self.table} lost the metadata CAS "
            f"{MAX_COMMIT_RETRIES} times; giving up"
        )


class LakehousePageSinkProvider(PageSinkProvider):
    def __init__(self, conn: "LakehouseConnector"):
        self.conn = conn

    def create_sink(self, table: str, columns, overwrite: bool = False):
        name, pinned = _split_handle(table)
        if pinned is not None:
            raise ValueError(
                f"cannot write to a pinned snapshot: {table}"
            )
        return LakehousePageSink(self.conn, name, columns, overwrite)


class LakehouseConnector(Connector):
    cacheable = True  # data_version == snapshot id: per-snapshot keys

    def __init__(self, name: str, fs: LocalObjectStore, injector=None):
        self.name = name
        self.fs = fs
        self.injector = injector

    def maybe_crash(self, key: str) -> None:
        """lake_commit_crash kill-point: only sacrificial subprocess
        writers honor it (see utils/faults.SITES) — firing it in-process
        would take the whole test runner down."""
        inj = self.injector
        if (
            inj is not None
            and os.environ.get("TRINO_TPU_CRASH_FAULTS") == "1"
            and inj.fires("lake_commit_crash", key)
        ):
            os._exit(137)

    # -- cache-invalidation SPI -----------------------------------------
    def data_version(self, table: Optional[str] = None) -> int:
        if table is not None:
            name, pinned = _split_handle(table)
            if pinned is not None:
                return pinned  # pinned scans never invalidate
            try:
                return _load_state(self.fs, name).current
            except ObjectStoreError:
                return 0
        # whole-catalog: content-derived digest over (table, snapshot)
        # pairs — process-stable, moves on any table's commit/drop
        h = hashlib.blake2b(digest_size=8)
        for t in self.metadata().list_tables():
            try:
                h.update(
                    f"{t}={_load_state(self.fs, t).current};".encode()
                )
            except ObjectStoreError:
                continue
        return int.from_bytes(h.digest(), "big") & (2**62 - 1)

    # -- maintenance / introspection ------------------------------------
    def snapshots_rows(self) -> List[tuple]:
        """system.runtime.snapshots feed: one row per committed snapshot
        of every table in this catalog."""
        out = []
        md = self.metadata()
        for t in md.list_tables():
            state = _load_state(self.fs, t)
            for s in state.meta["snapshots"]:
                out.append(
                    (
                        t,
                        int(s["snapshotId"]),
                        -1 if s["parentId"] is None
                        else int(s["parentId"]),
                        str(s["operation"]),
                        int(s["dataFiles"]),
                        int(s["rows"]),
                        int(s["snapshotId"]) == state.current,
                        int(s["ts"]),
                    )
                )
        return out

    def orphaned_files(self, table: str) -> List[str]:
        """Data files not referenced by any committed snapshot — what a
        crashed or still-in-flight writer leaves behind (Iceberg's
        remove_orphan_files procedure reduced to detection)."""
        name, _ = _split_handle(table)
        state = _load_state(self.fs, name)
        referenced = set()
        for s in state.meta["snapshots"]:
            for f in _read_manifest(self.fs, name, s):
                referenced.add(f["path"])
        return sorted(
            e.path
            for e in self.fs.list_files(f"{name}/data")
            if e.path not in referenced
        )

    def expire_snapshots(self, table: str, keep: int = 1) -> dict:
        """Prune snapshot history down to the newest ``keep`` snapshots
        (the current one always survives), reclaiming manifests and any
        data files only expired snapshots referenced — Iceberg's
        ``expire_snapshots`` procedure.

        The metadata change rides the SAME compare-and-swap commit
        protocol as writers: prepare a token-named metadata document
        with the pruned history, race the pointer, and on a lost CAS
        re-read the winner and retry — so maintenance is safe to run
        concurrently with appends.  Files are deleted only AFTER the CAS
        lands: until then every snapshot is still reachable, and the
        immutable loser documents are mere orphan metadata."""
        name, pinned = _split_handle(table)
        if pinned is not None:
            raise ValueError(
                f"cannot run maintenance on a pinned snapshot: {table}"
            )
        keep = max(int(keep), 1)
        fs = self.fs
        t0 = time.perf_counter()
        for attempt in range(MAX_COMMIT_RETRIES):
            state = _load_state(fs, name)
            snaps = list(state.meta["snapshots"])
            kept = snaps[-keep:]
            if not any(
                int(s["snapshotId"]) == state.current for s in kept
            ):
                kept = [
                    s for s in snaps
                    if int(s["snapshotId"]) == state.current
                ] + kept
            dropped = [s for s in snaps if s not in kept]
            if not dropped:
                return {
                    "table": name, "expiredSnapshots": 0,
                    "removedFiles": 0,
                    "currentSnapshotId": state.current,
                }
            kept_refs = {
                f["path"]
                for s in kept
                for f in _read_manifest(fs, name, s)
            }
            dropped_refs = {
                f["path"]
                for s in dropped
                for f in _read_manifest(fs, name, s)
            }
            token = uuid.uuid4().hex[:8]
            meta = dict(state.meta)
            meta["snapshots"] = kept
            meta_name = f"v{state.current}-{token}.json"
            fs.write_file(
                f"{name}/metadata/{meta_name}", json.dumps(meta).encode()
            )
            if fs.compare_and_swap(
                _ptr_key(name), state.ptr, meta_name.encode()
            ):
                removed = 0
                for s in dropped:
                    try:
                        fs.delete_file(
                            f"{name}/metadata/{s['manifest']}"
                        )
                    except ObjectStoreError:
                        pass
                for p in sorted(dropped_refs - kept_refs):
                    try:
                        fs.delete_file(p)
                        removed += 1
                    except ObjectStoreError:
                        pass
                counter("trino_tpu_lake_commits_total").inc(op="expire_snapshots")
                counter("trino_tpu_lake_expired_snapshots_total").inc(len(dropped))
                histogram("trino_tpu_lake_commit_seconds").observe(
                    time.perf_counter() - t0)
                journal.emit(
                    journal.SNAPSHOT_EXPIRED,
                    severity=journal.INFO,
                    table=name,
                    expired=len(dropped),
                    removedFiles=removed,
                    currentSnapshotId=state.current,
                )
                return {
                    "table": name,
                    "expiredSnapshots": len(dropped),
                    "removedFiles": removed,
                    "currentSnapshotId": state.current,
                }
            counter("trino_tpu_lake_conflicts_total").inc(op="expire_snapshots")
            journal.emit(
                journal.SNAPSHOT_CONFLICT,
                severity=journal.WARN,
                table=name,
                attempted=state.current,
                winner=_load_state(fs, name).current,
                attempt=attempt + 1,
            )
        raise ObjectStoreError(
            f"expire_snapshots on {name} lost the metadata CAS "
            f"{MAX_COMMIT_RETRIES} times; giving up"
        )

    def remove_orphan_files(
        self, table: str, older_than_s: float = 0.0
    ) -> dict:
        """Delete data files no committed snapshot references — what a
        crashed writer (or a CAS loser that never retried) leaves
        behind.  ``older_than_s`` is the in-flight-writer grace: a live
        writer's data file exists BEFORE its commit CAS lands, so
        production callers pass an age floor (Iceberg defaults to 3
        days); tests pass 0.

        Validation rides the commit protocol: after computing the
        orphan set the pointer is re-read, and if a concurrent commit
        moved it the scan restarts — a file that just became referenced
        must not be swept."""
        name, _ = _split_handle(table)
        fs = self.fs
        now_ns = time.time_ns()
        for attempt in range(MAX_COMMIT_RETRIES):
            state = _load_state(fs, name)
            referenced = set()
            for s in state.meta["snapshots"]:
                for f in _read_manifest(fs, name, s):
                    referenced.add(f["path"])
            candidates = [
                e for e in fs.list_files(f"{name}/data")
                if e.path not in referenced
                and (now_ns - e.mtime_ns) >= older_than_s * 1e9
            ]
            # pointer unchanged => no commit raced the scan; a moved
            # pointer may have promoted a candidate to referenced
            if fs.read_file(_ptr_key(name)) != state.ptr:
                continue
            removed = 0
            freed = 0
            for e in candidates:
                try:
                    fs.delete_file(e.path)
                    removed += 1
                    freed += int(e.size)
                except ObjectStoreError:
                    pass
            counter("trino_tpu_lake_orphans_removed_total").inc(removed)
            journal.emit(
                journal.ORPHANS_REMOVED,
                severity=journal.INFO,
                table=name,
                removedFiles=removed,
                freedBytes=freed,
            )
            return {
                "table": name, "removedFiles": removed,
                "freedBytes": freed,
            }
        raise ObjectStoreError(
            f"remove_orphan_files on {name} kept racing commits "
            f"{MAX_COMMIT_RETRIES} times; giving up"
        )

    def metadata(self) -> LakehouseMetadata:
        return LakehouseMetadata(self)

    def split_manager(self) -> LakehouseSplitManager:
        return LakehouseSplitManager(self)

    def page_source_provider(self) -> LakehousePageSourceProvider:
        return LakehousePageSourceProvider(self)

    def page_sink_provider(self) -> LakehousePageSinkProvider:
        return LakehousePageSinkProvider(self)


class LakehouseConnectorFactory(ConnectorFactory):
    name = "lakehouse"

    def create(self, catalog_name: str, config: dict) -> LakehouseConnector:
        root = config.get("lake.warehouse-dir")
        if not root:
            raise ValueError(
                "lakehouse catalog requires lake.warehouse-dir"
            )
        injector = None
        spec = config.get("lake.fault-injection")
        if spec:
            from ..utils.faults import FaultInjector

            injector = FaultInjector.from_spec(spec)
        fs = LocalObjectStore(root, injector=injector)
        return LakehouseConnector(catalog_name, fs, injector=injector)

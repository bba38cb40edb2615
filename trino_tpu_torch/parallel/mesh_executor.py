"""Distributed execution over a mesh of logical shards.

Counterpart of trino_tpu/parallel/mesh_executor.py.  Reference parity:
the distributed dataflow stack --
  - split assignment across workers (SourcePartitionedScheduler): a
    table's splits go round-robin over the shards, shard d taking
    splits[d::n];
  - exchanges (operator/exchange, the HTTP page shuffle): collectives
    over the shards' tensors (collectives.py) --
      partial -> final aggregation = psum / all_gather + re-merge
      broadcast join build side    = all_gather (FIXED_BROADCAST)
      gathering exchange at root   = all_gather (SINGLE distribution)
      hash repartition             = all_to_all (shuffle.py, FIXED_HASH)
      distributed sort             = range all_to_all, sorts per shard
  - DistributedQueryRunner's "N servers in one process": N shards in one
    process.

Where the JAX package traces one shard_map program that every device
runs, one controller here walks the plan once and drives every shard in
lockstep.  A shard-local operator (scan, filter, project, group id,
unnest, ...) runs the one-device executor's own visitor
(exec/local._TraceCtx) once per shard, over that shard's batch
(_ShardCtx); an exchange node is a visitor of _MeshTraceCtx over the
list of the shards' batches.  A replicated batch (the Batch.replicated
of the JAX package: identical on every shard) is held once a device and
read by every shard there: a broadcast join's gathered build side, and
the lookup source built from it (`_build_once`), exist once a card.  The
shards run the port's CUDA kernels through the same wrappers as one
device; a fused aggregate launches once per shard and its int64
partials are summed across shards.

Lockstep rather than threads: the supervisor, the journal, the launch
counters, the compile observatory and the tracer are process-global,
and one order of launches and of float merges makes every run repeat
bit for bit.  The retry ladder's checks of every shard land in one list,
so when any shard needs a re-run, every shard re-runs (the JAX package's
pmax of the checks).  Nothing is padded: the JAX package's shuffle
chunk capacity, its overflow rung and the ladder's quantized scan
capacity only size XLA's static shapes, and have no counterpart here.

Shards and devices: `default_mesh(n)` puts n logical shards round-robin
on the visible CUDA cards (all on cuda:0 on a one-card host), or on the
CPU when asked (device="cpu").  Shard i is the supervisor's device i:
a fault quarantines one shard, and the query re-runs over the healthy
ones (_shrink_to_healthy).  When none is left, or the re-run faults
again, DeviceFaultError is raised: the port has no CPU re-run (the JAX
package's _run_cpu_fallback).  The mesh neither streams nor spills (as
the JAX package's).

One host's slice of a multi-host cluster (CrossHostFragmentExecutor,
_SliceTraceCtx): a worker runs a slice-eligible fragment task over its
own local shards, and rows move between hosts through the HTTP and
spool exchanges, never a collective across processes.  The fetched
remote pages are merged once and held once (replicated: a broadcast
build side), and a PARTIAL aggregate stays partial on every shard, so
the consumer fragment's FINAL step merges the shards' rows as it merges
other tasks'.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..cache.compile_cache import fragment_family
from ..exec.local import Batch, ExecutionError, LocalExecutor, _TraceCtx, timed_visit
from ..exec.scan import (
    LoadedScan,
    LoadedScans,
    load_remote,
    load_table_scan,
    merge_pages_to_arrays,
    pages_bytes,
    plan_leaves,
)
from ..obs import compile_observatory
from ..ops import aggregation as agg_ops
from ..ops import join as join_ops
from ..ops import sketches
from ..ops import sort as sort_ops
from ..ops.filter_project import permute_lanes
from ..plan import nodes as P
from ..runtime import supervisor as rt
from ..runtime.supervisor import Breadcrumb, DeviceFaultError
from . import collectives as C
from . import shuffle


def _is_hll_lane(spec, name: str) -> bool:
    """The packed-register HLL lanes of approx_distinct: the one sketched
    state a collective can merge (register-wise max)."""
    return spec.kind == "approx_distinct" and "$hll" in name


def default_mesh(n: Optional[int] = None, device=None) -> List[torch.device]:
    """The devices of `n` logical shards: round-robin over the visible
    CUDA cards, or all on the CPU when device="cpu" is passed.  Without
    a card and without that request it raises (there is no quiet CPU
    mesh).  n = None or 0: one shard a card (one shard on the CPU, the
    process's one CPU device)."""
    d = torch.device("cuda" if device is None else device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "mesh's shards on the CPU"
            )
        cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        cards = [d]
    n = n or len(cards)
    return [cards[i % len(cards)] for i in range(n)]


def _decode_direct_keys(domains, cap, dtypes, device):
    """Group key codes from the dense mixed-radix group id (slot `dom`
    of a key is its NULL), in the key lanes' dtypes: no representative
    row of any shard is needed."""
    rem = torch.arange(cap, dtype=torch.int64, device=device)
    out = [None] * len(domains)
    for i in range(len(domains) - 1, -1, -1):
        radix = domains[i] + 1
        code = rem % radix
        rem = torch.div(rem, radix, rounding_mode="floor")
        out[i] = (code.to(dtypes[i]), code < domains[i])
    return out


class Sharded:
    """A batch over the mesh: one Batch a shard, or (replicated) one
    Batch every shard reads, copied once to each other device that
    reads it."""

    def __init__(self, parts: List[Batch], replicated: bool = False):
        self.parts = parts
        self.replicated = replicated
        self._copies: Dict[str, Batch] = {}

    def part(self, s: int, device) -> Batch:
        if not self.replicated:
            return self.parts[s]
        b = self.parts[0]
        if b.sel.device == device:
            return b
        key = str(device)
        if key not in self._copies:
            self._copies[key] = Batch(
                {sym: (v.to(device, non_blocking=True), ok.to(device, non_blocking=True))
                 for sym, (v, ok) in b.lanes.items()},
                b.sel.to(device, non_blocking=True), b.ordered)
        return self._copies[key]


def _empty(b: Batch, device) -> Batch:
    """A zero-row batch with b's lanes on `device` (Values on shards
    other than the first)."""
    return Batch({s: (v[:0].to(device), ok[:0].to(device))
                  for s, (v, ok) in b.lanes.items()}, b.sel[:0].to(device))


class MeshExecutor(LocalExecutor):
    """Executes a logical plan over every shard of a mesh."""

    def __init__(self, catalogs, mesh: Optional[List[torch.device]] = None,
                 config: Optional[dict] = None):
        config = dict(config or {})
        mesh = list(mesh) if mesh is not None else default_mesh(
            None, config.get("device"))
        config.setdefault("device", mesh[0])
        super().__init__(catalogs, config)
        self.mesh = mesh
        self.device = mesh[0]  # the home of replicated batches
        # supervisor identity of each shard: shard i is device i
        self._mesh_device_ids = list(range(len(mesh)))
        self.shard = 0  # this executor's shard (a shard view's own)
        self.mesh_tasks: List[dict] = []
        # (shard, id(scan), symbol) -> code remap into the union dictionary
        self._remaps: Dict[tuple, np.ndarray] = {}
        # the last run's host walls: split load and scan lanes, per-shard
        # operators, exchanges and replicated operators, checks and copy
        self.mesh_timing = dict.fromkeys(("loadS", "shardOpsS", "exchangeS", "syncS"), 0.0)

    # ------------------------------------------------------------------
    def execute(self, plan: P.Output):
        assert isinstance(plan, P.Output)
        if isinstance(plan.source, P.TableWriter):
            return self._execute_write(plan.source)
        sup = self.supervisor
        for d in list(self._mesh_device_ids):
            sup.maybe_probe(device_id=d)
        self._shrink_to_healthy()
        if not any(sup.healthy(device_id=d) for d in self._mesh_device_ids):
            bc = self._crumb("mesh:%d/pre-dispatch" % len(self.mesh), "gate")
            state = sup.device_state(device_id=self._mesh_device_ids[0])
            raise DeviceFaultError("device_" + state.lower(), bc)
        try:
            return self._execute_supervised(plan)
        except DeviceFaultError:
            # a shard faulted and the supervisor quarantined it: re-run
            # over the healthy shards (fewer, larger shards); no CPU run
            if not self._shrink_to_healthy():
                raise
            return self._execute_supervised(plan)

    def _shrink_to_healthy(self) -> bool:
        """Drop quarantined or blacklisted shards, so the query runs over
        the healthy ones instead of failing: a lost shard costs
        parallelism, not the query.  True when the mesh changed."""
        from ..obs import journal

        sup = self.supervisor
        ids = list(self._mesh_device_ids)
        healthy = [d for d in ids if sup.healthy(device_id=d)]
        if not healthy or len(healthy) == len(ids):
            return False
        for d in ids:
            if d not in healthy:
                journal.emit(
                    journal.MESH_SHRINK, query_id=self.query_id,
                    severity=journal.WARN, deviceId=d,
                    deviceState=sup.device_state(device_id=d),
                    fromSize=len(ids), toSize=len(healthy),
                )
        prof = self.kernel_profile
        prof["meshShrinks"] = prof.get("meshShrinks", 0) + len(ids) - len(healthy)
        by_id = dict(zip(ids, self.mesh))
        self.mesh = [by_id[d] for d in healthy]
        self._mesh_device_ids = healthy
        self.device = self.mesh[0]
        return True

    def _device_get(self, fn, what: str, shapes=None):
        return self.supervisor.device_get(
            fn, self._crumb(what, "sync", shapes), device=self.device,
            device_id=self._mesh_device_ids[self.shard])

    def _record_kernel(self, digest, compile_s, cached, mode="eager"):
        # every record carries the shard count, so profiles and flight
        # records tell an n-shard run from a one-device run of the plan
        if not str(digest).startswith("mesh:"):
            digest = "mesh:%d/%s" % (len(self.mesh), digest)
        return super()._record_kernel(
            digest, compile_s, cached, mode="mesh" if mode == "eager" else mode)

    def _shard_view(self, s: int) -> "MeshExecutor":
        """Shard s's executor: this one's state (the same profile,
        dictionaries, retry-ladder sets and supervisor) on the shard's
        device."""
        v = object.__new__(type(self))
        v.__dict__.update(self.__dict__)
        v.device = self.mesh[s]
        v.shard = s
        return v

    # ------------------------------------------------------------------
    def _execute_inner(self, plan: P.Output, scans=None):
        t0 = time.perf_counter()
        self.mesh_tasks = []
        self.mesh_timing = dict.fromkeys(
            ("loadS", "shardOpsS", "exchangeS", "syncS"), 0.0)
        if scans is None:
            scans = self._load_sharded_scans(plan)
        self.scan_bytes = scans.nbytes()
        self.mesh_timing["loadS"] = time.perf_counter() - t0
        self._note_layout(plan, scans)
        t1 = time.perf_counter()
        page = self._run_plan(plan, scans)
        tm = self.mesh_timing
        tm["syncS"] = (time.perf_counter() - t1 - tm.pop("runS", 0.0))
        self.kernel_profile["mesh"] = dict(shards=len(self.mesh), **tm)
        self.kernel_profile["summary"]["meshDevices"] = len(self.mesh)
        if self.config.get("collect_node_stats"):
            self._mesh_node_stats(plan, scans, time.perf_counter() - t0)
        return page

    def _note_layout(self, plan: P.Output, scans: LoadedScans) -> None:
        """The first run of a fragment family over this many shards in the
        process is the mesh's compile event (mode "mesh", the JAX
        package's shard_map compile): nothing is built, the event marks
        the plan laid out over the shards; a warm run records none."""
        family = "mesh%d:%s" % (len(self.mesh), fragment_family(plan))
        obs = compile_observatory.get_observatory()
        if obs.knows(family):
            return
        compile_observatory.record_compile(
            kernel="mesh:%d/fragment" % len(self.mesh), family=family,
            mode="mesh", shapes={"shards": len(self.mesh)},
            actual_rows=scans.rows(),
            query_id=self.query_id,
            task_id=str(self.config.get("task_id") or ""), scan_rows=[],
        )

    def _new_ctx(self, scans: LoadedScans) -> "_MeshTraceCtx":
        return _MeshTraceCtx(self, scans)

    def _run(self, plan: P.Output, ctx: "_MeshTraceCtx"):
        t0 = time.perf_counter()
        ops0 = self.mesh_timing["shardOpsS"]
        load0 = self.mesh_timing["loadS"]
        batch = ctx.visit(plan.source)
        if not batch.replicated:
            batch = ctx._gather(batch)  # the gathering exchange at the root
        b = batch.parts[0]
        tm = self.mesh_timing
        wall = time.perf_counter() - t0
        tm["runS"] = tm.get("runS", 0.0) + wall
        tm["exchangeS"] += wall - (tm["shardOpsS"] - ops0) - (tm["loadS"] - load0)
        return {s: b.lanes[s] for s in plan.symbols}, b.sel

    # ------------------------------------------------------------------
    def _load_sharded_scans(self, plan: P.PlanNode) -> LoadedScans:
        """Each shard's splits of every scan (shard d: splits[d::n]),
        loaded as the one-device executor loads a scan (the scan cache,
        generation on the device) on the shard's device, into one set a
        shard; varchar dictionaries unified across shards
        (_merge_split_dicts)."""
        n = len(self.mesh)
        self._remaps = {}
        scans = LoadedScans([LoadedScans() for _ in range(n)])
        # the scan's ordinal: FragmentExecutor's key of a task's assigned
        # splits, which the slice executor looks up
        idx = 0
        for node in plan_leaves(plan):
            if isinstance(node, P.RemoteSource):
                scans.dicts.update(scans.shards[0].add(self._load_remote_source(node)).dicts)
                continue
            splits = self._scan_splits(node, idx, n)
            idx += 1
            for s, shard in enumerate(scans.shards):
                mine = splits[s::n]
                shard.add(load_table_scan(self, node, mine, self.mesh[s]) if mine
                          else self._empty_scan(node))
            self._merge_split_dicts(
                node, [shard.leaves[id(node)].dicts for shard in scans.shards], scans.dicts)
        return scans

    def _scan_splits(self, node: P.TableScan, idx: int, n: int):
        """All of a table's splits, asked for with the shard count as the
        desired parallelism (the NodeScheduler's split placement, shards
        standing in for worker nodes).  The slice executor narrows this
        to the splits the coordinator assigned to its task."""
        conn = self.catalogs.get(node.catalog)
        return conn.split_manager().get_splits(node.table, n, node.constraint)

    def _load_remote_source(self, node: P.RemoteSource) -> LoadedScan:
        # a plan over the whole mesh has no exchange inputs; only the
        # slice executor's fragments read remote pages
        raise ExecutionError("the mesh executor cannot read remote sources")

    def _empty_scan(self, node: P.TableScan) -> LoadedScan:
        """A shard that holds none of the table's splits: zero rows."""
        symbols = [s for s, _ in node.assignments]
        tmap = dict(node.types)
        dicts = {}
        merged, total = merge_pages_to_arrays(
            [], symbols, [(s, tmap[s]) for s in symbols], dicts)
        return LoadedScan(node, merged, dicts, total)

    def _merge_split_dicts(self, node, per_dicts, dicts):
        """One varchar dictionary per symbol across the shards: the union
        of the shards' dictionaries in shard order, each shard's codes
        remapped into it when they differ (real tables carry per-file
        dictionaries, so shards holding different files diverge).  The
        remap runs on the shard's lanes when its scan is visited, so a
        lane generated on the device remaps alike."""
        syms = set()
        for dd in per_dicts:
            syms.update(dd)
        for sym in syms:
            present = [dd.get(sym) for dd in per_dicts]
            full = [d for d in present if d is not None and len(d)]
            base = full[0] if full else next(d for d in present if d is not None)
            if all(d is base or np.array_equal(d, base) for d in full):
                dicts[sym] = base
                continue
            index: Dict[str, int] = {}
            entries: List[str] = []
            for s, d in enumerate(present):
                if d is None or not len(d):
                    continue
                remap = np.empty(len(d), dtype=np.int32)
                for i, x in enumerate(d):
                    x = str(x)
                    if x not in index:
                        index[x] = len(entries)
                        entries.append(x)
                    remap[i] = index[x]
                self._remaps[(s, id(node), sym)] = remap
            dicts[sym] = np.array(entries, dtype=object)

    # ------------------------------------------------------------------
    def _mesh_node_stats(self, plan, scans: LoadedScans, wall_s):
        """Per-shard task rollups after the run (EXPLAIN ANALYZE,
        operator_stats), from the operators' stats over every shard: each
        shard's rows and walls scaled by its share of the scanned rows
        (the heaviest shard sets the run's wall), as the JAX package
        apportions them."""
        from ..obs import opstats

        n = len(self.mesh)
        shard_rows = np.array([shard.rows() for shard in scans.shards], dtype=np.int64)
        frames = opstats.frames_from_plan(plan, self.node_stats)
        qid = self.query_id or "query"
        heaviest = int(shard_rows.max()) if n else 0
        total = int(shard_rows.sum())
        tasks = []
        for s in range(n):
            frac = (int(shard_rows[s]) / heaviest) if heaviest else 1.0
            share = (int(shard_rows[s]) / total) if total else 1.0 / n
            fl = []
            for f in frames:
                g = dict(f)
                for k in ("inputRows", "inputBytes", "outputRows", "outputBytes"):
                    if k in g:
                        g[k] = int((f.get(k) or 0) * share)
                for k in ("wallS", "deviceWallS", "hostWallS"):
                    if k in g:
                        g[k] = float(f.get(k) or 0.0) * frac
                fl.append(g)
            tasks.append({
                "taskId": "%s.0.%d" % (qid, s),
                "nodeId": "device-%d" % self._mesh_device_ids[s],
                "operatorStats": opstats.task_rollup(fl, wall_s=float(wall_s) * frac),
            })
        self.mesh_tasks = tasks


class _ShardCtx(_TraceCtx):
    """One shard's context: the one-device visitors over the shard's
    batches.  `visit(child)` returns the batch the mesh already made for
    this shard; the retry-ladder checks and the lowering context are the
    mesh's, shared by every shard."""

    allow_fusion = False

    def __init__(self, mesh: "_MeshTraceCtx", view: MeshExecutor, scans: LoadedScans):
        super().__init__(view, scans)
        self.mesh = mesh
        self.sum_overflow = mesh.sum_overflow
        self.dup_checks = mesh.dup_checks
        self.collision_checks = mesh.collision_checks
        self.lowering = mesh.lowering
        self.inputs: Dict[int, Batch] = {}

    def visit(self, node: P.PlanNode) -> Batch:
        return self.inputs[id(node)]

    def _build_once(self, node, kind: str, build):
        memo = self.mesh.shared_builds
        if memo is None:
            return build()
        key = (id(node), kind, str(self.ex.device))
        if key not in memo:
            memo[key] = build()
        return memo[key]


class _MeshTraceCtx(_TraceCtx):
    """One run of the plan over the mesh: `visit` returns a Sharded.  A
    node with a `_visit_*` method here is an exchange; any other runs the
    one-device visitor on each shard (or once, over replicated inputs)."""

    def __init__(self, ex: MeshExecutor, scans: LoadedScans):
        super().__init__(ex, scans)
        self.home = ex.mesh[0]
        self.devices = list(ex.mesh)
        n = len(self.devices)
        self.shards = [
            _ShardCtx(self, ex._shard_view(s), scans.shards[s]) for s in range(n)
        ]
        # a broadcast build side's lookup sources, one a device (set while
        # the shards of one broadcast join or semi join run)
        self.shared_builds: Optional[dict] = None

    # -- stepping the shards ----------------------------------------------
    def visit(self, node: P.PlanNode) -> Sharded:
        ex = self.ex
        name = type(node).__name__
        m = self.exchanges.get(name.lower())
        if m is None:
            def run():
                return self._local(node, [self.visit(c) for c in node.sources])
        else:
            def run():
                return m(self, node)
        bc = Breadcrumb("mesh:%d/op:%s" % (len(self.devices), name),
                        query_id=ex.query_id,
                        task_id=str(ex.config.get("task_id") or ""),
                        mode="operator", hbm_reserved_bytes=ex.device_bytes)
        if ex.config.get("collect_node_stats"):
            # the operator's rows over every shard, its wall the mesh's
            step = run

            def run():
                return timed_visit(ex, node, step, lambda b: b.parts)
        return ex.supervisor.dispatch(run, bc, device_id=ex._mesh_device_ids[0])

    def _shard_step(self, s: int, name: str, thunk, timing: str = "shardOpsS"):
        """One shard's part of an operator, supervised as that shard's
        device (its kernel launches too)."""
        ex = self.ex
        sid = ex._mesh_device_ids[s]
        bc = Breadcrumb("mesh:%d/shard%d/op:%s" % (len(self.devices), s, name),
                        query_id=ex.query_id,
                        task_id=str(ex.config.get("task_id") or ""),
                        mode="operator", hbm_reserved_bytes=ex.device_bytes)
        scope = rt.active()
        prev = scope.device_id if scope is not None else 0
        if scope is not None:
            scope.device_id = sid
        t0 = time.perf_counter()
        try:
            return ex.supervisor.dispatch(thunk, bc, device_id=sid)
        finally:
            ex.mesh_timing[timing] += time.perf_counter() - t0
            if scope is not None:
                scope.device_id = prev

    def _each(self, name: str, fn) -> list:
        """fn(s, shard context) on every shard, in shard order."""
        return [self._shard_step(s, name, lambda: fn(s, ctx))
                for s, ctx in enumerate(self.shards)]

    def _local(self, node: P.PlanNode, ins: List[Sharded], fn=None) -> Sharded:
        """The one-device visitor of `node` (or fn(ctx, node)) on every
        shard over the shards' inputs (a replicated input is read whole
        by each shard), or once, replicated, when every input is."""
        fn = fn or getattr(_TraceCtx, "_visit_" + type(node).__name__.lower())
        srcs = node.sources
        name = type(node).__name__
        if all(i.replicated for i in ins):
            ctx = self.shards[0]
            ctx.inputs = {id(c): i.parts[0] for c, i in zip(srcs, ins)}
            return Sharded([self._shard_step(0, name, lambda: fn(ctx, node))], True)

        made = []  # each shard's dictionaries of its output lanes

        def one(s, ctx):
            ctx.inputs = {id(c): i.part(s, ctx.ex.device) for c, i in zip(srcs, ins)}
            out = fn(ctx, node)
            made.append({sym: ctx.ex.dicts.get(sym) for sym in out.lanes})
            return out

        parts = self._each(name, one)
        self._unify_shard_dicts(parts, made)
        return Sharded(parts)

    def _unify_shard_dicts(self, parts: List[Batch], made: List[dict]) -> None:
        """A dictionary an operator builds from its rows (UNNEST's
        elements, array_agg's and listagg's values) differs from shard to
        shard: one union dictionary, in shard order, and each shard's
        codes remapped into it."""
        from ..exec.local import _object_array
        from ..expr.functions import dict_gather

        for sym in parts[0].lanes:
            ds = [m.get(sym) for m in made]
            if ds[0] is None or all(d is ds[0] for d in ds):
                continue
            index: dict = {}
            for p, d in zip(parts, ds):
                remap = np.full(max(len(d), 1), -1, dtype=np.int32)
                for i, x in enumerate(d):
                    remap[i] = index.setdefault(x, len(index))
                v, ok = p.lanes[sym]
                p.lanes[sym] = (dict_gather(remap, v, -1).to(v.dtype), ok)
            self.ex.dicts[sym] = _object_array(list(index))

    def _broadcast(self, node, ins: List[Sharded]) -> Sharded:
        """A join against a replicated build side: the shards of a device
        share its lookup source."""
        self.shared_builds = {}
        try:
            return self._local(node, ins)
        finally:
            self.shared_builds = None

    # -- the exchanges ------------------------------------------------------
    def _gather(self, b: Sharded) -> Sharded:
        """The gathering exchange: every shard's selected rows, in shard
        order and each shard's row order, in one replicated batch.  A
        shard sends its selected rows only (as an all_to_all sends its
        kept rows): an unselected row would cost the gather's bytes and
        every consumer's, and a direct-address build would send them all
        to one slot."""
        parts = [p if p.ordered else self._live_rows(p) for p in b.parts]
        lanes = {
            s: (C.all_gather([p.lanes[s][0] for p in parts], self.home),
                C.all_gather([p.lanes[s][1] for p in parts], self.home))
            for s in parts[0].lanes
        }
        sel = C.all_gather([p.sel for p in parts], self.home)
        return Sharded([Batch(lanes, sel, parts[0].ordered)], True)

    @staticmethod
    def _live_rows(p: Batch) -> Batch:
        idx = torch.nonzero(p.sel).flatten()
        if idx.shape[0] == p.sel.shape[0]:
            return p
        return Batch(permute_lanes(p.lanes, idx),
                     torch.ones(idx.shape[0], dtype=torch.bool, device=p.sel.device))

    def _exchange(self, b: Sharded, routes) -> Sharded:
        """All-to-all of every shard's kept rows to their bucket's shard;
        routes[s] = (bucket, keep) of shard s's rows."""
        ex = self.ex

        def read(matrix):
            return ex._device_get(lambda: matrix.tolist(), "exchange counts")

        lanes, matrix = shuffle.repartition(
            [(p.lanes, bk, kp) for p, (bk, kp) in zip(b.parts, routes)],
            self.devices, read)
        return Sharded([
            Batch(l, torch.ones(sum(row[d] for row in matrix), dtype=torch.bool,
                                device=dev))
            for d, (l, dev) in enumerate(zip(lanes, self.devices))
        ])

    def _hash_repartition(self, b: Sharded, key_syms) -> Sharded:
        """FIXED_HASH exchange of a distributed batch by key columns: rows
        with equal keys co-locate (window, distinct, set operations)."""
        n = len(self.devices)

        def route(s, ctx):
            p = b.parts[s]
            bucket, kok = shuffle.bucket_of([p.lanes[k] for k in key_syms], p.sel, n)
            # NULL keys are a group of their own: one stable shard
            return torch.where(kok, bucket, 0), p.sel

        return self._exchange(b, self._each("Exchange", route))

    def _merge_fused_sums(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """The shards' fused (term, group) int64 partials all_gathered and
        summed.  Exact: the megakernel proves each term's table-wide sum
        below SUM_GATE (the whole sum's where it fits, else, for a wide
        output, term by term), so no partial sum can wrap."""
        g = C.all_gather(parts, self.home)
        return g.reshape((len(parts),) + tuple(parts[0].shape)).sum(0)

    def _fused_partials(self, scan: P.TableScan, run):
        b = self.visit(scan)
        parts = self._each("megakernel", lambda s, ctx: run(b.parts[s]))
        return self._merge_fused_sums(parts), b.parts[0]

    def _psum_accs(self, specs, shard_accs: List[Dict[str, torch.Tensor]]):
        """Merge the shards' accumulators by collective (every one has a
        psum_kind, or is an HLL lane).  int64 sum accumulators get a
        float64 shadow psum, so a wrap across shards (each under the
        limit, the total beyond int64) fails loudly."""
        ops = {"sum": C.psum, "min": C.pmin, "max": C.pmax}
        out = {}
        for s in specs:
            hll = [n for n in s.accumulator_names if _is_hll_lane(s, n)]
            if hll:
                cap = shard_accs[0][hll[0]].shape[0]
                merged = sketches.hll_pmax_merge(
                    [{i: a[n] for i, n in enumerate(hll)} for a in shard_accs],
                    cap, self.home)
                for i, n in enumerate(hll):
                    out[n] = merged[i]
            for name in s.accumulator_names:
                if name in hll:
                    continue
                kind = s.psum_kind(name)
                vals = [a[name] for a in shard_accs]
                out[name] = ops[kind](vals, self.home)
                if (kind == "sum" and s.kind in ("sum", "avg")
                        and vals[0].dtype == torch.int64
                        and (name.endswith("$val") or name.endswith("$sum"))):
                    shadow = C.psum([v.to(torch.float64) for v in vals], self.home)
                    self.sum_overflow.append((torch.abs(shadow) > 9.0e18).sum())
        return out

    def _exceeds_broadcast_threshold(self, build: Sharded) -> bool:
        """Would broadcasting this build side replicate at least the
        threshold's rows (broadcast_join_threshold_rows, total rows)?"""
        from ..config import BROADCAST_JOIN_THRESHOLD_ROWS

        t = self.ex.config.get("broadcast_join_threshold_rows")
        threshold = BROADCAST_JOIN_THRESHOLD_ROWS if t is None else int(t)
        rows = max(p.sel.shape[0] for p in build.parts)
        return rows * len(self.devices) >= threshold

    # -- leaves -------------------------------------------------------------
    def _visit_tablescan(self, node: P.TableScan) -> Sharded:
        remaps = self.ex._remaps

        def scan(s, ctx):
            b = _TraceCtx._visit_tablescan(ctx, node)
            for sym, (v, ok) in list(b.lanes.items()):
                table = remaps.get((s, id(node), sym))
                if table is not None:
                    from ..expr.functions import dict_gather

                    b.lanes[sym] = (dict_gather(table, v, -1).to(v.dtype), ok)
            return b

        return Sharded([self._shard_step(s, "TableScan", lambda: scan(s, ctx), "loadS")
                        for s, ctx in enumerate(self.shards)])

    def _visit_values(self, node: P.Values) -> Sharded:
        # the rows exist once: on the first shard
        b0 = self._shard_step(0, "Values",
                              lambda: _TraceCtx._visit_values(self.shards[0], node))
        return Sharded([b0] + [_empty(b0, d) for d in self.devices[1:]])

    def _visit_matchrecognize(self, node: P.MatchRecognize) -> Sharded:
        # the matcher reads whole partitions in order: one place
        b = self.visit(node.source)
        return self._local(node, [b if b.replicated else self._gather(b)])

    # -- aggregation --------------------------------------------------------
    def _visit_aggregate(self, node: P.Aggregate) -> Sharded:
        if node.step in ("single", "partial"):
            from ..ops import megakernel

            # each shard runs the fused kernel over its split; the summed
            # partials finish once, replicated
            fused = megakernel.try_fused(self, node)
            if fused is not None:
                return Sharded([fused], True)
        b = self.visit(node.source)
        if node.step not in ("single", "partial"):
            # a fragmented plan's merge step: its rows in one place
            return self._local(node, [b if b.replicated else self._gather(b)])
        all_specs = [a.to_spec() for a in node.aggs]
        collective_able = all(
            s.psum_kind(n) is not None or _is_hll_lane(s, n)
            for s in all_specs for n in s.accumulator_names)
        hll = any(_is_hll_lane(s, n) for s in all_specs for n in s.accumulator_names)
        psum_able = collective_able and not hll
        raw_needed = any(a.distinct or not a.partializable for a in node.aggs)
        if not b.replicated and raw_needed and node.keys:
            # grouped DISTINCT / non-decomposable aggregates: FIXED_HASH
            # exchange on the GROUP BY keys, then every shard aggregates
            # its hash range exactly; no shard holds more than its range
            return self._local(node, [self._hash_repartition(b, tuple(node.keys))])
        if not b.replicated and (raw_needed or (not psum_able and not node.keys)):
            # global DISTINCT / non-decomposable aggregates, and global
            # aggregates no collective merges (min_by, bitwise, arbitrary):
            # the raw rows in one place (a gathered approx_distinct counts
            # exactly, as the one-device SINGLE step does)
            b = self._gather(b)
        if b.replicated:
            return self._local(node, [b])
        types = node.source.output_types()
        keys = list(node.keys)
        flags = dict(overflow_flags=self.sum_overflow,
                     wide_flags=self.lowering.overflow_flags,
                     force_wide=self.lowering.force_wide_mul)
        if not keys:
            def acc(s, ctx):
                p, aggs = ctx._agg_dict_setup(node, b.parts[s])
                specs = [a.to_spec() for a in aggs]
                gid = torch.zeros(p.sel.shape[0], dtype=torch.int64, device=p.sel.device)
                return specs, agg_ops.accumulate(specs, p.lanes, gid, p.sel, 1, **flags)

            res = self._each("Aggregate", acc)
            specs = res[0][0]
            out = agg_ops.finalize(specs, self._psum_accs(specs, [r[1] for r in res]))
            present = torch.ones(1, dtype=torch.bool, device=self.home)
            return Sharded([self._finish_aggregate(node, [], out, present, 1)], True)
        domains = self._direct_domains(keys, types)
        if domains is not None and collective_able:
            def acc(s, ctx):
                p, aggs = ctx._agg_dict_setup(node, b.parts[s])
                specs = [a.to_spec() for a in aggs]
                key_lanes = [p.lanes[k] for k in keys]
                gid, cap = agg_ops.direct_group_ids(key_lanes, domains)
                # a sketched approx_distinct keeps its mergeable HLL lanes
                # (the SINGLE step's exact per-shard count cannot merge)
                accs = agg_ops.accumulate(specs, p.lanes, gid, p.sel, cap,
                                          step="partial" if hll else "single", **flags)
                present = (agg_ops._seg_count(p.sel, gid, cap) > 0).to(torch.int32)
                return specs, accs, present, cap, [v.dtype for v, _ in key_lanes]

            res = self._each("Aggregate", acc)
            specs, cap, dtypes = res[0][0], res[0][3], res[0][4]
            accs = self._psum_accs(specs, [r[1] for r in res])
            present = C.psum([r[2] for r in res], self.home) > 0
            out = agg_ops.finalize(specs, accs)
            keys_out = _decode_direct_keys(domains, cap, dtypes, self.home)
            return Sharded([self._finish_aggregate(node, keys_out, out, present, cap)], True)
        return self._partial_final(node, b, keys, flags)

    def _partial_final(self, node: P.Aggregate, b: Sharded, keys, flags) -> Sharded:
        """PARTIAL aggregation on each shard (hash-sort grouping), the
        gathering exchange of the partial groups, and the FINAL merge."""
        def partial(s, ctx):
            p, aggs = ctx._agg_dict_setup(node, b.parts[s])
            specs = [a.to_spec() for a in aggs]
            n = p.sel.shape[0]
            perm, gid, ngroups = ctx._group_sort([p.lanes[k] for k in keys], p.sel,
                                                 max(n, 1))
            cap = max(int(ngroups), 1)
            gid = torch.clamp(gid, max=cap - 1)
            sel_sorted = p.sel[perm]
            lanes = permute_lanes(p.lanes, perm)
            ss = agg_ops.SortedSegments(gid, cap)
            accs = agg_ops.accumulate(specs, lanes, gid, sel_sorted, cap,
                                      step="partial", seg=ss, **flags)
            keys_local = agg_ops.group_keys_output(
                [lanes[k] for k in keys], gid, sel_sorted, cap, starts=ss.starts)
            present = torch.arange(cap, device=gid.device) < ngroups
            return specs, accs, keys_local, present

        res = self._each("Aggregate", partial)
        specs = res[0][0]
        home = self.home
        present_g = C.all_gather([r[3] for r in res], home)
        ones = torch.ones(present_g.shape[0], dtype=torch.bool, device=home)
        acc_g = {name: (C.all_gather([r[1][name] for r in res], home), ones)
                 for name in res[0][1]}
        keys_g = [(C.all_gather([r[2][i][0] for r in res], home),
                   C.all_gather([r[2][i][1] for r in res], home))
                  for i in range(len(keys))]
        perm2, gid2, ngroups2 = self._group_sort(keys_g, present_g,
                                                 max(present_g.shape[0], 1))
        fcap = max(int(ngroups2), 1)
        gid2 = torch.clamp(gid2, max=fcap - 1)
        sel2 = present_g[perm2]
        merged = agg_ops.merge_accumulators(
            specs, {s: (v[perm2], ok[perm2]) for s, (v, ok) in acc_g.items()},
            gid2, sel2, fcap, overflow_flags=self.sum_overflow)
        out = agg_ops.finalize(specs, merged)
        keys_out = agg_ops.group_keys_output(
            [(v[perm2], ok[perm2]) for v, ok in keys_g], gid2, sel2, fcap)
        present = torch.arange(fcap, device=home) < ngroups2
        return Sharded([self._finish_aggregate(node, keys_out, out, present, fcap)], True)

    # -- joins --------------------------------------------------------------
    def _visit_join(self, node: P.Join) -> Sharded:
        left = self.visit(node.left)
        right = self.visit(node.right)
        if self._use_partitioned(node, left, right):
            return self._partitioned_join(node, left, right)
        if not right.replicated:
            right = self._gather(right)  # broadcast exchange of the build side
        return self._broadcast(node, [left, right])

    def _use_partitioned(self, node: P.Join, left: Sharded, right: Sharded) -> bool:
        """DetermineJoinDistributionType at run time: the optimizer's
        choice when it made one, else partitioned when broadcasting the
        build side would replicate at least the threshold's rows."""
        if (node.kind not in ("inner", "left") or not node.criteria
                or left.replicated or right.replicated):
            return False
        if node.distribution == "partitioned":
            return True
        if node.distribution == "broadcast":
            return False
        return self._exceeds_broadcast_threshold(right)

    def _partitioned_join(self, node: P.Join, left: Sharded, right: Sharded) -> Sharded:
        """HASH-HASH distribution: both sides all_to_all on the join keys,
        then each shard joins its hash range.  NULL-key probe rows of an
        outer join are kept (routed by their value lane, they match
        nothing but still emit)."""
        n = len(self.devices)
        lsyms = [l for l, _ in node.criteria]
        rsyms = [r for _, r in node.criteria]
        joint = (join_ops.needs_verification([left.parts[0].lanes[k] for k in lsyms])
                 or join_ops.needs_verification([right.parts[0].lanes[k] for k in rsyms]))

        def route(b, syms, outer):
            def one(s, ctx):
                p = b.parts[s]
                bucket, kok = shuffle.bucket_of([p.lanes[k] for k in syms], p.sel, n, joint)
                return bucket, (p.sel if outer else p.sel & kok)
            return self._each("Join", one)

        left2 = self._exchange(left, route(left, lsyms, node.kind == "left"))
        right2 = self._exchange(right, route(right, rsyms, False))
        return self._local(node, [left2, right2], fn=lambda ctx, nd: ctx._join_batches(
            nd, ctx.visit(nd.left), ctx.visit(nd.right)))

    def _visit_semijoin(self, node: P.SemiJoin) -> Sharded:
        src = self.visit(node.source)
        filt = self.visit(node.filtering)
        if (not src.replicated and not filt.replicated and node.filter is None
                and self._exceeds_broadcast_threshold(filt)):
            return self._partitioned_semijoin(node, src, filt)
        if not filt.replicated:
            filt = self._gather(filt)  # broadcast the filtering side
        return self._broadcast(node, [src, filt])

    def _partitioned_semijoin(self, node: P.SemiJoin, src: Sharded, filt: Sharded) -> Sharded:
        """HASH-HASH semi join: both sides repartitioned on the semi keys,
        marked per hash range.  NULL-key source rows go to one stable
        shard (they match nothing but emit their false mark); varchar
        source keys are recoded into the filtering side's codes first,
        so equal strings share a bucket."""
        n = len(self.devices)
        skeys0, fkeys0 = self.shards[0]._semi_keys(node, src.parts[0], filt.parts[0])
        joint = join_ops.needs_verification(skeys0) or join_ops.needs_verification(fkeys0)

        def route_src(s, ctx):
            p = src.parts[s]
            skeys, _ = ctx._semi_keys(node, p, filt.parts[s])
            bucket, ok = shuffle.bucket_of(skeys, p.sel, n, joint)
            return torch.where(ok, bucket, 0), p.sel

        def route_filt(s, ctx):
            p = filt.parts[s]
            bucket, ok = shuffle.bucket_of([p.lanes[k] for k in node.filtering_keys],
                                           p.sel, n, joint)
            return bucket, p.sel & ok

        src2 = self._exchange(src, self._each("SemiJoin", route_src))
        filt2 = self._exchange(filt, self._each("SemiJoin", route_filt))
        return self._local(node, [src2, filt2])

    def _visit_scalarjoin(self, node: P.ScalarJoin) -> Sharded:
        src = self.visit(node.source)
        sub = self.visit(node.subquery)
        return self._local(node, [src, sub if sub.replicated else self._gather(sub)])

    # -- window ---------------------------------------------------------------
    def _visit_window(self, node: P.Window) -> Sharded:
        """PARTITION BY windows hash-repartition on the partition keys and
        run per shard; a window without partitions gathers."""
        b = self.visit(node.source)
        if not b.replicated and node.partition_by:
            return self._local(node, [self._hash_repartition(b, tuple(node.partition_by))])
        return self._local(node, [b if b.replicated else self._gather(b)])

    # -- ordering -------------------------------------------------------------
    def _visit_sort(self, node: P.Sort) -> Sharded:
        """Distributed ORDER BY: a RANGE exchange on the leading key, then
        a sort on each shard; the shards in order are the total order (the
        final gather concatenates them), with no global sort."""
        b = self.visit(node.source)
        if b.replicated:
            return self._local(node, [b])
        # varchar keys sort by their ranks: each shard registers its $rank
        # lanes, which the exchange carries
        keys = self._each("Sort", lambda s, ctx: ctx._rank_sort_keys(node.keys, b.parts[s]))
        lead = keys[0][0]
        buckets = shuffle.range_buckets(
            [p.lanes[lead.column] for p in b.parts], lead, [p.sel for p in b.parts],
            len(self.devices), self.devices, self.home)
        b2 = self._exchange(b, [(bk, p.sel) for bk, p in zip(buckets, b.parts)])
        return self._local(node, [b2])

    def _visit_topn(self, node: P.TopN) -> Sharded:
        # local top-n on each shard, the candidates gathered, the top-n of
        # those (MergeOperator)
        b = self.visit(node.source)
        if b.replicated:
            return self._local(node, [b])
        return self._local(node, [self._gather(self._local(node, [b]))])

    def _visit_limit(self, node: P.Limit) -> Sharded:
        # each shard keeps count + offset rows; the gathered limit skips
        # the offset
        b = self.visit(node.source)
        if b.replicated:
            return self._local(node, [b])

        def partial(ctx, nd):
            p = ctx.visit(nd.source)
            lanes, sel = sort_ops.limit(p.lanes, p.sel, nd.count + nd.offset)
            return Batch(lanes, sel, p.ordered)

        return self._local(node, [self._gather(self._local(node, [b], fn=partial))])

    def _visit_distinct(self, node: P.Distinct) -> Sharded:
        """Each shard dedupes its rows, a FIXED_HASH exchange on the
        distinct keys co-locates equal rows, and each shard dedupes its
        hash range; the output stays distributed."""
        b = self.visit(node.source)
        if b.replicated:
            return self._local(node, [b])
        b = self._local(node, [b])
        return self._local(node, [self._hash_repartition(b, tuple(node.output_symbols()))])

    # -- set operations -------------------------------------------------------
    def _visit_setoperation(self, node: P.SetOperation) -> Sharded:
        if node.kind in ("intersect", "except"):
            return self._partitioned_setop(node)
        # UNION: every input in one place, then the one-device union
        ins = [self.visit(i) for i in node.inputs]
        return self._local(node, [i if i.replicated else self._gather(i) for i in ins])

    def _partitioned_setop(self, node: P.SetOperation) -> Sharded:
        """INTERSECT / EXCEPT: each shard unions its inputs positionally
        (dictionaries merged, so codes compare across shards), the tagged
        rows are repartitioned by the whole row, and each shard marks and
        dedupes its hash range.  A replicated input's rows are sent by
        the first shard only (one copy)."""
        if node.all:
            raise ExecutionError(f"{node.kind.upper()} ALL not supported (DISTINCT only)")
        if len(node.inputs) != 2:
            raise ExecutionError(f"{node.kind} takes two inputs")
        ins = [self.visit(i) for i in node.inputs]
        if all(i.replicated for i in ins):
            return self._local(node, ins)
        n = len(self.devices)

        def tagged(s, ctx):
            ctx.inputs = {id(i): b.part(s, ctx.ex.device) for i, b in zip(node.inputs, ins)}
            lanes, sel, caps = ctx._union_lanes(node)
            dev = sel.device
            tag = torch.cat([torch.full((c,), i, dtype=torch.int32, device=dev)
                             for i, c in enumerate(caps)])
            rep = torch.cat([torch.full((c,), b.replicated, dtype=torch.bool, device=dev)
                             for b, c in zip(ins, caps)])
            keep = sel & (~rep | (s == 0))
            bucket, kok = shuffle.bucket_of([lanes[x] for x in node.symbols], sel, n)
            lanes = dict(lanes)
            lanes["__tag__"] = (tag, torch.ones_like(sel))
            return Batch(lanes, sel), (torch.where(kok, bucket, 0), keep)

        res = self._each(type(node).__name__, tagged)
        b2 = self._exchange(Sharded([r[0] for r in res]), [r[1] for r in res])

        def reduce(s, ctx):
            p = b2.parts[s]
            lanes = dict(p.lanes)
            tag, _ = lanes.pop("__tag__")
            return ctx._setop_tag_reduce(node, lanes, p.sel, tag)

        return Sharded(self._each(type(node).__name__, reduce))


def _exchanges(cls) -> dict:
    """The nodes whose mesh visitor is an exchange (or a leaf of the
    mesh): the `_visit_*` methods of `cls` and its mesh bases."""
    out = {}
    for c in reversed(cls.__mro__[:cls.__mro__.index(_TraceCtx)]):
        out.update({k[len("_visit_"):]: v for k, v in vars(c).items()
                    if k.startswith("_visit_")})
    return out


_MeshTraceCtx.exchanges = _exchanges(_MeshTraceCtx)


class _SliceTraceCtx(_MeshTraceCtx):
    """One host's slice of a multi-host cluster.  The shards are this
    worker's own; the exchange between hosts is the server's HTTP and
    spool exchange, not a collective, so:

      - a RemoteSource is a network input this host already fetched: its
        pages are merged once and held once on the device, a replicated
        batch (the broadcast build side of a FIXED_BROADCAST join);
      - a PARTIAL aggregate stays partial: each shard emits its own
        accumulator rows, and the root's gather ships n partial rows a
        group to the consumer fragment, whose FINAL step merges them as
        if they came from more tasks.  The mesh's fused and collective
        paths finish the values, which the consumer would then merge a
        second time.
    """

    def _visit_remotesource(self, node: P.RemoteSource) -> Sharded:
        b = self._shard_step(0, "RemoteSource",
                             lambda: _TraceCtx._visit_remotesource(self.shards[0], node),
                             "loadS")
        return Sharded([b], True)

    def _visit_aggregate(self, node: P.Aggregate) -> Sharded:
        if node.step == "partial":
            # the one-device PARTIAL visitor on each shard (no fusion:
            # _ShardCtx.allow_fusion), its accumulator rows not merged
            return self._local(node, [self.visit(node.source)])
        return _MeshTraceCtx._visit_aggregate(self, node)


_SliceTraceCtx.exchanges = _exchanges(_SliceTraceCtx)

# node types a host slice runs over its local shards.  Sort, Window,
# SetOperation and the writers are left out: they need the whole input
# ordered in one place or change external state, and their fragments
# keep the one-device FragmentExecutor.
_SLICE_NODES = (
    P.Output, P.TableScan, P.RemoteSource, P.Filter, P.Project, P.Values,
    P.Aggregate, P.Join, P.SemiJoin, P.ScalarJoin, P.TopN, P.Limit,
    P.Distinct,
)


def slice_eligible(plan: P.PlanNode) -> bool:
    """True when a fragment can run as one host's slice over its shards.

    Exactly one TableScan: a SOURCE fragment, whose splits the
    coordinator already dealt across hosts, and whose RemoteSource
    inputs are then broadcast build sides (plan/fragment.py places
    partitioned exchanges only between fragments).  Aggregates must be
    PARTIAL: a final-step merge belongs to the consumer side of the
    network exchange, where the rows of every host meet.
    """
    nscans = 0
    stack = [plan]
    while stack:
        n = stack.pop()
        if not isinstance(n, _SLICE_NODES):
            return False
        if isinstance(n, P.TableScan):
            nscans += 1
        elif isinstance(n, P.Aggregate) and n.step != "partial":
            return False
        stack.extend(n.sources)
    return nscans == 1


class CrossHostFragmentExecutor(MeshExecutor):
    """One fragment task run as this host's slice of the cluster.

    Takes FragmentExecutor's place on slice-eligible fragments, with its
    constructor and stats surface.  The worker hands it the splits the
    coordinator assigned to this task and the remote pages it already
    pulled through the exchange client; the executor deals the splits
    over its shards (`mesh`: the worker's device once a shard) and runs
    the fragment on every shard.  Repartitions and partial -> final
    merges across hosts happen where they always did, in the consumer
    fragment fed through the HTTP or spool exchange, so a host killed
    with -9 loses only its slice and fault-tolerant execution replays
    its tasks from committed spools.
    """

    def __init__(self, catalogs, config: Optional[dict], splits_by_scan,
                 remote_pages, dynamic_filters=None,
                 mesh: Optional[List[torch.device]] = None):
        super().__init__(catalogs, mesh=mesh, config=config)
        self.splits_by_scan = splits_by_scan or {}
        self.remote_pages = remote_pages or {}
        # dynamic filters prune scan rows; the slice skips them (the
        # probe side's join still drops every row they would have)
        self.dynamic_filters = dynamic_filters or {}
        self.df_rows_pruned = 0
        # as FragmentExecutor: the remote pages held for the whole run
        self.exchange_bytes = pages_bytes(self.remote_pages)

    def _new_ctx(self, scans: LoadedScans) -> _SliceTraceCtx:
        return _SliceTraceCtx(self, scans)

    def _scan_splits(self, node: P.TableScan, idx: int, n: int):
        # only the splits the coordinator assigned to this task
        return self.splits_by_scan.get(idx, [])

    def _load_remote_source(self, node: P.RemoteSource) -> LoadedScan:
        """The fetched pages merged once (their dictionaries unified),
        shard 0's: the slice context reads them as one replicated batch."""
        return load_remote(node, self.remote_pages.get(node.fragment_id, []))

    def _run_plan(self, plan: P.Output, scans: LoadedScans):
        """The run inside the worker's memory pool: the host tier holds
        every shard's scan lanes and the exchange input (over the query's
        limit it raises: the slice neither streams nor spills), the device
        tier the same bytes, which the shards' lanes take on the card."""
        self._account_memory(scans, self.config.get("memory_limit_bytes"))
        manager = self.config.get("memory_manager")
        self.device_bytes = 0
        try:
            if manager is not None:
                t0 = time.perf_counter()
                manager.reserve(
                    self.query_id, self.scan_bytes, tier="device",
                    timeout=float(self.config.get("memory_blocked_timeout_s") or 0.0))
                self.blocked_memory_s += time.perf_counter() - t0
                self.device_bytes = self.scan_bytes
            return super()._run_plan(plan, scans)
        finally:
            if manager is not None:
                manager.free(self.query_id, self.scan_bytes, tier="host")
                if self.device_bytes:
                    manager.free(self.query_id, self.device_bytes, tier="device")

"""Plan fragmentation: exchange placement + cutting into distributed stages.

Reference parity: sql/planner/optimizations/AddExchanges.java:138 (placing
distribution boundaries; partial aggregation splitting mirrors
PushPartialAggregationThroughExchange) and sql/planner/PlanFragmenter.java:94
(createSubPlans:124 — cutting at ExchangeNodes into PlanFragments with
partitioning handles, SystemPartitioningHandle.java:48-55: SOURCE /
FIXED_HASH / SINGLE).

TPU-first notes: fragments are the unit shipped to workers; within a worker
a fragment compiles to one XLA program (exec/local.py), so exchange placement
here is also the compilation-unit boundary.  Hash repartitioning between
source and middle stages is the engine's "TP" (SURVEY §2.2); broadcast
replication of build sides maps to the all-gather slot.

Distribution policy (v1, mirroring the reference's defaults for this scale):
  - scans run SOURCE-partitioned (splits spread over workers)
  - grouped aggregation: PARTIAL in the source stage, FIXED_HASH exchange on
    the group keys, FINAL in a hash-partitioned middle stage
  - global aggregation: PARTIAL in source stage, gather, FINAL single
  - joins/semijoins/scalar subqueries: probe side keeps its partitioning,
    build side is broadcast (replicated to every probe task)
  - sort/window/set-ops/merge phases gather to a SINGLE stage
  - TopN/Limit: partial in the distributed stage, final after the gather

A worker that streams its own fragment (exec/streaming.py) cuts that
fragment again: an aggregate already split keeps its step across the
new cut (a PARTIAL becomes PARTIAL under INTERMEDIATE, a FINAL becomes
INTERMEDIATE under FINAL), the fragment's RemoteSources stay where they
are as whole inputs, and the new fragments are numbered after theirs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from . import nodes as P

SOURCE = "source"
SINGLE = "single"
HASH = "hash"
BROADCAST = "broadcast"
# load-balancing redistribution with no key affinity
# (FIXED_ARBITRARY_DISTRIBUTION / RandomExchange)
ARBITRARY = "arbitrary"


@dataclasses.dataclass
class PlanFragment:
    """One distributed stage (reference PlanFragment/SubPlan)."""

    id: int
    root: P.Output  # fragment-local root, wrapped in Output for names
    partitioning: str  # how THIS fragment's tasks divide work: source|single|hash
    partition_keys: Tuple[str, ...]  # for hash fragments
    output_partitioning: str  # how output pages route to the consumer stage
    output_keys: Tuple[str, ...]  # hash keys for output_partitioning == hash
    # (preorder scan index -> (catalog, table, constraint)) for split
    # assignment + connector-side pruning
    scan_tables: Dict[int, Tuple[str, str, tuple]] = dataclasses.field(
        default_factory=dict
    )
    source_fragments: List[int] = dataclasses.field(default_factory=list)


def _wrap_output(node: P.PlanNode) -> P.Output:
    if isinstance(node, P.Output):
        return node
    syms = tuple(node.output_symbols())
    return P.Output(node, syms, syms)


def _index_scans(frag: PlanFragment):
    idx = 0

    def walk(n: P.PlanNode):
        nonlocal idx
        if isinstance(n, P.TableScan):
            frag.scan_tables[idx] = (n.catalog, n.table, n.constraint)
            idx += 1
        if isinstance(n, P.RemoteSource):
            frag.source_fragments.append(n.fragment_id)
        for s in n.sources:
            walk(s)

    walk(frag.root)


class Fragmenter:
    """Walks the optimized plan, inserting distribution boundaries and
    cutting child fragments (exchange placement and fragmentation fused —
    the ExchangeNode is implied by the PlanFragment/RemoteSource pair)."""

    def __init__(self, first_id: int = 1):
        self.fragments: List[PlanFragment] = []
        self.first_id = first_id  # 0 is reserved for the root

    def _cut(
        self,
        subtree: P.PlanNode,
        partitioning: str,
        partition_keys: Tuple[str, ...],
        output_partitioning: str,
        output_keys: Tuple[str, ...] = (),
    ) -> P.RemoteSource:
        fid = self.first_id + len(self.fragments)
        frag = PlanFragment(
            fid,
            _wrap_output(subtree),
            partitioning,
            partition_keys,
            output_partitioning,
            output_keys,
        )
        self.fragments.append(frag)
        return P.RemoteSource(
            fid,
            tuple(subtree.output_symbols()),
            tuple(subtree.output_types().items()),
        )

    # ------------------------------------------------------------------
    def fragment(self, plan: P.Output) -> List[PlanFragment]:
        node, part, keys = self._rewrite(plan.source)
        if part != SINGLE:
            node = self._cut(node, part, keys, SINGLE)
        root = P.Output(node, plan.names, plan.symbols)
        root_frag = PlanFragment(0, root, SINGLE, (), SINGLE, ())
        out = [root_frag] + self.fragments
        for f in out:
            _index_scans(f)
            if f.partitioning in (SOURCE,):
                nscans = len(f.scan_tables)
                assert nscans == 1, (
                    f"source fragment {f.id} must contain exactly one scan, "
                    f"got {nscans}"
                )
        return out

    # ------------------------------------------------------------------
    def _rewrite(
        self, node: P.PlanNode
    ) -> Tuple[P.PlanNode, str, Tuple[str, ...]]:
        """Returns (node, partitioning, partition_keys) where partitioning
        describes how the subtree's output is currently divided across
        tasks (SOURCE/HASH) or SINGLE if it fits one task."""
        m = getattr(self, f"_do_{type(node).__name__.lower()}", None)
        if m is not None:
            return m(node)
        raise NotImplementedError(
            f"fragmenter: no rule for {type(node).__name__}"
        )

    def _gather(self, node, part, keys) -> P.PlanNode:
        """Force the subtree into this (single) fragment via a gather."""
        if part == SINGLE:
            return node
        return self._cut(node, part, keys, SINGLE)

    # -- leaves ---------------------------------------------------------
    def _do_tablescan(self, node: P.TableScan):
        return node, SOURCE, ()

    def _do_values(self, node: P.Values):
        return node, SINGLE, ()

    def _do_remotesource(self, node: P.RemoteSource):
        # an exchange already placed: each reader reads its whole input
        return node, SINGLE, ()

    # -- streaming unary (keep partitioning) -----------------------------
    def _do_filter(self, node: P.Filter):
        src, part, keys = self._rewrite(node.source)
        return P.Filter(src, node.predicate), part, keys

    def _do_project(self, node: P.Project):
        src, part, keys = self._rewrite(node.source)
        # projecting away a partition key demotes to unkeyed distribution
        out = set(s for s, _ in node.assignments)
        if part == HASH and not all(k in out for k in keys):
            keys = ()
        return P.Project(src, node.assignments), part, keys

    def _do_limit(self, node: P.Limit):
        src, part, keys = self._rewrite(node.source)
        if part == SINGLE:
            return P.Limit(src, node.count, node.offset), SINGLE, ()
        # partial keeps count+offset rows per task; only the final single
        # stage applies the offset skip
        partial = P.Limit(src, node.count + node.offset)
        rs = self._cut(partial, part, keys, SINGLE)
        return P.Limit(rs, node.count, node.offset), SINGLE, ()

    def _do_topn(self, node: P.TopN):
        src, part, keys = self._rewrite(node.source)
        if part == SINGLE:
            return P.TopN(src, node.keys, node.count), SINGLE, ()
        partial = P.TopN(src, node.keys, node.count)
        rs = self._cut(partial, part, keys, SINGLE)
        return P.TopN(rs, node.keys, node.count), SINGLE, ()

    def _do_sort(self, node: P.Sort):
        src, part, keys = self._rewrite(node.source)
        src = self._gather(src, part, keys)
        return P.Sort(src, node.keys), SINGLE, ()

    def _do_window(self, node: P.Window):
        src, part, keys = self._rewrite(node.source)
        src = self._gather(src, part, keys)
        return P.Window(
            src, node.partition_by, node.order_by, node.functions
        ), SINGLE, ()

    def _do_distinct(self, node: P.Distinct):
        src, part, keys = self._rewrite(node.source)
        if part == SINGLE:
            return P.Distinct(src), SINGLE, ()
        syms = tuple(node.output_symbols())
        partial = P.Distinct(src)
        rs = self._cut(partial, part, keys, HASH, syms)
        return P.Distinct(rs), HASH, syms

    def _do_unnest(self, node: P.Unnest):
        # per-row expansion, streaming: partitioning unchanged
        src, part, keys = self._rewrite(node.source)
        if part == HASH and node.array_symbol in keys:
            keys = ()
        return dataclasses.replace(node, source=src), part, keys

    def _do_matchrecognize(self, node: P.MatchRecognize):
        src, part, keys = self._rewrite(node.source)
        src = self._gather(src, part, keys)  # single-stage like Window
        return dataclasses.replace(node, source=src), SINGLE, ()

    def _do_sample(self, node: P.Sample):
        src, part, keys = self._rewrite(node.source)
        return dataclasses.replace(node, source=src), part, keys

    def _do_groupid(self, node: P.GroupId):
        # row expansion is local to each task; gid joins the hash keys of
        # the aggregation above, so partitioning is unchanged here
        src, part, keys = self._rewrite(node.source)
        return dataclasses.replace(node, source=src), part, keys

    # -- aggregation ------------------------------------------------------
    def _do_aggregate(self, node: P.Aggregate):
        src, part, keys = self._rewrite(node.source)
        if part == SINGLE:
            return dataclasses.replace(node, source=src), SINGLE, ()
        if not all(a.partializable for a in node.aggs):
            # e.g. count(DISTINCT): raw rows must be colocated by group key
            if node.keys:
                rs = self._cut(src, part, keys, HASH, tuple(node.keys))
                return (
                    P.Aggregate(rs, node.keys, node.aggs, "single"),
                    HASH,
                    tuple(node.keys),
                )
            rs = self._cut(src, part, keys, SINGLE)
            return P.Aggregate(rs, node.keys, node.aggs, "single"), SINGLE, ()
        # the steps either side of the cut: an aggregate already split
        # keeps what it reads and what it emits
        lower, upper = _SPLIT_STEPS[node.step]
        partial = P.Aggregate(src, node.keys, node.aggs, lower)
        if node.keys:
            rs = self._cut(partial, part, keys, HASH, tuple(node.keys))
            return (
                P.Aggregate(rs, node.keys, node.aggs, upper),
                HASH,
                tuple(node.keys),
            )
        rs = self._cut(partial, part, keys, SINGLE)
        return P.Aggregate(rs, node.keys, node.aggs, upper), SINGLE, ()

    # -- joins ------------------------------------------------------------
    def _broadcast(self, node, part, keys, probe_single: bool) -> P.PlanNode:
        """Build/filtering sides: replicate to every probe task (the
        all-gather slot; FIXED_BROADCAST_DISTRIBUTION).  A RemoteSource
        is read whole by every task already."""
        if probe_single or isinstance(node, P.RemoteSource):
            return self._gather(node, part, keys)
        return self._cut(node, part, keys, BROADCAST)

    def _do_join(self, node: P.Join):
        left, lpart, lkeys = self._rewrite(node.left)
        right, rpart, rkeys = self._rewrite(node.right)
        probe_single = lpart == SINGLE
        if probe_single and rpart == SINGLE:
            return (
                dataclasses.replace(node, left=left, right=right),
                SINGLE,
                (),
            )
        if (
            node.distribution == "partitioned"
            and not probe_single
            and rpart != SINGLE
            and node.criteria
        ):
            # HASH-HASH distribution (AddExchanges PARTITIONED join): both
            # inputs repartition on their join keys; the join stage is one
            # task per hash range, with probe AND build streams routed by
            # the same key hash (partitioner.hash_rows on each child's
            # output keys — equal key values land on the same task)
            lsyms = tuple(l for l, _ in node.criteria)
            rsyms = tuple(r for _, r in node.criteria)
            lrs = self._cut(left, lpart, lkeys, HASH, lsyms)
            rrs = self._cut(right, rpart, rkeys, HASH, rsyms)
            return (
                dataclasses.replace(node, left=lrs, right=rrs),
                HASH,
                lsyms,
            )
        rs = self._broadcast(right, rpart, rkeys, probe_single)
        return (
            dataclasses.replace(node, left=left, right=rs),
            lpart,
            lkeys,
        )

    def _do_semijoin(self, node: P.SemiJoin):
        src, part, keys = self._rewrite(node.source)
        filt, fpart, fkeys = self._rewrite(node.filtering)
        probe_single = part == SINGLE
        if probe_single and fpart == SINGLE:
            fs = filt
        else:
            fs = self._broadcast(filt, fpart, fkeys, probe_single)
        return (
            P.SemiJoin(src, fs, node.source_keys, node.filtering_keys,
                       node.output, node.filter),
            part,
            keys,
        )

    def _do_scalarjoin(self, node: P.ScalarJoin):
        src, part, keys = self._rewrite(node.source)
        sub, spart, skeys = self._rewrite(node.subquery)
        probe_single = part == SINGLE
        if probe_single and spart == SINGLE:
            ss = sub
        else:
            ss = self._broadcast(sub, spart, skeys, probe_single)
        return P.ScalarJoin(src, ss), part, keys

    # -- set operations ---------------------------------------------------
    def _do_setoperation(self, node: P.SetOperation):
        rewritten = [self._rewrite(i) for i in node.inputs]
        if (
            node.kind == "union"
            and node.all
            and any(part != SINGLE for _, part, _ in rewritten)
        ):
            # distributed UNION ALL: each input redistributes round-robin
            # (FIXED_ARBITRARY / RandomExchange) so the union stage stays
            # parallel instead of gathering to one task
            # EVERY input is cut (SINGLE ones too): the union stage
            # runs one task per worker, and an inlined SINGLE subtree
            # would be re-executed by each task, duplicating its rows —
            # the round-robin output splits a single producer's rows
            # across the consumer tasks instead
            inputs = tuple(
                self._cut(srcn, part, keys, ARBITRARY)
                for srcn, part, keys in rewritten
            )
            return (
                P.SetOperation(node.kind, node.all, inputs, node.symbols,
                               node.types_),
                ARBITRARY,
                (),
            )
        inputs = []
        for srcn, part, keys in rewritten:
            inputs.append(self._gather(srcn, part, keys))
        return (
            P.SetOperation(node.kind, node.all, tuple(inputs), node.symbols,
                           node.types_),
            SINGLE,
            (),
        )

    def _do_output(self, node: P.Output):
        src, part, keys = self._rewrite(node.source)
        src = self._gather(src, part, keys)
        return P.Output(src, node.names, node.symbols), SINGLE, ()


# an aggregate's step -> the steps below and above a cut through it
_SPLIT_STEPS = {
    "single": ("partial", "final"),
    "partial": ("partial", "intermediate"),
    "intermediate": ("intermediate", "intermediate"),
    "final": ("intermediate", "final"),
}


def fragment_plan(plan: P.Output, first_id: int = 1) -> List[PlanFragment]:
    """Optimized plan -> list of fragments, root first (id 0); the cut
    fragments are numbered from `first_id`."""
    return Fragmenter(first_id).fragment(plan)

"""Iterative Memo optimizer: cost-compared plan alternatives.

Reference parity: sql/planner/iterative/IterativeOptimizer.java:67 +
Memo.java:63 — plans live in a memo of GROUPS (sets of logically
equivalent alternatives whose children are group references); exploration
RULES add alternatives; extraction picks the cheapest alternative per
group bottom-up under the cost model (cost.CostModel, the
CostCalculatorUsingExchanges analog).

Scope (the decisions this engine's executors act on, explored jointly
instead of by r3's fixed greedy thresholds):
  - join ORDER: alternative left-deep orders of each inner-join region
    (ReorderJoins.java:97 explored through the memo, not greedily picked)
  - join SIDES: inner-join commutation with build-side uniqueness
    re-derived per orientation (DetermineJoinDistributionType flip)
  - join DISTRIBUTION: broadcast vs partitioned costed against mesh
    collective volume (AddExchanges.java:138)

The memo is bounded: alternatives dedup structurally, rules fire once per
alternative, and regions cap the orders they propose — TPC-DS Q7's
5-table region stays well under the reference's exploration budget.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

from ..catalog import Metadata
from ..expr import ir
from . import nodes as P
from .cost import Cost, CostModel, StatsProvider, _conjuncts


@dataclasses.dataclass(frozen=True)
class GroupRef(P.PlanNode):
    """Placeholder child pointing at a memo group (Memo.java GroupReference)."""

    group: int
    symbols: Tuple[str, ...]
    types: Tuple[Tuple[str, object], ...]

    @property
    def sources(self):
        return ()

    def output_symbols(self):
        return list(self.symbols)

    def output_types(self):
        return dict(self.types)


class Memo:
    def __init__(self):
        # group id -> list of alternatives (nodes whose children are GroupRefs)
        self.groups: List[List[P.PlanNode]] = []
        self._index: Dict[P.PlanNode, int] = {}

    def insert(self, node: P.PlanNode) -> int:
        """Recursively intern a plan; structurally identical subtrees share
        one group.  Nodes with unhashable payloads (host literals inside
        expressions) skip dedup — correctness is unaffected, the memo just
        holds one group per occurrence."""
        if isinstance(node, GroupRef):
            return node.group
        interned = self._rewrite_children(node)
        try:
            if interned in self._index:
                return self._index[interned]
        except TypeError:
            gid = len(self.groups)
            self.groups.append([interned])
            return gid
        gid = len(self.groups)
        self.groups.append([interned])
        self._index[interned] = gid
        return gid

    def add_alternative(self, gid: int, node: P.PlanNode) -> bool:
        interned = self._rewrite_children(node)
        try:
            if interned in self.groups[gid]:
                return False
        except TypeError:
            if any(interned is g for g in self.groups[gid]):
                return False
        self.groups[gid].append(interned)
        return True

    def _rewrite_children(self, node: P.PlanNode) -> P.PlanNode:
        if not node.sources:
            return node
        refs = []
        for s in node.sources:
            g = self.insert(s)
            rep = self.groups[g][0]
            refs.append(GroupRef(
                g,
                tuple(rep.output_symbols()),
                tuple(sorted(rep.output_types().items(),
                             key=lambda kv: kv[0])),
            ))
        return _replace_sources(node, tuple(refs))

    def representative(self, gid: int) -> P.PlanNode:
        return self.groups[gid][0]


def _replace_sources(node: P.PlanNode, new: Tuple[P.PlanNode, ...]):
    if isinstance(node, P.Join):
        return dataclasses.replace(node, left=new[0], right=new[1])
    fields = [f.name for f in dataclasses.fields(node)]
    if "source" in fields and len(new) == 1:
        return dataclasses.replace(node, source=new[0])
    updates, i = {}, 0
    for f in fields:
        v = getattr(node, f)
        if isinstance(v, P.PlanNode):
            updates[f] = new[i]
            i += 1
        elif isinstance(v, tuple) and v and all(
            isinstance(x, P.PlanNode) for x in v
        ):
            # tuple-typed child fields (SetOperation.inputs et al)
            updates[f] = tuple(new[i:i + len(v)])
            i += len(v)
    if i != len(new):
        raise ValueError(
            f"{type(node).__name__}: matched {i} child fields for "
            f"{len(new)} sources"
        )
    return dataclasses.replace(node, **updates) if updates else node


# --- rules --------------------------------------------------------------


def _rule_commute(node: P.PlanNode, ctx) -> List[P.PlanNode]:
    """Inner-join commutation; build-side (right) uniqueness re-derived
    so the executor picks the right kernel per orientation."""
    if not (isinstance(node, P.Join) and node.kind == "inner"
            and node.criteria):
        return []
    swapped = P.Join(
        "inner", node.right, node.left,
        tuple((r, l) for l, r in node.criteria),
        node.filter,
        expansion=not ctx.unique(node.left, [l for l, _ in node.criteria]),
        distribution=node.distribution,
    )
    return [swapped]


def _rule_distribution(node: P.PlanNode, ctx) -> List[P.PlanNode]:
    """Emit the other distribution alternative (broadcast <-> partitioned);
    the session property pins one mode and disables the rule."""
    if not (isinstance(node, P.Join) and node.criteria
            and node.kind in ("inner", "left")):
        return []
    if not ctx.distributed:
        # single-device plans ignore the flag; exploring it just makes
        # EXPLAIN noisy — keep the threshold-derived default
        return []
    if ctx.forced_distribution is not None:
        if node.distribution != ctx.forced_distribution:
            return [dataclasses.replace(
                node, distribution=ctx.forced_distribution)]
        return []
    out = []
    for d in ("broadcast", "partitioned"):
        if node.distribution != d:
            out.append(dataclasses.replace(node, distribution=d))
    return out


def _rule_associate(node: P.PlanNode, ctx) -> List[P.PlanNode]:
    """Left-deep rotation: (A ⋈ B) ⋈ C  →  (A ⋈ C) ⋈ B when the top
    join's criteria connect C to A alone — the two orders ReorderJoins
    would cost against each other inside one region."""
    if not ctx.reorder:
        return []
    if not (isinstance(node, P.Join) and node.kind == "inner"
            and node.criteria):
        return []
    inner = node.left
    if isinstance(inner, GroupRef):
        inner = ctx.memo.representative(inner.group)
    if not (isinstance(inner, P.Join) and inner.kind == "inner"
            and inner.criteria):
        return []
    a, b = inner.left, inner.right
    a_syms = set(a.output_symbols())
    b_syms = set(b.output_symbols())
    # every top-level equi edge must land in A for the rotation to be
    # criteria-preserving (C never references B)
    tops = list(node.criteria)
    if not all(l in a_syms for l, _ in tops):
        return []
    # inner criteria must stay valid: they join A to B, unchanged;
    # build-side uniqueness is re-derived per new orientation.  The
    # inner join's residual filter references A∪B symbols only — it
    # rides up to the rotated top (never dropped)
    residual = None
    if node.filter is not None and inner.filter is not None:
        residual = ir.Logical("and", (node.filter, inner.filter))
    else:
        residual = node.filter if node.filter is not None else inner.filter
    new_inner = P.Join(
        "inner", a, node.right, tuple(tops), None,
        expansion=not ctx.unique(node.right, [r for _, r in tops]),
        distribution=node.distribution,
    )
    rotated = P.Join(
        "inner", new_inner, b, tuple(inner.criteria), residual,
        expansion=not ctx.unique(b, [r for _, r in inner.criteria]),
        distribution=inner.distribution,
    )
    return [rotated]


RULES: Tuple[Callable, ...] = (
    _rule_commute, _rule_distribution, _rule_associate,
)


# --- exploration driver -------------------------------------------------


class _Context:
    def __init__(self, memo: Memo, metadata: Metadata, properties):
        self.memo = memo
        self.metadata = metadata
        mode = None
        distributed = False
        if properties is not None:
            m = properties.get("join_distribution_type")
            if m in ("broadcast", "partitioned"):
                mode = m
            distributed = bool(properties.get("distributed"))
        self.forced_distribution = mode
        self.distributed = distributed
        self.reorder = (
            bool(properties.get("reorder_joins"))
            if properties is not None else True
        )

    def unique(self, node: P.PlanNode, keys) -> bool:
        from .optimizer import _key_unique

        if isinstance(node, GroupRef):
            node = self.memo.representative(node.group)
        node = _deref(node, self.memo)
        try:
            return all(
                _key_unique(node, k, self.metadata) for k in keys
            )
        except Exception:
            return False


def _deref(node: P.PlanNode, memo: Memo) -> P.PlanNode:
    """Shallow materialization: replace GroupRef children with their
    representative (recursively) so stats walkers see a real tree."""
    if isinstance(node, GroupRef):
        return _deref(memo.representative(node.group), memo)
    if not node.sources:
        return node
    return _replace_sources(
        node, tuple(_deref(s, memo) for s in node.sources)
    )


def explore(
    plan: P.PlanNode,
    metadata: Metadata,
    properties=None,
    max_alternatives: int = 512,
) -> Tuple[P.PlanNode, Dict[str, float]]:
    """Insert the plan, run rules to fixpoint, extract the cheapest
    alternative per group.  Returns (best plan, summary info for EXPLAIN:
    alternatives considered + chosen total cost)."""
    ndev = 1
    if properties is not None and properties.get("distributed"):
        ndev = properties.get("num_devices") or 8
    memo = Memo()
    root = memo.insert(plan)
    ctx = _Context(memo, metadata, properties)

    fired = set()
    changed = True
    rounds = 0
    while changed and rounds < 16:
        changed = False
        rounds += 1
        for gid in range(len(memo.groups)):
            for alt in list(memo.groups[gid]):
                for rule in RULES:
                    key = (gid, id(alt), rule.__name__)
                    if key in fired:
                        continue
                    fired.add(key)
                    total = sum(len(g) for g in memo.groups)
                    if total >= max_alternatives:
                        changed = False
                        break
                    for new in rule(alt, ctx):
                        if memo.add_alternative(gid, new):
                            changed = True

    # extraction: cheapest alternative per group, bottom-up DP with
    # memoized group costs (Memo.java extract + cost comparison)
    stats = StatsProvider(
        metadata, ndev, resolver=lambda n: _deref(n, memo)
    )
    model = CostModel(stats)
    best: Dict[int, Tuple[Cost, P.PlanNode]] = {}

    def group_best(gid: int) -> Tuple[Cost, P.PlanNode]:
        if gid in best:
            return best[gid]
        # cycle guard: seed with the first alternative at infinite cost
        best[gid] = (Cost(float("inf"), 0, 0), None)
        winner = None
        wcost = None
        for alt in memo.groups[gid]:
            c = model.local_cost(_shallow_deref(alt, memo))
            kids = []
            ok = True
            for s in alt.sources:
                assert isinstance(s, GroupRef)
                kc, kn = group_best(s.group)
                if kn is None:
                    ok = False
                    break
                c = c + kc
                kids.append(kn)
            if not ok:
                continue
            if wcost is None or c.total < wcost.total:
                wcost, winner = c, (
                    _replace_sources(alt, tuple(kids)) if kids else alt
                )
        if winner is None:
            # all alternatives cycled: materialize the representative
            winner, wcost = _deref(memo.representative(gid), memo), Cost()
        best[gid] = (wcost, winner)
        return best[gid]

    cost, chosen = group_best(root)
    info = {
        "groups": float(len(memo.groups)),
        "alternatives": float(sum(len(g) for g in memo.groups)),
        "cost_total": cost.total,
        "cost_cpu": cost.cpu,
        "cost_net": cost.net,
        "cost_mem": cost.mem,
    }
    return chosen, info


def _shallow_deref(node: P.PlanNode, memo: Memo) -> P.PlanNode:
    """One-level deref for local costing: children become representative
    trees (stats need real children, cost only reads estimates)."""
    if not node.sources:
        return node
    return _replace_sources(
        node, tuple(_deref(s, memo) for s in node.sources)
    )


def memo_optimize(
    plan: P.PlanNode, metadata: Metadata, properties=None
) -> P.PlanNode:
    """The IterativeOptimizer pass: cost-compare alternative join-region
    orders, then explore commutation/rotation/distribution through the
    memo and extract the cheapest plan."""
    ndev = 1
    if properties is not None and properties.get("distributed"):
        ndev = properties.get("num_devices") or 8

    # 1. region orders: for each maximal inner-join region, cost the
    # greedy order against orders grown from other anchors and keep the
    # winner (ReorderJoins explored; the r3 greedy pick becomes one
    # candidate among several)
    def best_region(n: P.PlanNode, in_region: bool = False) -> P.PlanNode:
        is_region = isinstance(n, P.Join) and n.kind in ("inner", "cross")
        new_sources = tuple(
            best_region(s, in_region=is_region) for s in n.sources
        )
        n = _replace_sources(n, new_sources) if n.sources else n
        if not is_region or in_region:
            # only maximal region roots re-order: a nested rewrite could
            # insert a residual Filter mid-region and split it
            return n
        candidates = [n] + region_order_alternatives(n, metadata)
        if len(candidates) == 1:
            return n
        stats = StatsProvider(metadata, ndev)
        model = CostModel(stats)
        costed = []
        for c in candidates:
            try:
                # uniform physical flags before costing: a fresh rebuild
                # with default expansion=False must not out-cost the
                # incumbent purely by missing its derived flags
                c = _choose_build_sides(c, metadata)
                c = _choose_join_distribution(c, metadata, properties)
                costed.append((model.cumulative(c).total, c))
            except Exception:
                continue
        if not costed:
            return n
        costed.sort(key=lambda t: t[0])
        return costed[0][1]

    from .optimizer import _choose_build_sides, _choose_join_distribution

    reorder = True
    if properties is not None:
        reorder = bool(properties.get("reorder_joins"))
    if reorder:
        try:
            plan = best_region(plan)
            # region rebuilds mint fresh Join nodes: re-derive the
            # physical flags (expansion kernel, default distribution)
            # before exploring
            plan = _choose_build_sides(plan, metadata)
            plan = _choose_join_distribution(plan, metadata, properties)
        except Exception:
            pass  # ordering must never lose a query; explore the seed

    # 2. memo exploration for side/distribution/rotation alternatives
    try:
        chosen, _info = explore(plan, metadata, properties)
        return chosen
    except Exception:
        # exploration must never lose a query: fall back to the seed
        return plan


def region_order_alternatives(
    plan: P.PlanNode, metadata: Metadata, max_orders: int = 3
) -> List[P.PlanNode]:
    """Alternative left-deep orders for the top inner-join region rooted
    at `plan` — seeded into the memo so extraction cost-compares real
    orders, not only single rotations.  Greedy smallest-first from the
    top-k largest anchors (ReorderJoins' exploration bounded the
    pragmatic way)."""
    from .optimizer import _estimate_rows

    if not (isinstance(plan, P.Join) and plan.kind in ("inner", "cross")):
        return []
    leaves: List[P.PlanNode] = []
    criteria: List[Tuple[str, str]] = []
    residuals: List[ir.Expr] = []

    def flatten(n: P.PlanNode):
        if isinstance(n, P.Join) and n.kind in ("inner", "cross"):
            flatten(n.left)
            flatten(n.right)
            criteria.extend(n.criteria)
            if n.filter is not None:
                residuals.extend(_conjuncts(n.filter))
        else:
            leaves.append(n)

    flatten(plan)
    if len(leaves) <= 2 or len(leaves) > 8:
        return []
    sym_of = [set(l.output_symbols()) for l in leaves]
    est = [_estimate_rows(l, metadata) for l in leaves]
    anchors = sorted(range(len(leaves)), key=lambda i: -est[i])[:max_orders]
    out = []
    for start in anchors:
        built = _left_deep_from(
            leaves, sym_of, est, criteria, residuals, start, plan
        )
        if built is not None:
            out.append(built)
    return out


def _left_deep_from(leaves, sym_of, est, criteria, residuals, start, plan):
    placed = {start}
    cur_syms = set(sym_of[start])
    result = leaves[start]
    unused = list(criteria)

    def edges_to(i):
        return [
            (a, b) for a, b in unused
            if (a in cur_syms and b in sym_of[i])
            or (b in cur_syms and a in sym_of[i])
        ]

    while len(placed) < len(leaves):
        open_idx = [i for i in range(len(leaves)) if i not in placed]
        connectable = [i for i in open_idx if edges_to(i)]
        pick_from = connectable or open_idx
        nxt = min(pick_from, key=lambda i: est[i])
        edges = edges_to(nxt)
        oriented = tuple(
            (a, b) if a in cur_syms else (b, a) for a, b in edges
        )
        for e in edges:
            unused.remove(e)
        result = P.Join(
            "inner" if oriented else "cross", result, leaves[nxt], oriented
        )
        placed.add(nxt)
        cur_syms |= sym_of[nxt]
    types = plan.output_types()
    rest = residuals + [
        ir.Comparison(
            "=", ir.ColumnRef(types[a], a), ir.ColumnRef(types[b], b)
        )
        for a, b in unused
    ]
    if rest:
        combined = rest[0] if len(rest) == 1 else ir.Logical(
            "and", tuple(rest)
        )
        return P.Filter(result, combined)
    return result

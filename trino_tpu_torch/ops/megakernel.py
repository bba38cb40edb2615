"""Fused scan->filter->aggregate megakernel: plan matching and compiler.

Counterpart of trino_tpu/ops/megakernel.py.  The whole Filter*/Project*/
Aggregate chain over a TableScan collapses into ONE launch of the CUDA
kernel ops/kernels.fused_agg_sums, which streams every referenced scan
column once and accumulates every (term, group) sum.

The fusion decisions are the JAX package's, unchanged: the same matcher,
the same interval proofs (every intermediate fits int32, each term sum
fits its chunk bound TERM_MAX, one level of 16-bit limb split for
oversized products against a <= 15-bit factor, whole-table sums below
2^62), the same Reject rules, MAX_GROUPS = 32 and the same accumulator
layout, so fusedAggregates / fusionRejects and the output pages match
the reference.  What differs is what the compiler emits: where the TPU
kernel traced a Python closure into Mosaic, this compiler emits a
postfix program over int32 values (ops/kernels.Program), which
ops/kernels.encode turns into the straight-line program the one
prebuilt CUDA kernel runs (constants folded, common subexpressions
shared, slots allocated), and whose plain version evaluates the same
program with torch ops over whole columns.

Anything unproven raises Reject and the executor falls back to the
unfused path -- fusion is an optimization, never a semantics change.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

from ..cache.compile_cache import fragment_family
from ..expr import ir
from ..plan import nodes as P
from . import aggregation as agg_ops
from . import kernels as pk
from . import wide_decimal as wd

I32_MAX = 2 ** 31 - 1
# the JAX package's per-chunk term bound (its [2048, 128] tiles summed
# in int32), kept so that fusion decisions and term layouts agree with
# the reference; the CUDA kernel itself sums in int64
CHUNK_ROWS = 2048
TERM_MAX = I32_MAX // CHUNK_ROWS
# whole-table int64 sum headroom: rows * bound must stay below this
SUM_GATE = 2 ** 62
# short factor cap for the limb split: 0xFFFF * LIMB_B_MAX < 2^31
LIMB_B_MAX = 32767

FUSABLE_KINDS = ("sum", "avg", "count", "count_star")

_CMP = {
    "=": pk.EQ,
    "<>": pk.NE,
    "!=": pk.NE,
    "is_distinct": pk.NE,  # exact: inputs proven null-free
    "<": pk.LT,
    "<=": pk.LE,
    ">": pk.GT,
    ">=": pk.GE,
}


class Reject(Exception):
    """Fusion not applicable; the message lands in kernel_profile."""


def _scale(t) -> int:
    return int(t.scale) if getattr(t, "is_decimal", False) else 0


_INT_KINDS = ("bigint", "integer", "smallint", "tinyint", "date",
              "time", "timestamp")


def _int_kind(t) -> bool:
    return bool(getattr(t, "is_decimal", False)) or t.name in _INT_KINDS


# postfix code while compiling: (op, imm) pairs; LOAD's immediate is the
# scan symbol, resolved to a column index once the column list is known
Code = Tuple[Tuple[int, object], ...]


@dataclasses.dataclass
class _CV:
    """A compiled kernel value: postfix ``code`` leaving one int32 plus
    the interval [lo, hi] and decimal scale proven at plan time."""

    code: Code
    lo: int
    hi: int
    scale: int


def _check32(lo: int, hi: int, what: str) -> None:
    if lo < -I32_MAX or hi > I32_MAX:
        raise Reject(f"{what} interval [{lo}, {hi}] exceeds int32")


class _Compiler:
    """Restricted Expr -> in-kernel int32 compiler with interval
    arithmetic.  ``env`` maps scan symbols to their stats-proven
    bounds; every column touched is recorded in ``used`` so the runner
    uploads exactly the referenced tiles."""

    def __init__(self, env: Dict[str, dict]):
        self.env = env
        self.used: List[str] = []

    # -- columns -------------------------------------------------------
    def _info(self, name: str) -> dict:
        info = self.env.get(name)
        if info is None:
            raise Reject(f"column {name} lacks null-free bounded stats")
        return info

    def col(self, name: str) -> _CV:
        info = self._info(name)
        if info.get("dict"):
            raise Reject(f"dictionary column {name} in value position")
        if name not in self.used:
            self.used.append(name)
        return _CV(((pk.LOAD, name),), info["lo"], info["hi"], info["scale"])

    # -- values --------------------------------------------------------
    def value(self, e: ir.Expr) -> _CV:
        if isinstance(e, ir.ColumnRef):
            if e.type.name == "boolean":
                raise Reject("boolean column in value position")
            return self.col(e.name)
        if isinstance(e, ir.Constant):
            if e.value is None:
                raise Reject("NULL constant")
            v = int(e.value)
            _check32(v, v, "constant")
            return _CV(((pk.CONST, v),), v, v, _scale(e.type))
        if isinstance(e, ir.Cast):
            if not (_int_kind(e.type) and _int_kind(e.term.type)):
                raise Reject(f"cast to {e.type.name}")
            return self._rescaled(self.value(e.term), _scale(e.type))
        if isinstance(e, ir.Call):
            return self._call(e)
        raise Reject(f"unfusable value node {type(e).__name__}")

    def _rescaled(self, cv: _CV, scale: int) -> _CV:
        k = scale - cv.scale
        if k < 0:
            raise Reject("rescale down (rounding) in kernel")
        if k == 0:
            return dataclasses.replace(cv, scale=scale)
        m = 10 ** k
        lo, hi = cv.lo * m, cv.hi * m
        _check32(lo, hi, "rescale")
        return _CV(cv.code + ((pk.CONST, m), (pk.MUL, 0)), lo, hi, scale)

    def _call(self, e: ir.Call) -> _CV:
        s = _scale(e.type)
        if e.name in ("add", "subtract"):
            l = self._rescaled(self.value(e.args[0]), s)
            r = self._rescaled(self.value(e.args[1]), s)
            if e.name == "add":
                lo, hi = l.lo + r.lo, l.hi + r.hi
                op = pk.ADD
            else:
                lo, hi = l.lo - r.hi, l.hi - r.lo
                op = pk.SUB
            _check32(lo, hi, e.name)
            return _CV(l.code + r.code + ((op, 0),), lo, hi, s)
        if e.name == "negate":
            v = self.value(e.args[0])
            v = self._rescaled(v, s)
            return _CV(v.code + ((pk.NEG, 0),), -v.hi, -v.lo, s)
        if e.name == "multiply":
            l = self.value(e.args[0])
            r = self.value(e.args[1])
            corners = [l.lo * r.lo, l.lo * r.hi, l.hi * r.lo, l.hi * r.hi]
            lo, hi = min(corners), max(corners)
            _check32(lo, hi, "product")
            prod = _CV(
                l.code + r.code + ((pk.MUL, 0),), lo, hi, l.scale + r.scale,
            )
            return self._rescaled(prod, s)
        raise Reject(f"unfusable call {e.name}")

    # -- predicates ----------------------------------------------------
    def pred(self, e: ir.Expr):
        if isinstance(e, ir.Logical):
            codes = [self.pred(t) for t in e.terms]
            if e.op == "and":
                return _fold(codes, True)
            if e.op == "or":
                return _fold(codes, False)
            raise Reject(f"logical op {e.op}")
        if isinstance(e, ir.Not):
            return self.pred(e.term) + ((pk.NOT, 0),)
        if isinstance(e, ir.Comparison):
            return self._cmp(e.op, e.left, e.right)
        if isinstance(e, ir.Between):
            lo = self._cmp("<=", e.low, e.value)
            hi = self._cmp("<=", e.value, e.high)
            both = lo + hi + ((pk.AND, 0),)
            if e.negate:
                return both + ((pk.NOT, 0),)
            return both
        if isinstance(e, ir.In):
            if not all(isinstance(i, ir.Constant) for i in e.items):
                raise Reject("IN over non-constant items")
            eqs = [self._cmp("=", e.value, i) for i in e.items]
            if e.negate:
                return _fold(eqs, False) + ((pk.NOT, 0),)
            return _fold(eqs, False)
        if isinstance(e, ir.Constant) and e.type.name == "boolean":
            if e.value is None:
                raise Reject("NULL boolean constant")
            return ((pk.CONST, int(bool(e.value))),)
        if isinstance(e, ir.ColumnRef) and e.type.name == "boolean":
            info = self._info(e.name)
            if not info.get("bool"):
                raise Reject("boolean column lacks stats")
            if e.name not in self.used:
                self.used.append(e.name)
            return ((pk.LOAD, e.name), (pk.CONST, 0), (pk.NE, 0))
        raise Reject(f"unfusable predicate node {type(e).__name__}")

    def _cmp(self, op: str, left: ir.Expr, right: ir.Expr):
        cmp = _CMP.get(op)
        if cmp is None:
            raise Reject(f"comparison op {op}")
        l = self.value(left)
        r = self.value(right)
        m = max(l.scale, r.scale)
        l = self._rescaled(l, m)
        r = self._rescaled(r, m)
        return l.code + r.code + ((cmp, 0),)

    # -- aggregate-input term decomposition ----------------------------
    def decompose(self, e: ir.Expr) -> Tuple[List[Tuple[Code, int]], int]:
        """Split one aggregate input into int32-safe (code, shift) terms
        whose shifted per-group sums recombine to the exact value sum.
        Returns (terms, value upper bound)."""
        try:
            cv = self.value(e)
        except Reject:
            cv = None
        terms: List[Tuple[Code, int]] = []
        if cv is not None:
            if cv.lo < 0:
                raise Reject("negative aggregate input")
            _planes(cv.code, cv.hi, 0, terms)
            return terms, cv.hi
        # one oversized level allowed: a product whose long factor fits
        # int32 and whose short factor fits 15 bits -- split the long
        # factor into 16-bit limbs, multiply each by the short factor
        if not (isinstance(e, ir.Call) and e.name == "multiply"
                and len(e.args) == 2):
            raise Reject("aggregate input exceeds int32 and is no product")
        a = self.value(e.args[0])
        b = self.value(e.args[1])
        if a.hi < b.hi:
            a, b = b, a
        k = _scale(e.type) - (a.scale + b.scale)
        if k < 0:
            raise Reject("oversized product rescales down")
        b = self._rescaled(b, b.scale + k)  # fold 10^k into short factor
        if a.lo < 0 or b.lo < 0:
            raise Reject("negative factor in oversized product")
        if b.hi > LIMB_B_MAX:
            raise Reject("no short factor for limb split")
        hi_lo = 0xFFFF * b.hi
        hi_hi = (a.hi >> 16) * b.hi
        _check32(0, max(hi_lo, hi_hi), "limb product")
        p_lo = a.code + ((pk.LO16, 0),) + b.code + ((pk.MUL, 0),)
        p_hi = a.code + ((pk.HI16, 0),) + b.code + ((pk.MUL, 0),)
        _planes(p_lo, hi_lo, 0, terms)
        _planes(p_hi, hi_hi, 16, terms)
        return terms, a.hi * b.hi


def _planes(code: Code, hi: int, shift: int, out: list) -> None:
    """Append code as one raw term, or as two 16-bit planes when one
    chunk-column of raw values could wrap int32 (the reference's rule)."""
    if hi <= TERM_MAX:
        out.append((code, shift))
        return
    out.append((code + ((pk.LO16, 0),), shift))
    out.append((code + ((pk.HI16, 0),), shift + 16))


def _fold(codes, conj: bool) -> Code:
    """Left fold of predicate codes with AND (conj) or OR."""
    acc: Code = ()
    for c in codes:
        acc = c if not acc else acc + c + (((pk.AND if conj else pk.OR), 0),)
    return acc


def _conjuncts(e: ir.Expr) -> List[ir.Expr]:
    if isinstance(e, ir.Logical) and e.op == "and":
        out: List[ir.Expr] = []
        for t in e.terms:
            out.extend(_conjuncts(t))
        return out
    return [e]


# ----------------------------------------------------------------------
# matcher


def _match(ctx, node: P.Aggregate):
    if node.step not in ("single", "partial"):
        raise Reject(f"step {node.step}")
    if not node.aggs:
        raise Reject("no aggregates")
    for a in node.aggs:
        if a.distinct:
            raise Reject("DISTINCT aggregate")
        if a.kind not in FUSABLE_KINDS:
            raise Reject(f"aggregate kind {a.kind}")
    if getattr(ctx.lowering, "force_wide_mul", False):
        raise Reject("wide-multiply retry rung")
    chain: List[P.PlanNode] = []
    cur = node.source
    while isinstance(cur, (P.Project, P.Filter)):
        chain.append(cur)
        cur = cur.source
    if not isinstance(cur, P.TableScan):
        raise Reject("source is not a Filter/Project chain over a scan")
    scan = cur
    if any(getattr(t, "is_array", False) or getattr(t, "is_map", False)
           for _, t in scan.types):
        raise Reject("array or map lane")  # its functions run on the host
    # compose the chain bottom-up into expressions over scan symbols
    mapping: Dict[str, ir.Expr] = {
        s: ir.ColumnRef(t, s) for s, t in scan.types
    }
    preds: List[ir.Expr] = []
    for nd in reversed(chain):
        if isinstance(nd, P.Filter):
            preds.extend(_conjuncts(ir.replace_refs(nd.predicate, mapping)))
        else:
            mapping = {
                s: ir.replace_refs(e, mapping) for s, e in nd.assignments
            }
    return scan, mapping, preds


def _column_env(ex, scan: P.TableScan, types) -> Tuple[Dict[str, dict], object]:
    try:
        stats = ex.metadata.table_statistics(scan.catalog, scan.table)
    except Exception:
        raise Reject("no table statistics")
    env: Dict[str, dict] = {}
    for sym, col in scan.assignments:
        t = types[sym]
        cs = stats.columns.get(col)
        if cs is None or cs.null_fraction:
            continue  # unusable: any reference rejects fusion
        if t.is_dictionary:
            env[sym] = {"dict": True}
            continue
        if t.name == "boolean":
            env[sym] = {"lo": 0, "hi": 1, "scale": 0, "bool": True}
            continue
        if cs.min_value is None or cs.max_value is None:
            continue
        lo, hi, scale = cs.min_value, cs.max_value, _scale(t)
        if scale and not cs.decimal_lanes:
            # value units (ANALYZE, parquet footers): the proofs read the
            # lanes, value x 10^scale; floor/ceil keep the bounds outside
            lo, hi = lo * 10 ** scale, hi * 10 ** scale
        lo = int(math.floor(lo))
        hi = int(math.ceil(hi))
        if lo < -I32_MAX or hi > I32_MAX:
            continue
        env[sym] = {"lo": lo, "hi": hi, "scale": scale}
    return env, stats


def _key_domains(ex, node: P.Aggregate, mapping, types, env):
    """Mixed-radix dense grouping over dictionary/boolean scan columns
    -- the in-kernel mirror of ops/aggregation.direct_group_ids (radix
    dom+1 per key keeps the unfused NULL slot layout, so capacities and
    group ids agree exactly with the fallback path)."""
    doms: List[Tuple[str, str, int]] = []
    cap = 1
    for k in node.keys:
        e = mapping.get(k)
        if not isinstance(e, ir.ColumnRef):
            raise Reject(f"group key {k} is not a scan column")
        sk = e.name
        info = env.get(sk)
        if info is None:
            raise Reject(f"group key {sk} lacks null-free stats")
        if info.get("dict"):
            d = ex.dicts.get(sk)
            if d is None or len(d) == 0:
                raise Reject(f"no dictionary for key {sk}")
            dom = len(d)
        elif info.get("bool"):
            dom = 2
        else:
            raise Reject(f"group key {sk} is not low-cardinality")
        doms.append((k, sk, dom))
        cap *= dom + 1
    if node.keys and cap > pk.MAX_GROUPS:
        raise Reject(f"group capacity {cap} > {pk.MAX_GROUPS}")
    return doms, (cap if node.keys else 1)


# ----------------------------------------------------------------------
# entry point


def try_fused(ctx, node: P.Aggregate):
    """Attempt the fused megakernel for this Aggregate; returns the
    finished Batch or None (caller runs the unfused path)."""
    ex = ctx.ex
    if ex._megakernel_mode() != "on":
        return None
    try:
        return _run(ctx, node)
    except Reject as r:
        prof = ex.kernel_profile
        prof["fusionRejects"] = prof.get("fusionRejects", 0) + 1
        prof["lastFusionReject"] = str(r)
        from ..obs import journal

        # the doctor's fusion_reject evidence
        journal.emit(journal.FUSION_REJECT, query_id=ex.query_id or "",
                     reason=str(r)[:200])
        return None


def _resolve(code: Code, index: Dict[str, int]) -> Tuple[Tuple[int, int], ...]:
    """Compile-time code -> kernel code: LOAD symbols become column
    indices into the kernel's column list."""
    return tuple(
        (op, index[imm] if op == pk.LOAD else int(imm)) for op, imm in code
    )


def _run(ctx, node: P.Aggregate):
    ex = ctx.ex
    scan, mapping, preds = _match(ctx, node)
    types = dict(scan.types)
    env, stats = _column_env(ex, scan, types)
    doms, cap = _key_domains(ex, node, mapping, types, env)

    comp = _Compiler(env)
    pred_codes = [comp.pred(p) for p in preds]

    # term 0 is always the live-row count (the $valid/$count lane every
    # fused kind shares); value terms append after it, deduplicated by
    # structural expression equality (sum+avg over one column share)
    terms: List[Tuple[Code, int]] = [(((pk.CONST, 1),), 0)]
    rows_bound = max(int(stats.row_count), 1) + 256  # pad-capacity slack
    input_terms: Dict[ir.Expr, List[Tuple[int, int]]] = {}
    plans: List[Optional[List[Tuple[int, int]]]] = []
    for a in node.aggs:
        if a.kind == "count_star":
            plans.append(None)
            continue
        e = mapping.get(a.arg)
        if e is None:
            raise Reject(f"aggregate arg {a.arg} escapes the fused chain")
        if a.kind == "count":
            # null-free inputs make count(x) == count(live rows); only
            # prove the references are null-free, no value needed
            for c in ir.referenced_columns(e):
                if env.get(c) is None:
                    raise Reject(f"count over unproven column {c}")
            plans.append(None)
            continue
        slots = input_terms.get(e)
        if slots is None:
            tlist, hi = comp.decompose(e)
            if rows_bound * hi >= SUM_GATE:
                raise Reject("table-wide sum could exceed int64")
            slots = []
            for code, sh in tlist:
                slots.append((len(terms), sh))
                terms.append((code, sh))
            input_terms[e] = slots
        plans.append(slots)

    # the kernel reads each referenced column plus the key columns once
    names = list(comp.used)
    for _k, sk, _dom in doms:
        if sk not in names:
            names.append(sk)
    index = {nm: i for i, nm in enumerate(names)}
    gid_code: Code = ()
    for _k, sk, dom in doms:
        key = ((pk.LOAD, sk), (pk.CLIP, dom))
        gid_code = key if not gid_code else (
            gid_code + ((pk.CONST, dom + 1), (pk.MUL, 0)) + key
            + ((pk.ADD, 0),)
        )
    prog = pk.Program(
        _resolve(_fold(pred_codes, True), index),
        _resolve(gid_code, index),
        tuple(_resolve(code, index) for code, _sh in terms),
    )
    # checked and encoded once a process (cache/compile_cache.py): a
    # warm run finds the program and encodes nothing
    try:
        comp = ex.compile_cache.program(
            prog, len(names), cap, family=lambda: fragment_family(node),
            query_id=ex.query_id)
    except ValueError as err:
        raise Reject(f"kernel limits: {err}")

    # -- runner ----------------------------------------------------------
    # the kernel reads the int64/int32 lanes, their validity lanes and
    # the selection as the scan holds them (narrowing and the validity
    # AND happen in the kernel, as the reference's runner does them)
    b = ctx.visit(scan)
    cols, valids = [], []
    for nm in names:
        v, ok = b.lanes[nm]
        if v.dim() != 1 or v.is_floating_point() or v.dtype == torch.bool:
            raise Reject(f"column {nm} lane is not a narrow integer")
        if v.dtype not in (torch.int32, torch.int64):
            v = v.to(torch.int32)  # 8/16-bit lanes widen exactly
        cols.append(v)
        valids.append(ok)

    n_terms = len(terms)
    sums = pk.fused_agg_sums(cols, valids, b.sel, comp, cap)
    cnt = sums[0]

    specs = [a.to_spec() for a in node.aggs]
    accs: Dict[str, torch.Tensor] = {}
    for s, slots in zip(specs, plans):
        o = s.output
        if slots is None:  # count / count_star
            accs[f"{o}$count"] = cnt
            continue
        val = torch.zeros_like(cnt)
        for i, sh in slots:
            val = val + (sums[i] << sh)
        if s._wide_sum:
            # narrow fast path of the wide accumulator schema: the sum
            # is proven to fit int64, carried as 32-bit chunk lanes
            cs = wd.normalize_chunks([
                val & 0xFFFFFFFF, val >> 32,
                torch.zeros_like(val), torch.zeros_like(val),
            ])
            for i, c in enumerate(cs):
                accs[f"{o}$c{i}"] = c
            accs[f"{o}$valid" if s.kind == "sum" else f"{o}$count"] = cnt
        elif s.kind == "sum":
            accs[f"{o}$val"] = val
            accs[f"{o}$valid"] = cnt
        else:  # narrow avg
            accs[f"{o}$sum"] = val
            accs[f"{o}$count"] = cnt

    if node.step == "partial":
        out = {
            nm: (v, torch.ones(v.shape, dtype=torch.bool, device=v.device))
            for nm, v in accs.items()
        }
    else:
        out = agg_ops.finalize(specs, accs)

    keys_out = []
    dev = cnt.device
    if node.keys:
        # arithmetic key decode: slot -> per-key dictionary codes (the
        # mixed-radix inverse of the in-kernel gid); code == dom is the
        # never-hit NULL slot, masked by present anyway
        rem = torch.arange(cap, dtype=torch.int64, device=dev)
        codes: List[torch.Tensor] = [None] * len(doms)  # type: ignore
        for i in range(len(doms) - 1, -1, -1):
            radix = doms[i][2] + 1
            codes[i] = rem % radix
            rem = torch.div(rem, radix, rounding_mode="floor")
        for (k, sk, dom), code in zip(doms, codes):
            kv, _kok = b.lanes[sk]
            keys_out.append((code.to(kv.dtype), code < dom))
            if k != sk and sk in ex.dicts:
                ex.dicts.setdefault(k, ex.dicts[sk])
        present = cnt > 0
    else:
        present = torch.ones(1, dtype=torch.bool, device=dev)

    prof = ex.kernel_profile
    prof["fusedAggregates"] = prof.get("fusedAggregates", 0) + 1
    prof["fusedTerms"] = prof.get("fusedTerms", 0) + n_terms
    ex._record_kernel(
        "megakernel:%s/t%d/g%d" % (scan.table, n_terms, cap),
        0.0, True, mode="megakernel",
    )
    return ctx._finish_aggregate(node, keys_out, out, present, cap)

"""Module-level parity of the port (trino_tpu_torch) with the JAX package.

Each ported module runs on the same seeded numpy inputs as its JAX
counterpart: expression lowering (three-valued logic, decimal rescale
and rounding), the emulated 128-bit arithmetic and wide decimals (wrap
and unsigned cases), aggregation accumulate/finalize, sort permutations,
the TPC-H generator and the page conversion.  Every comparison is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trino_tpu.connectors.tpch as jtpch
import trino_tpu.expr.functions as jfn
import trino_tpu.expr.ir as jir
import trino_tpu.expr.lower as jlow
import trino_tpu.ops.aggregation as jagg
import trino_tpu.ops.int128 as ji128
import trino_tpu.ops.sort as jsort
import trino_tpu.ops.wide_decimal as jwd
import trino_tpu.page as jpage
import trino_tpu.types as jT
import trino_tpu_torch.connectors.tpch as ttpch
import trino_tpu_torch.expr.functions as tfn
import trino_tpu_torch.expr.ir as tir
import trino_tpu_torch.expr.lower as tlow
import trino_tpu_torch.ops.aggregation as tagg
import trino_tpu_torch.ops.int128 as ti128
import trino_tpu_torch.ops.sort as tsort
import trino_tpu_torch.ops.wide_decimal as twd
import trino_tpu_torch.types as tT
from trino_tpu_torch import convert

N = 997
SIDES = {
    "jax": (jir, jT, jfn, jlow, jnp.asarray),
    "torch": (tir, tT, tfn, tlow, torch.as_tensor),
}
DICT = np.array(["apple", "kiwi", "melon", "zest"], dtype=object)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _lanes_np(seed=0):
    rng = np.random.default_rng(seed)

    def ok():
        return rng.random(N) < 0.85

    return {
        "a": (rng.integers(-20, 20, N).astype(np.int64), ok()),
        "b": (rng.integers(-5, 30, N).astype(np.int64), ok()),
        "d": (rng.integers(-99_999, 99_999, N).astype(np.int64), ok()),
        "e": (rng.integers(-9_999_999, 9_999_999, N).astype(np.int64), ok()),
        "s": (rng.integers(0, len(DICT), N).astype(np.int32), ok()),
        "f": (rng.random(N) < 0.5, ok()),
        "dt": (rng.integers(8000, 11000, N).astype(np.int32), ok()),
    }


def _exprs(ir, T, fn):
    """The same expression set built with either package's IR."""
    D2, D4 = T.decimal(12, 2), T.decimal(12, 4)
    col = {
        "a": ir.ColumnRef(T.BIGINT, "a"), "b": ir.ColumnRef(T.BIGINT, "b"),
        "d": ir.ColumnRef(D2, "d"), "e": ir.ColumnRef(D4, "e"),
        "s": ir.ColumnRef(T.VARCHAR, "s"), "f": ir.ColumnRef(T.BOOLEAN, "f"),
        "dt": ir.ColumnRef(T.DATE, "dt"),
    }
    k = lambda t, v: ir.Constant(t, v)  # noqa: E731
    gt = ir.Comparison(">", col["a"], k(T.BIGINT, 0))
    lt = ir.Comparison("<", col["b"], k(T.BIGINT, 5))

    def call(name, x, y):
        return ir.Call(fn.arith_result_type(name, x.type, y.type), name, (x, y))

    return {
        "kleene_and_or": ir.Logical("or", (ir.Logical("and", (gt, col["f"])), lt)),
        "not": ir.Not(col["f"]),
        "is_null": ir.IsNull(col["a"]),
        "is_not_null": ir.IsNull(col["b"], negate=True),
        "between_decimal": ir.Between(col["d"], k(T.decimal(4, 2), -505),
                                      k(T.decimal(4, 2), 707)),
        "in_with_null": ir.In(col["a"], (k(T.BIGINT, 1), k(T.BIGINT, 2),
                                         k(T.BIGINT, None))),
        "not_in": ir.In(col["b"], (k(T.BIGINT, 3), k(T.BIGINT, 7)), negate=True),
        "rescale_down_rounds": ir.Cast(D2, col["e"]),
        "rescale_up": ir.Cast(D4, col["d"]),
        "decimal_to_int_rounds": ir.Cast(T.BIGINT, col["d"]),
        "decimal_to_double": ir.Cast(T.DOUBLE, col["e"]),
        "add_mixed": call("add", col["d"], col["a"]),
        "subtract": call("subtract", col["e"], col["d"]),
        "multiply": call("multiply", col["d"], col["e"]),
        "divide_rounds": call("divide", col["d"], col["e"]),
        "divide_bigint": call("divide", col["a"], col["b"]),
        "negate": ir.Call(D2, "negate", (col["d"],)),
        "case": ir.Case(D4, (ir.WhenClause(gt, col["d"]),), col["e"]),
        "dict_eq": ir.Comparison("=", col["s"], k(T.VARCHAR, "melon")),
        "dict_lt": ir.Comparison("<", col["s"], k(T.VARCHAR, "l")),
        "dict_in": ir.In(col["s"], (k(T.VARCHAR, "kiwi"), k(T.VARCHAR, "zest"))),
        "year": ir.Call(T.BIGINT, "year", (col["dt"],)),
        "like": ir.Call(T.BOOLEAN, "like", (col["s"], k(T.VARCHAR, "%e%"))),
    }


def _eval(side, name):
    ir, T, fn, low, arr = SIDES[side]
    lanes = {c: (arr(v), arr(ok)) for c, (v, ok) in _lanes_np().items()}
    ctx = low.LoweringContext({"s": DICT})
    return low.compile_expr(_exprs(ir, T, fn)[name], ctx)(lanes)


@pytest.mark.parametrize("name", sorted(_exprs(tir, tT, tfn)))
def test_lowering_matches_jax(name):
    jv, jok = _eval("jax", name)
    tv, tok = _eval("torch", name)
    jok, tok = _np(jok), _np(tok)
    assert np.array_equal(jok, tok)
    jv, tv = _np(jv), _np(tv)
    if jv.ndim == 0:
        jv = np.broadcast_to(jv, tok.shape)
    assert jv.dtype == tv.dtype, (jv.dtype, tv.dtype)
    assert np.array_equal(jv[jok], tv[tok])


# -- int128 / wide decimal ------------------------------------------------

EDGE = np.array([0, 1, -1, 2**63 - 1, -(2**63), 2**62, -(2**62) - 7,
                 0x7FFFFFFF, -0x80000000, 0xFFFFFFFF, 10**18, -(10**18)],
                dtype=np.int64)


def _i64(seed, n=256):
    rng = np.random.default_rng(seed)
    r = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64, endpoint=True)
    return np.concatenate([EDGE, r])


def _wide(seed, n=256):
    lo, hi = _i64(seed, n), _i64(seed + 1, n)
    hi[:len(EDGE)] = EDGE[::-1]
    return np.stack([lo, hi >> np.int64(1)], axis=-1)  # keep |w| < 2^126


def _both(fn_j, fn_t, *args):
    return _np(fn_j(*[jnp.asarray(a) for a in args])), \
        _np(fn_t(*[torch.as_tensor(a) for a in args]))


@pytest.mark.parametrize("case", [
    "umul128", "udiv128_64", "mul_shift_div_round", "add", "negate",
    "subtract", "rescale", "div_round", "decimal_rescale_wide_down",
    "mul_wide", "compare", "chunks", "to_double",
])
def test_int128_and_wide_decimal_match_jax(case):
    a, b = _i64(1), _i64(2)
    w1, w2 = _wide(3), _wide(5)
    pos = np.abs(_i64(4) >> np.int64(2)) + 1
    if case == "umul128":
        got = [_both(ji128.umul128, ti128.umul128, a, b)]
        got[0] = (np.stack([np.asarray(x, np.int64) for x in got[0][0]]),
                  np.stack([np.asarray(x) for x in got[0][1]]))
    elif case == "udiv128_64":
        hi = np.abs(a) % pos  # quotient fits 64 bits
        jq = ji128.udiv128_64(jnp.asarray(hi).astype(jnp.uint64),
                              jnp.asarray(b).astype(jnp.uint64), jnp.asarray(pos))
        tq = ti128.udiv128_64(torch.as_tensor(hi), torch.as_tensor(b),
                              torch.as_tensor(pos))
        got = [(np.stack([np.asarray(x).astype(np.int64) for x in jq]),
                np.stack([_np(x) for x in tq]))]
    elif case == "mul_shift_div_round":
        den = np.where(b == 0, 3, b)
        got = [_both(lambda x, d: ji128.mul_shift_div_round(x, 10**6, d),
                     lambda x, d: ti128.mul_shift_div_round(x, 10**6, d),
                     a >> np.int64(20), den)]
    elif case in ("add", "subtract"):
        got = [_both(getattr(jwd, case), getattr(twd, case), w1, w2)]
    elif case == "negate":
        got = [_both(jwd.negate, twd.negate, w1)]
    elif case == "rescale":
        got = [_both(lambda w: jwd.rescale(w, k), lambda w: twd.rescale(w, k),
                     w1 >> np.int64(40)) for k in (1, 6, 18)]
    elif case == "div_round":
        got = [_both(jwd.div_round, twd.div_round, w1, pos)]
    elif case == "decimal_rescale_wide_down":
        got = [_both(lambda w: jwd.decimal_rescale_wide(w, k, 2),
                     lambda w: twd.decimal_rescale_wide(w, k, 2), w1)
               for k in (3, 8, 21)]
    elif case == "mul_wide":
        got = [_both(lambda x, y: jwd.mul_wide(x, y, k),
                     lambda x, y: twd.mul_wide(x, y, k),
                     a >> np.int64(2), b) for k in (0, 4, 20)]
    elif case == "compare":
        got = [_both(lambda x, y: jwd.compare(x, y, op),
                     lambda x, y: twd.compare(x, y, op), w1, w2)
               for op in ("<", "<=", ">", ">=", "==", "!=")]
    elif case == "chunks":
        sums = [(a >> np.int64(2)), b >> np.int64(2), a >> np.int64(3), b >> np.int64(40)]
        got = [_both(lambda *c: jwd.chunks_to_wide(jwd.normalize_chunks(list(c))),
                     lambda *c: twd.chunks_to_wide(twd.normalize_chunks(list(c))),
                     *sums)]
    else:
        got = [_both(jwd.to_double, twd.to_double, w1)]
    for j, t in got:
        assert np.array_equal(np.asarray(j).astype(t.dtype), t)


def test_wide_python_int_roundtrip_matches_jax():
    for x in (0, -1, 2**64, -(2**100) + 12345, 10**38 - 1):
        assert twd.from_python_int(x) == jwd.from_python_int(x)


# -- aggregation -------------------------------------------------------------


def _specs(agg, T):
    D2 = T.decimal(12, 2)
    return [
        agg.AggSpec("count_star", None, "cs"),
        agg.AggSpec("count", "a", "ca", T.BIGINT, T.BIGINT),
        agg.AggSpec("sum", "a", "sa", T.BIGINT, T.BIGINT),
        agg.AggSpec("sum", "d", "sd", D2, T.decimal(38, 2)),
        agg.AggSpec("avg", "d", "ad", D2, T.decimal(18, 6)),
        agg.AggSpec("avg", "a", "aa", T.BIGINT, T.DOUBLE),
        agg.AggSpec("min", "d", "mn", D2, D2),
        agg.AggSpec("max", "a", "mx", T.BIGINT, T.BIGINT),
    ]


@pytest.mark.parametrize("force_wide", [False, True])
def test_accumulate_finalize_match_jax(force_wide):
    lanes = _lanes_np(3)
    sel = np.random.default_rng(9).random(N) < 0.9
    out = {}
    for side, agg, T, arr in (("jax", jagg, jT, jnp.asarray),
                              ("torch", tagg, tT, torch.as_tensor)):
        ln = {c: (arr(v), arr(ok)) for c, (v, ok) in lanes.items()}
        gid, cap = agg.direct_group_ids([ln["s"], ln["f"]], [len(DICT), 2])
        specs = _specs(agg, T)
        accs = agg.accumulate(specs, ln, gid, arr(sel), cap,
                              force_wide=force_wide)
        fin = agg.finalize(specs, accs)
        keys = agg.group_keys_output([ln["s"], ln["f"]], gid, arr(sel), cap)
        out[side] = (_np(gid), {k: _np(v) for k, v in accs.items()},
                     {k: (_np(v), _np(ok)) for k, (v, ok) in fin.items()},
                     [(_np(v), _np(ok)) for v, ok in keys])
    (jg, ja, jf, jk), (tg, ta, tf, tk) = out["jax"], out["torch"]
    assert np.array_equal(jg, tg)
    assert ja.keys() == ta.keys()
    for k in ja:
        assert np.array_equal(ja[k], ta[k]), k
    for k in jf:
        (jv, jok), (tv, tok) = jf[k], tf[k]
        assert np.array_equal(jok, tok), k
        assert np.array_equal(jv[jok], tv[tok]), k
    for (jv, jok), (tv, tok) in zip(jk, tk):
        assert np.array_equal(jok, tok)
        assert np.array_equal(jv[jok], tv[tok])


# -- sort --------------------------------------------------------------------


@pytest.mark.parametrize("keys", [
    (("a", True, False),),
    (("a", False, True), ("d", True, False)),
    (("f", True, True), ("b", False, False), ("e", True, False)),
])
def test_sort_perm_matches_jax(keys):
    lanes = _lanes_np(5)
    sel = np.random.default_rng(4).random(N) < 0.8
    jl = {c: (jnp.asarray(v), jnp.asarray(ok)) for c, (v, ok) in lanes.items()}
    tl = {c: (torch.as_tensor(v), torch.as_tensor(ok)) for c, (v, ok) in lanes.items()}
    jp = jsort.sort_perm([jsort.SortKey(*k) for k in keys], jl, jnp.asarray(sel))
    tp = tsort.sort_perm([tsort.SortKey(*k) for k in keys], tl, torch.as_tensor(sel))
    assert np.array_equal(np.asarray(jp), tp.numpy())


def test_limit_and_topn_match_jax():
    lanes = _lanes_np(6)
    sel = np.random.default_rng(2).random(N) < 0.7
    jl = {c: (jnp.asarray(v), jnp.asarray(ok)) for c, (v, ok) in lanes.items()}
    tl = {c: (torch.as_tensor(v), torch.as_tensor(ok)) for c, (v, ok) in lanes.items()}
    _, jk = jsort.limit(jl, jnp.asarray(sel), 17, 5)
    _, tk = tsort.limit(tl, torch.as_tensor(sel), 17, 5)
    assert np.array_equal(np.asarray(jk), tk.numpy())
    key = [("e", False, False)]
    jo, js, _ = jsort.topn([jsort.SortKey(*k) for k in key], jl, jnp.asarray(sel), 25)
    to, ts, _ = tsort.topn([tsort.SortKey(*k) for k in key], tl, torch.as_tensor(sel), 25)
    assert np.array_equal(np.asarray(js), ts.numpy())
    for c in ("e", "a"):
        assert np.array_equal(np.asarray(jo[c][0]), to[c][0].numpy())


# -- TPC-H generator and page conversion ------------------------------------


@pytest.mark.parametrize("table", sorted(jtpch.SCHEMAS))
def test_tpch_generator_bit_identical(table):
    jv, jd, jn = jtpch.generate(table, 0.001)
    tv, td, tn = ttpch.generate(table, 0.001)
    assert jn == tn and jv.keys() == tv.keys() and jd.keys() == td.keys()
    for c in jv:
        assert jv[c].dtype == tv[c].dtype and np.array_equal(jv[c], tv[c]), c
    for c in jd:
        assert list(map(str, jd[c])) == list(map(str, td[c])), c


def test_page_conversion_round_trip():
    vals, dicts, count = jtpch.generate("lineitem", 0.001)
    schema = jtpch.SCHEMAS["lineitem"]
    jp = jpage.Page([jpage.Column(t, vals[c], None, dicts.get(c)) for c, t in schema],
                    count, [c for c, _ in schema])
    tp = convert.page_from_state(convert.page_state(jp))
    assert isinstance(tp, convert._page.Page)
    back = convert.page_from_state(convert.page_state(tp), page_module=jpage,
                                   parse_type=jT.parse_type)
    assert isinstance(back, jpage.Page)
    convert.assert_pages_identical(jp, tp)
    convert.assert_pages_identical(jp, back)
    assert tp.to_pylist()[:50] == jp.to_pylist()[:50]

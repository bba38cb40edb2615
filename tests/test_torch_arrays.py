"""The port's arrays, maps, lambdas, UNNEST and array-valued aggregates
against the JAX package.

Every test of tests/test_arrays.py and
tests/test_aggregates.py::test_array_map_listagg is replayed through both
packages' sessions (test_torch_dml.replay: the port on the CPU, pages
byte-identical, rejections alike, memory tables stored alike), and so
are statements over the TPC-H tables that reach the array functions,
UNNEST over real columns and the array-valued aggregates at more group
counts.  The module-level tests hold the building blocks to the JAX
functions on seeded inputs, empty arrays, NULL arrays, NULL elements and
all-NULL groups included: the lambda interpreter (arrays.eval_ir), the
UNNEST expansion (unnest_lanes against the JAX package's row walk), the
group-ordered host-staged aggregates (host_staged_lanes against
_host_agg_lanes), and convert.py's round trip of array and map pages.
"""
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trino_tpu.exec.local as jlocal
import trino_tpu.expr.arrays as jarrays
import trino_tpu.expr.ir as jir
import trino_tpu.ops.aggregation as jagg
import trino_tpu.page as jpage
import trino_tpu.plan.nodes as JP
import trino_tpu.types as JT
import trino_tpu_torch.exec.local as tlocal
import trino_tpu_torch.expr.arrays as tarrays
import trino_tpu_torch.expr.ir as tir
import trino_tpu_torch.ops.aggregation as tagg
import trino_tpu_torch.plan.nodes as TP
import trino_tpu_torch.types as TT
from test_torch_dml import assert_same_outcome, replay, replayed_tests, unreplayed_statements
from trino_tpu.session import tpch_session as jax_session
from trino_tpu_torch import convert
from trino_tpu_torch.session import tpch_session as torch_session

ARRAY_TESTS = replayed_tests("test_arrays.py")


@pytest.mark.parametrize("test", ARRAY_TESTS)
def test_array_test_sequences_match_jax(test):
    replay("test_arrays.py", test)


def test_array_map_listagg_matches_jax():
    replay("test_aggregates.py", "test_array_map_listagg")


def test_every_array_statement_is_replayed():
    assert unreplayed_statements("test_arrays.py", ARRAY_TESTS) == []
    text = open(os.path.join(os.path.dirname(__file__), "test_arrays.py")).read()
    assert len(ARRAY_TESTS) == text.count("\ndef test_")


O = "from orders where o_orderkey < 400"
STATEMENTS = {
    "split_cardinality_grouped":
        "select n_regionkey, sum(cardinality(split(n_comment, ' '))) from nation "
        "group by n_regionkey order by n_regionkey",
    "split_transform_filter":
        "select n_name, transform(split(n_name, 'A'), s -> length(s)), "
        "filter(split(n_comment, ' '), w -> length(w) > 6), "
        "array_join(split(n_comment, ' '), '+') from nation order by n_nationkey",
    "element_at_and_slice_over_split":
        "select element_at(split(c_phone, '-'), 2), element_at(split(c_phone, '-'), -1), "
        "slice(split(c_address, ' '), 1, 2), array_position(split(c_mktsegment, 'U'), 'BUILDING') "
        "from customer order by c_custkey limit 40",
    "unnest_split_with_ordinality_grouped":
        "select o, count(*), min(w), max(w) from nation cross join "
        "unnest(split(n_comment, ' ')) with ordinality as t(w, o) "
        "group by o order by o",
    "unnest_split_words_grouped":
        "select w, count(*) from part cross join unnest(split(p_name, ' ')) as t(w) "
        "group by w order by count(*) desc, w limit 20",
    "unnest_filtered_source":
        "select n_nationkey, w from nation cross join unnest(split(n_name, 'E')) as t(w) "
        "where n_regionkey = 3 order by n_nationkey, w",
    "array_agg_grouped_hash_sort":
        f"select o_custkey, array_agg(o_orderkey), array_agg(o_totalprice) {O} "
        "group by o_custkey order by o_custkey",
    "array_agg_varchar_direct_groups":
        f"select o_orderstatus, array_agg(o_orderpriority), listagg(o_clerk, '|') {O} "
        "group by o_orderstatus order by o_orderstatus",
    "map_agg_grouped":
        "select r_name, map_agg(n_name, n_nationkey) from nation, region "
        "where n_regionkey = r_regionkey group by r_name order by r_name",
    "listagg_decimal_and_nulls":
        "select o_orderpriority, listagg(case when o_custkey < 300 then o_totalprice end, ',') "
        f"{O} group by o_orderpriority order by o_orderpriority",
    "array_agg_empty_input":
        "select array_agg(o_orderkey), listagg(o_clerk, ',') from orders where o_orderkey < 0",
    "map_agg_null_keys_and_duplicates":
        "select g, map_agg(k, v) from (values (1, 'a', 1), (1, null, 2), (1, 'a', 3), "
        "(2, null, 4), (3, 'b', null)) t(g, k, v) group by g order by g",
    "contains_and_matches_over_split":
        "select contains(split(n_name, 'A'), ''), any_match(split(n_comment, ' '), "
        "w -> w = 'the'), all_match(split(n_name, 'A'), w -> length(w) < 6), "
        "reduce(split(n_comment, ' '), 0, (s, w) -> s + length(w), s -> s) "
        "from nation order by n_nationkey",
    "json_url_over_split":
        "select element_at(split(url_extract_host(concat('http://', n_name, '.com/x')), '.'), 1), "
        "md5(array_join(split(n_name, 'A'), '-')) from nation order by n_nationkey",
}


@pytest.fixture(scope="module")
def tpch_pair():
    return jax_session(0.001, result_cache=False), torch_session(0.001, device="cpu")


@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_array_statements_match_jax(tpch_pair, name):
    assert assert_same_outcome(tpch_pair, STATEMENTS[name]) is not None


AGGREGATED_ARRAYS = (
    "select o_custkey, cardinality(a), element_at(a, 1), array_max(a) from "
    f"(select o_custkey, array_agg(o_orderkey) a {O} group by o_custkey) "
    "order by o_custkey")


def test_array_functions_over_aggregated_arrays(tpch_pair):
    """Where the JAX package and the port differ on purpose (ROADMAP.md,
    C): a projection of an array_agg output over a scan without varchar
    columns.  The JAX package's lowering context copies the executor's
    then-empty dictionary map, so it never sees the array_agg's
    dictionary and raises; the port shares the map and answers, checked
    here against the orders' rows."""
    js, ts = tpch_pair
    with pytest.raises(NotImplementedError, match="array expression has no dictionary"):
        js.execute(AGGREGATED_ARRAYS)
    got = ts.execute(AGGREGATED_ARRAYS).to_pylist()
    want = {}
    for k, c in ts.execute(f"select o_orderkey, o_custkey {O} order by o_orderkey").to_pylist():
        want.setdefault(c, []).append(k)
    assert got == [(c, len(v), v[0], max(v)) for c, v in sorted(want.items())]


# -- module-level parity on seeded inputs ------------------------------------


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _lambda_bodies(ir, T):
    """Expressions over x (bigint), s (varchar) and d (decimal(12,2))."""
    x = ir.ColumnRef(T.BIGINT, "x")
    s = ir.ColumnRef(T.VARCHAR, "s")
    d = ir.ColumnRef(T.decimal(12, 2), "d")
    c = lambda t, v: ir.Constant(t, v)  # noqa: E731
    dec = T.decimal(12, 2)
    return [
        ir.Call(T.BIGINT, "add", (x, c(T.BIGINT, 7))),
        ir.Call(T.BIGINT, "multiply", (x, x)),
        ir.Comparison("<", x, c(T.BIGINT, 0)),
        ir.Comparison("is_distinct", x, c(T.BIGINT, 3)),
        ir.Logical("and", (ir.Comparison(">", x, c(T.BIGINT, -5)),
                           ir.Comparison("<", d, c(dec, 1000)))),
        ir.Logical("or", (ir.IsNull(x, False), ir.Comparison("=", s, c(T.VARCHAR, "b")))),
        ir.Not(ir.Comparison(">=", d, c(dec, 250))),
        ir.Between(x, c(T.BIGINT, -3), c(T.BIGINT, 9), False),
        ir.In(x, (c(T.BIGINT, 1), c(T.BIGINT, 2), c(T.BIGINT, None)), True),
        ir.Case(T.VARCHAR, (ir.WhenClause(ir.Comparison(">", x, c(T.BIGINT, 0)),
                                          c(T.VARCHAR, "pos")),), c(T.VARCHAR, "neg")),
        ir.Cast(T.DOUBLE, d),
        ir.Cast(T.decimal(12, 2), x),
        ir.Call(T.VARCHAR, "upper", (s,)),
        ir.Call(T.BIGINT, "length", (s,)),
        ir.Call(dec, "add", (d, c(dec, 5))),
    ]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eval_ir_matches_jax(seed):
    rng = np.random.default_rng(seed)
    jb, tb = _lambda_bodies(jir, JT), _lambda_bodies(tir, TT)
    for _ in range(60):
        env = {
            "x": None if rng.random() < 0.2 else int(rng.integers(-10, 10)),
            "s": None if rng.random() < 0.2 else str(rng.choice(["a", "b", "ab", ""])),
            "d": None if rng.random() < 0.2 else int(rng.integers(-10**5, 10**5)),
        }
        for je, te in zip(jb, tb):
            assert jarrays.eval_ir(je, env) == tarrays.eval_ir(te, env), (je, env)


def _arrays(rng, n_entries, varchar):
    out = []
    for _ in range(n_entries):
        ln = int(rng.integers(0, 5))
        if varchar:
            vals = [None if rng.random() < 0.15 else str(rng.choice(["p", "q", "r", "s"]))
                    for _ in range(ln)]
        else:
            vals = [None if rng.random() < 0.15 else int(rng.integers(-50, 50))
                    for _ in range(ln)]
        out.append(tuple(vals))
    out[0] = ()
    d = np.empty(len(out), dtype=object)
    d[:] = out
    return d


@pytest.mark.parametrize("ordinality", [False, True])
@pytest.mark.parametrize("outer", [False, True])
@pytest.mark.parametrize("varchar", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_unnest_expansion_matches_jax(seed, varchar, outer, ordinality):
    """unnest_lanes against the JAX package's _visit_unnest over seeded
    rows: NULL arrays, empty arrays, NULL elements and unselected rows."""
    rng = np.random.default_rng(seed)
    entries = _arrays(rng, 12, varchar)
    n = 300
    codes = rng.integers(0, len(entries), n).astype(np.int32)
    aok = rng.random(n) < 0.85
    sel = rng.random(n) < 0.8
    other = rng.integers(-1000, 1000, n)
    other_ok = rng.random(n) < 0.9
    oname = "o" if ordinality else None

    def host(lanes_out, d, total):
        return ({s: (_np(v)[:total], _np(ok)[:total]) for s, (v, ok) in lanes_out.items()},
                None if d is None else list(d))

    jt = JT.VARCHAR if varchar else JT.BIGINT
    b = jlocal.Batch({"a": (jnp.asarray(codes), jnp.asarray(aok)),
                      "k": (jnp.asarray(other), jnp.asarray(other_ok))}, jnp.asarray(sel))
    ex = types.SimpleNamespace(dicts={"a": entries},
                               ladder=types.SimpleNamespace(quantize=lambda c: c))
    stub = types.SimpleNamespace(visit=lambda _n: b, ex=ex)
    out = jlocal._TraceCtx._visit_unnest(stub, JP.Unnest(None, "a", "e", jt, oname, outer))
    res = [host(out.lanes, ex.dicts.get("e"), int(np.asarray(out.sel).sum()))]
    tt = TT.VARCHAR if varchar else TT.BIGINT
    lanes = {"a": (torch.as_tensor(codes), torch.as_tensor(aok)),
             "k": (torch.as_tensor(other), torch.as_tensor(other_ok))}
    lanes_out, d = tlocal.unnest_lanes(lanes, torch.as_tensor(sel),
                                       TP.Unnest(None, "a", "e", tt, oname, outer),
                                       tlocal.FlatArrays(entries, tt))
    res.append(host(lanes_out, d, lanes_out["e"][0].shape[0]))
    (jl, jd), (tl, td) = res
    assert sorted(jl) == sorted(tl)
    for s in jl:
        for part in (0, 1):
            assert jl[s][part].tobytes() == tl[s][part].astype(jl[s][part].dtype).tobytes(), s
            assert jl[s][part].dtype == tl[s][part].dtype, s
    assert jd == td


def _host_agg_case(rng, n=400, cap=9):
    gid = rng.integers(0, cap, n).astype(np.int64)
    x = rng.integers(-100, 100, n)
    xok = rng.random(n) < 0.8
    xok[gid == 4] = False  # an all-NULL group
    name = rng.integers(0, 6, n).astype(np.int32)
    nok = rng.random(n) < 0.85
    nok[gid == 6] = False  # a group whose keys are all NULL
    sel = rng.random(n) < 0.9
    sel[gid == 7] = False  # an empty group
    words = np.array(["k0", "k1", "k2", "k1", "k4", "k5"], dtype=object)
    return gid, x, xok, name, nok, sel, cap, words


@pytest.mark.parametrize("sorted_gid", [False, True])
@pytest.mark.parametrize("kind", ["array_agg", "array_agg_varchar", "listagg",
                                  "listagg_int", "map_agg", "map_agg_int_keys"])
@pytest.mark.parametrize("seed", [0, 1])
def test_host_staged_lanes_match_jax(seed, kind, sorted_gid):
    """host_staged_lanes (one stable sort by group on the device, one
    copy to the host) against the JAX package's row walk."""
    rng = np.random.default_rng(seed)
    gid, x, xok, name, nok, sel, cap, words = _host_agg_case(rng)
    if sorted_gid:  # the hash-sort path hands over rows in group order
        p = np.argsort(gid, kind="stable")
        gid, x, xok, name, nok, sel = (a[p] for a in (gid, x, xok, name, nok, sel))
    spec_args = {
        "array_agg": ("array_agg", "x", None, None),
        "array_agg_varchar": ("array_agg", "n", None, None),
        "listagg": ("listagg", "n", None, ", "),
        "listagg_int": ("listagg", "x", None, ";"),
        "map_agg": ("map_agg", "n", "x", None),
        "map_agg_int_keys": ("map_agg", "x", "n", None),
    }[kind]
    k, inp, inp2, param = spec_args
    res = []
    for A, mk in ((jagg, jnp.asarray), (tagg, torch.as_tensor)):
        spec = A.AggSpec(k, inp, "o", input2=inp2, param=param)
        lanes = {"x": (mk(x), mk(xok)), "n": (mk(name), mk(nok))}
        dicts = {"n": words}
        if A is jagg:
            ex = types.SimpleNamespace(dicts=dict(dicts))
            stub = types.SimpleNamespace(ex=ex)
            (codes, has) = jlocal._TraceCtx._host_agg_lanes(
                stub, spec, lanes, mk(gid), mk(sel), cap)
            d = ex.dicts["o"]
        else:
            (codes, has), d = A.host_staged_lanes(spec, lanes, mk(gid), mk(sel), cap, dicts)
        res.append((_np(codes), _np(has), list(d)))
    (jc, jh, jd), (tc, th, td) = res
    np.testing.assert_array_equal(jh, th)
    np.testing.assert_array_equal(jc.astype(np.int32), tc)
    assert jd == td
    assert not th[7]  # the empty group


def _page(T, pm):
    arr = T.array_of(T.BIGINT)
    mp = T.map_of(T.VARCHAR, T.decimal(12, 2))
    return pm.Page([
        pm.column_from_pylist(arr, [[1, 2], None, [], [1, 2], [None, 3]]),
        pm.column_from_pylist(T.array_of(T.VARCHAR), [["a"], ["a", "b"], None, [], ["b"]]),
        pm.Column(mp, np.array([0, 1, -1, 0, 1], dtype=np.int32),
                  np.array([True, True, False, True, True]),
                  _obj([(("x", 150), ("y", None)), ()])),
    ], 5, ["a", "s", "m"])


def _obj(items):
    d = np.empty(len(items), dtype=object)
    d[:] = items
    return d


def test_convert_round_trips_array_and_map_pages():
    """JAX page -> port page -> JAX page: tuple entries (tuples of pairs
    for maps) survive both ways and compare equal."""
    jp = _page(JT, jpage)
    tp = convert.page_from_state(convert.page_state(jp))
    assert isinstance(tp.columns[0].dictionary[0], tuple)
    assert tp.to_pylist() == jp.to_pylist()
    back = convert.page_from_state(convert.page_state(tp), page_module=jpage,
                                   parse_type=JT.parse_type)
    convert.assert_pages_identical(jp, back)
    convert.assert_pages_identical(jp, tp)
    assert back.to_pylist()[0] == ([1, 2], ["a"], {"x": 1.5, "y": None})
    changed = _page(JT, jpage)
    changed.columns[2].dictionary[0] = (("x", 151), ("y", None))
    assert not convert.pages_identical(jp, changed)


def test_values_arrays_of_equal_length(tpch_pair):
    """Where the JAX package and the port differ on purpose (ROADMAP.md,
    C): VALUES rows whose arrays all have one length.  The JAX package
    builds their dictionary with np.array(entries, dtype=object), a 2-D
    array of elements; the port keeps one tuple per entry, as every
    other array dictionary (and the memory connector's) holds them.  The
    rows read the same."""
    js, ts = tpch_pair
    sql = "select a from (values (array[1, 2]), (array[3, 4])) t(a)"
    a, b = js.execute(sql), ts.execute(sql)
    assert a.to_pylist() == b.to_pylist() == [([1, 2],), ([3, 4],)]
    assert a.columns[0].dictionary.shape == (2, 2)
    assert list(b.columns[0].dictionary) == [(1, 2), (3, 4)]
    ragged = "select a from (values (array[1, 2]), (array[3])) t(a)"
    convert.assert_pages_identical(js.execute(ragged), ts.execute(ragged))

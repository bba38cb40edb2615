"""The port's semi/anti/scalar joins, DISTINCT aggregates, SELECT
DISTINCT, set operations, substring and window functions against the
JAX package, statement by statement.

Each statement runs through both packages' `tpch_session` (the port on
the CPU) and the output pages must be byte-identical
(trino_tpu_torch/convert.py).  Small inline tables (VALUES) carry the
NULL keys, empty sides and duplicates the edge cases need; the window
statements are every statement of tests/test_window.py, its two
memory-table cases as VALUES tables.  The module-level tests hold the
port's DISTINCT and window building blocks to the JAX functions on the
same seeded inputs, exactly.
"""
import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trino_tpu.ops.aggregation as jagg
import trino_tpu.ops.window as jwin
import trino_tpu_torch.ops.aggregation as tagg
import trino_tpu_torch.ops.window as twin
from trino_tpu.plan.nodes import WindowFrame as JFrame
from trino_tpu.session import tpch_session as jax_session
from trino_tpu_torch import convert
from trino_tpu_torch.exec.local import ExecutionError
from trino_tpu_torch.plan.nodes import WindowFrame as TFrame
from trino_tpu_torch.session import tpch_session as torch_session

SF = 0.001
HERE = os.path.dirname(os.path.abspath(__file__))

T = ("(values (1, 10, 'a'), (2, 20, 'b'), (null, 30, 'c'), (4, null, null), "
     "(2, 21, 'b')) t(k, v, s)")
U = "(values (1, 11), (null, 12), (2, 20), (2, 22), (5, 50)) u(k, w)"
U_NO_NULL = "(values (1, 11), (2, 20), (5, 50)) u(k, w)"
WIDE = "cast(o_totalprice as decimal(30, 2))"

SEMI = {
    "in_null_keys_both_sides": f"select k, v from {T} where k in (select k from {U})",
    "not_in_null_on_filtering_side":
        f"select k, v from {T} where k not in (select k from {U})",
    "not_in_no_null": f"select k, v from {T} where k not in (select k from {U_NO_NULL})",
    "in_empty_filtering_side":
        f"select k, v from {T} where k in (select k from {U} where w > 100)",
    "not_in_empty_filtering_side":
        f"select k, v from {T} where k not in (select k from {U} where w > 100)",
    "exists_with_residual":
        f"select k, v from {T} where exists (select * from {U} "
        "where u.k = t.k and u.w <> t.v)",
    "not_exists_with_residual":
        f"select k, v from {T} where not exists (select * from {U} "
        "where u.k = t.k and u.w <> t.v)",
    "exists_multi_column_key":
        f"select k, v from {T} where exists (select * from {U} "
        "where u.k = t.k and u.w = t.v)",
    "not_exists_multi_column_key":
        "select o_orderkey from orders where not exists (select * from lineitem "
        "where l_orderkey = o_orderkey and l_linenumber = o_shippriority + 1)",
    "in_orders_of_big_customers":
        "select count(*) from orders where o_custkey in "
        "(select c_custkey from customer where c_acctbal > 9000)",
}
SCALAR = {
    "scalar_subquery_no_row": f"select k, (select w from {U} where w > 100) x from {T}",
    "scalar_aggregate_over_no_row":
        f"select k, v, (select max(w) from {U} where w > 100) m from {T}",
    "scalar_wide_decimal":
        f"select o_orderkey, (select sum({WIDE}) from orders) s from orders "
        "where o_orderkey < 40",
}
DISTINCT_AGG = {
    "grouped_narrow":
        f"select s, count(distinct v), sum(distinct v), avg(distinct v), "
        f"min(distinct v), count(distinct s) from {T} group by s",
    "ungrouped_narrow": f"select count(distinct v), sum(distinct v), avg(distinct k) from {T}",
    "grouped_decimal":
        "select o_orderstatus, sum(distinct o_totalprice), "
        "avg(distinct o_totalprice), count(distinct o_totalprice) "
        "from orders group by o_orderstatus",
    "ungrouped_wide_decimal": f"select sum(distinct {WIDE}), avg(distinct {WIDE}) from orders",
    "two_distinct_inputs":
        "select o_orderstatus, count(distinct o_custkey), "
        "count(distinct o_orderpriority), max(distinct o_custkey) "
        "from orders group by o_orderstatus",
    "ungrouped_count_distinct": "select count(distinct o_custkey) from orders",
}
SETS = {
    "select_distinct_varchar": "select distinct o_orderstatus, o_orderpriority from orders",
    "select_distinct_wide_decimal": f"select distinct {WIDE} p from orders",
    "union_varchar_merged_dicts":
        "select c_mktsegment from customer union select o_orderpriority from orders",
    "union_all_varchar":
        "select n_name from nation union all select r_name from region",
    "union_narrow_and_wide_decimals":
        f"select {WIDE} p from orders where o_orderkey < 100 "
        "union select c_acctbal from customer where c_custkey < 20",
    "intersect_varchar":
        "select c_mktsegment from customer intersect select 'BUILDING' from nation",
    "except_varchar":
        "select c_mktsegment from customer except select 'BUILDING' from nation",
    "intersect_keys": "select n_regionkey from nation intersect select r_regionkey from region",
    "except_decimals":
        "select o_totalprice from orders where o_orderkey < 50 except "
        "select o_totalprice from orders where o_orderkey < 20",
    "substring_select_list":
        "select substring(c_phone, 1, 2) cc, substring(c_name, 10, 3) n3, "
        "c_custkey from customer where c_custkey < 30",
    "substring_group_by":
        "select substring(c_phone, 4) x, count(*) from customer group by 1",
    "substr_in_list":
        "select count(*) from customer where substr(c_phone, 1, 2) in ('13', '31')",
}


def _window_statements():
    """The SQL of every check(session, oracle_conn, sql) in test_window.py."""
    with open(os.path.join(HERE, "test_window.py")) as f:
        tree = ast.parse(f.read())
    out = {}
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        for call in ast.walk(fn):
            if (isinstance(call, ast.Call) and getattr(call.func, "id", None) == "check"
                    and len(call.args) >= 3):
                out[fn.name] = ast.literal_eval(call.args[2])
    return out


WB_VALUES = ", ".join(f"({i}, {(i * 7919) % 1000})" for i in range(128))
WINDOW = dict(_window_statements())
WINDOW.update({
    # test_sliding_minmax_empty_frames_null's memory table as VALUES
    "test_sliding_minmax_empty_frames_null":
        "select o, max(v) over (order by o rows between 2 following and 3 "
        "following) from (values (1, 10), (2, 20), (3, 30)) ef(o, v) order by o",
    # test_sliding_frame_spans_whole_batch's 128-row table as VALUES
    "test_sliding_frame_spans_whole_batch":
        "select o, max(v) over (order by o rows between 200 preceding and 200 "
        f"following) from (values {WB_VALUES}) wb(o, v) order by o",
})


@pytest.fixture(scope="module")
def sessions():
    return (jax_session(SF, result_cache=False),
            torch_session(SF, device="cpu"))


def _same(sessions, sql):
    js, ts = sessions
    a = js.execute(sql)
    b = ts.execute(sql)
    convert.assert_pages_identical(a, b)
    return b


@pytest.mark.parametrize("name", sorted(SEMI))
def test_semi_and_anti_joins(sessions, name):
    _same(sessions, SEMI[name] + " order by 1")


# varchar semi-join keys whose two sides carry different dictionaries:
# (statement, the rows SQL gives, whether the JAX package gives them too).
# The JAX package compares dictionary codes as they are, so most of its
# pages are wrong here (ROADMAP.md, C); the port recodes the source keys
# into the filtering side's dictionary.  TPC-H's nation and region
# tables are fixed, and share no name.
PICKS = "(values ('CHINA', 1), ('PERU', 2), ('MARS', 3), ('CHINA', 2)) v(nm, x)"
SEMI_DICTS = {
    "in_across_tables":
        ("select n_name from nation where n_name in (select r_name from region)",
         [], False),
    "not_in_across_tables":
        ("select r_name from region where r_name not in (select n_name from nation)",
         ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"], False),
    "exists_across_tables":
        ("select r_name from region where exists (select * from nation "
         "where n_name = r_name)", [], False),
    "in_values":
        (f"select n_name from nation where n_name in (select nm from {PICKS})",
         ["CHINA", "PERU"], False),
    "exists_values_with_residual":
        (f"select n_name from nation where exists (select * from {PICKS} "
         "where nm = n_name and x <> n_regionkey)", ["CHINA", "PERU"], False),
    "exists_values_multi_column_key":
        (f"select n_name from nation where exists (select * from {PICKS} "
         "where nm = n_name and x = n_regionkey)", ["CHINA"], False),
    "in_literal_subquery":
        ("select n_name from nation where n_name in (select 'ALGERIA' from region)",
         ["ALGERIA"], True),
}


@pytest.mark.parametrize("name", sorted(SEMI_DICTS))
def test_semi_join_varchar_keys_across_dictionaries(sessions, name):
    js, ts = sessions
    sql, want, jax_agrees = SEMI_DICTS[name]
    page = ts.execute(sql + " order by 1")
    assert [r[0] for r in page.to_pylist()] == want
    ref = js.execute(sql + " order by 1")
    if jax_agrees:
        convert.assert_pages_identical(ref, page)
    else:
        assert [r[0] for r in ref.to_pylist()] != want


@pytest.mark.parametrize("name", sorted(SCALAR))
def test_scalar_subqueries(sessions, name):
    page = _same(sessions, SCALAR[name] + " order by 1")
    assert page.count > 0


@pytest.mark.parametrize("name", sorted(DISTINCT_AGG))
def test_distinct_aggregates(sessions, name):
    _same(sessions, DISTINCT_AGG[name] + " order by 1")


@pytest.mark.parametrize("name", sorted(SETS))
def test_distinct_set_operations_and_substring(sessions, name):
    page = _same(sessions, SETS[name] + " order by 1")
    assert page.count > 0


@pytest.mark.parametrize("name", sorted(WINDOW))
def test_window_statements(sessions, name):
    assert WINDOW[name]
    page = _same(sessions, WINDOW[name])
    assert page.count > 0


def test_sliding_window_values(sessions):
    """The two memory-table window cases hold their expected rows too."""
    got = _same(sessions, WINDOW["test_sliding_minmax_empty_frames_null"])
    assert got.to_pylist() == [(1, 30), (2, None), (3, None)]
    got = _same(sessions, WINDOW["test_sliding_frame_spans_whole_batch"]).to_pylist()
    mx = max((i * 7919) % 1000 for i in range(128))
    assert got == [(i, mx) for i in range(128)]


@pytest.mark.parametrize("kind", ["intersect", "except"])
def test_intersect_and_except_all_are_refused_alike(sessions, kind):
    js, ts = sessions
    sql = f"select n_regionkey from nation {kind} all select r_regionkey from region"
    with pytest.raises(Exception, match=f"{kind.upper()} ALL not supported") as je:
        js.execute(sql)
    with pytest.raises(ExecutionError, match=f"{kind.upper()} ALL not supported"):
        ts.execute(sql)
    assert "DISTINCT only" in str(je.value)


# -- module-level parity on seeded inputs ------------------------------------


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _gid_lane_live(seed, n=777, wide=False, floats=False):
    rng = np.random.default_rng(seed)
    gid = np.sort(rng.integers(0, 9, n)).astype(np.int64)
    if wide:
        v = np.stack([rng.integers(-3, 3, n), rng.integers(-2, 2, n)], -1).astype(np.int64)
    elif floats:
        v = rng.choice([-1.5, 0.0, -0.0, 2.25, np.inf], n)
    else:
        v = rng.integers(-6, 6, n).astype(np.int64)
    ok = rng.random(n) < 0.85
    live = ok & (rng.random(n) < 0.9)
    return gid, v, ok, live


def _canonical_marks(gid, v, mask):
    """(group, value) of every marked row, sorted: which duplicate is
    marked does not change any aggregate."""
    keys = [(int(g), tuple(np.atleast_1d(x).tolist())) for g, x, m in zip(gid, v, mask) if m]
    return sorted(keys)


@pytest.mark.parametrize("seed,kind", [(0, "int"), (1, "int"), (2, "wide"), (3, "float")])
def test_distinct_first_mask_matches_jax(seed, kind):
    gid, v, ok, live = _gid_lane_live(seed, wide=kind == "wide", floats=kind == "float")
    jm = _np(jagg.distinct_first_mask(jnp.asarray(gid), (jnp.asarray(v), jnp.asarray(ok)),
                                      jnp.asarray(live)))
    tm = _np(tagg.distinct_first_mask(torch.as_tensor(gid), (torch.as_tensor(v),
                                      torch.as_tensor(ok)), torch.as_tensor(live)))
    # dead rows are never marked, and each live (group, value) exactly once
    assert not tm[~live].any() and not jm[~live].any()
    assert _canonical_marks(gid, v, tm) == _canonical_marks(gid, v, jm)
    assert len(set(_canonical_marks(gid, v, tm))) == int(tm.sum())


@pytest.mark.parametrize("seed,cap", [(0, 9), (1, 12), (3, 9), (4, 1)])
def test_distinct_count_matches_jax(seed, cap):
    gid, v, ok, live = _gid_lane_live(seed, floats=seed == 3)
    gid = np.minimum(gid, cap - 1)
    j = jagg.distinct_count(jnp.asarray(gid), (jnp.asarray(v), jnp.asarray(ok)),
                            jnp.asarray(live), cap)
    t = tagg.distinct_count(torch.as_tensor(gid), (torch.as_tensor(v), torch.as_tensor(ok)),
                            torch.as_tensor(live), cap)
    np.testing.assert_array_equal(_np(j), _np(t))


def _sorted_window_input(seed, n=501):
    """Rows sorted as the executor sorts them: selected first, then by
    partition key and order key (each with some NULLs)."""
    rng = np.random.default_rng(seed)
    sel = np.sort(rng.random(n) < 0.9)[::-1].copy()
    part = rng.integers(0, 7, n).astype(np.int64)
    pok = rng.random(n) < 0.95
    order = rng.integers(0, 5, n).astype(np.int64)
    ook = rng.random(n) < 0.9
    idx = np.lexsort((order, ~ook, part, ~pok, ~sel))
    return sel[idx], (part[idx], pok[idx]), (order[idx], ook[idx])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compute_bounds_matches_jax(seed):
    sel, (p, pok), (o, ook) = _sorted_window_input(seed)
    jb = jwin.compute_bounds([(jnp.asarray(p), jnp.asarray(pok))],
                             [(jnp.asarray(o), jnp.asarray(ook))], jnp.asarray(sel))
    tb = twin.compute_bounds([(torch.as_tensor(p), torch.as_tensor(pok))],
                             [(torch.as_tensor(o), torch.as_tensor(ook))],
                             torch.as_tensor(sel))
    for f in ("idx", "gid", "part_start", "part_end", "peer_start", "peer_end",
              "peer_boundary"):
        np.testing.assert_array_equal(_np(getattr(jb, f)), _np(getattr(tb, f)), f)
    for fn in ("row_number", "rank", "dense_rank"):
        np.testing.assert_array_equal(_np(getattr(jwin, fn)(jb)[0]),
                                      _np(getattr(twin, fn)(tb)[0]))
    for fn in ("percent_rank", "cume_dist"):
        np.testing.assert_array_equal(_np(getattr(jwin, fn)(jb, jnp.asarray(sel))[0]),
                                      _np(getattr(twin, fn)(tb, torch.as_tensor(sel))[0]))
    np.testing.assert_array_equal(_np(jwin.ntile(jb, jnp.asarray(sel), 4)[0]),
                                  _np(twin.ntile(tb, torch.as_tensor(sel), 4)[0]))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("kind", ["min", "max", "wide_min", "wide_max"])
def test_segscan_matches_jax(kind, reverse):
    rng = np.random.default_rng(7)
    n = 1000
    reset = rng.random(n) < 0.05
    if kind.startswith("wide"):
        v = np.stack([rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64),
                      rng.integers(-3, 3, n)], -1).astype(np.int64)
        jop = jwin._wide_min_op if kind == "wide_min" else jwin._wide_max_op
        top = twin._wide_min_op if kind == "wide_min" else twin._wide_max_op
    else:
        v = rng.integers(-10**12, 10**12, n).astype(np.int64)
        jop = jnp.minimum if kind == "min" else jnp.maximum
        top = torch.minimum if kind == "min" else torch.maximum
    j = jwin._segscan(jnp.asarray(v), jnp.asarray(reset), jop, reverse)
    t = twin._segscan(torch.as_tensor(v), torch.as_tensor(reset), top, reverse)
    np.testing.assert_array_equal(_np(j), _np(t))


FRAMES = [
    ("rows", "preceding", 2, "current", 0),
    ("rows", "current", 0, "following", 3),
    ("rows", "following", 1, "following", 3),
    ("rows", "preceding", 3, "preceding", 1),
    ("rows", "unbounded_preceding", 0, "current", 0),
    ("rows", "current", 0, "unbounded_following", 0),
    ("range", "unbounded_preceding", 0, "current", 0),
    ("range", "current", 0, "unbounded_following", 0),
]


@pytest.mark.parametrize("frame", FRAMES, ids=lambda f: "-".join(map(str, f)))
def test_framed_aggregates_match_jax(frame):
    sel, (p, pok), (o, ook) = _sorted_window_input(11)
    rng = np.random.default_rng(12)
    n = sel.shape[0]
    v = rng.integers(-10**15, 10**15, n).astype(np.int64)
    ok = rng.random(n) < 0.9
    wide = np.stack([v, rng.integers(-5, 5, n)], -1).astype(np.int64)
    jb = jwin.compute_bounds([(jnp.asarray(p), jnp.asarray(pok))],
                             [(jnp.asarray(o), jnp.asarray(ook))], jnp.asarray(sel))
    tb = twin.compute_bounds([(torch.as_tensor(p), torch.as_tensor(pok))],
                             [(torch.as_tensor(o), torch.as_tensor(ook))],
                             torch.as_tensor(sel))
    jf, tf = JFrame(*frame), TFrame(*frame)
    js_, je = jwin.frame_range(jf, jb)
    ts_, te = twin.frame_range(tf, tb)
    np.testing.assert_array_equal(_np(js_), _np(ts_))
    np.testing.assert_array_equal(_np(je), _np(te))
    jsel, tsel = jnp.asarray(sel), torch.as_tensor(sel)
    jl, tl = (jnp.asarray(v), jnp.asarray(ok)), (torch.as_tensor(v), torch.as_tensor(ok))
    jw, tw = ((jnp.asarray(wide), jnp.asarray(ok)),
              (torch.as_tensor(wide), torch.as_tensor(ok)))
    pairs = [
        (jwin.framed_sum_count(jl, jsel, js_, je), twin.framed_sum_count(tl, tsel, ts_, te)),
        (jwin.framed_sum_wide(jw, jsel, js_, je), twin.framed_sum_wide(tw, tsel, ts_, te)),
        (jwin.framed_sum_wide(jl, jsel, js_, je), twin.framed_sum_wide(tl, tsel, ts_, te)),
    ]
    for kind in ("min", "max"):
        pairs.append((jwin.framed_minmax(jl, jsel, jb, jf, kind),
                      twin.framed_minmax(tl, tsel, tb, tf, kind)))
        pairs.append((jwin.framed_minmax_wide(jw, jsel, jb, jf, kind),
                      twin.framed_minmax_wide(tw, tsel, tb, tf, kind)))
    for (jv, jc), (tv, tc) in pairs:
        np.testing.assert_array_equal(_np(jv), _np(tv))
        np.testing.assert_array_equal(_np(jc), _np(tc))
    for lead in (False, True):
        for default in (None, -1):
            jr = jwin.shift_value(jl, jb, 2, default, lead)
            tr = twin.shift_value(tl, tb, 2, default, lead)
            np.testing.assert_array_equal(_np(jr[0]), _np(tr[0]))
            np.testing.assert_array_equal(_np(jr[1]), _np(tr[1]))

"""The port's aggregate library against the JAX package.

Every SELECT that tests/test_aggregates.py runs through its TPC-H
session runs through both packages' `tpch_session` (the port on the
CPU), statement by statement.  The pages must be byte-identical
(trino_tpu_torch/convert.py), except the float64 values of statements
that reach a transcendental function or a moment aggregate (stddev/var,
corr/covar/regr, geometric_mean), which are held at relative 1e-12:
torch and XLA differ in the last bit of exp/log/sqrt on some inputs.
The statements are read from the test file's source by chip_smoke.py's
sql_statements, which the card's SF1 phase runs too.
Left out: the tests on the JAX package's distributed runner;
test_array_map_listagg and the memory-connector tests are replayed in
tests/test_torch_arrays.py.

The module-level tests hold the port's building blocks (_segment_bitwise,
_first_by_key, _percentile, _splitmix64, the moment finalize) to the
JAX functions on seeded inputs, all-NULL groups and int64 extremes
included, exactly.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trino_tpu.ops.aggregation as jagg
import trino_tpu_torch.ops.aggregation as tagg
from chip_smoke import AGG_TEST_SKIP, sql_statements
from trino_tpu.session import tpch_session as jax_session
from trino_tpu_torch import convert
from trino_tpu_torch.session import tpch_session as torch_session

SF = 0.001
RTOL = 1e-12
# float64 results that are not bit-reproducible across engines: torch
# and XLA differ in the last bit of exp/log/sqrt/trig on some inputs,
# and the moment aggregates finalize through them
TOLERANT = re.compile(
    r"\b(ln|log|log2|log10|exp|power|pow|sqrt|cbrt|sin|cos|tan|asin|acos|"
    r"atan|atan2|sinh|cosh|tanh|degrees|radians|stddev\w*|var_\w+|variance|"
    r"corr|covar_\w+|regr_\w+|geometric_mean)\s*\(", re.I)


def assert_same_pages(sessions, sql):
    """Both packages' pages for `sql`: byte-identical, float64 values
    held at RTOL where the statement reaches a TOLERANT function."""
    js, ts = sessions
    a = js.execute(sql)
    b = ts.execute(sql)
    if TOLERANT.search(sql):
        convert.assert_pages_match(a, b, RTOL)
    else:
        convert.assert_pages_identical(a, b)
    return b


STATEMENTS = sql_statements("test_aggregates.py", AGG_TEST_SKIP)
# test_approx_percentile's f-string, at each fraction it runs
STATEMENTS.update({
    f"test_approx_percentile@{p}":
        f"select approx_percentile(l_quantity, {p}) from lineitem"
    for p in (0.0, 0.25, 0.5, 0.9, 1.0)
})
# the families over grouped, DISTINCT, varchar and empty inputs
STATEMENTS.update({
    "moments_grouped_hash_sort":
        "select l_suppkey, var_samp(l_extendedprice), stddev_pop(l_discount), "
        "covar_samp(l_quantity, l_extendedprice), regr_intercept(l_tax, "
        "l_discount), geometric_mean(l_extendedprice) from lineitem "
        "group by l_suppkey order by l_suppkey",
    "bitwise_checksum_grouped":
        "select o_orderpriority, bitwise_and_agg(o_custkey), "
        "bitwise_or_agg(o_custkey), bitwise_xor_agg(o_orderkey), "
        "checksum(o_totalprice), checksum(o_orderdate), count(*) "
        "from orders group by o_orderpriority order by o_orderpriority",
    "bitwise_negative_and_nulls":
        "select bitwise_and_agg(v), bitwise_or_agg(v), bitwise_xor_agg(v), "
        "checksum(v), bool_or(v < 0) from (values (-1), (null), "
        "(-9223372036854775807), (9223372036854775807), (0), (-5)) t(v)",
    "min_by_max_by_varchar_grouped":
        "select n_regionkey, min_by(n_name, n_comment), max_by(n_name, n_nationkey), "
        "min_by(n_nationkey, n_name) from nation group by n_regionkey "
        "order by n_regionkey",
    "min_by_ties_and_null_keys":
        "select g, min_by(x, k), max_by(x, k) from (values (1, 10, 5), "
        "(1, 11, 5), (1, 12, null), (2, 20, null), (3, null, 7), (3, 31, 7)) "
        "t(g, x, k) group by g order by g",
    "approx_grouped_hash_sort":
        "select o_custkey, approx_distinct(o_orderstatus), "
        "approx_percentile(o_totalprice, 0.25), approx_percentile(o_custkey, 0.9) "
        "from orders group by o_custkey order by o_custkey",
    "bool_and_or_grouped":
        "select l_returnflag, bool_and(l_discount < 0.09), bool_or(l_tax = 0), "
        "every(l_quantity > 2) from lineitem group by l_returnflag "
        "order by l_returnflag",
    "distinct_moments_and_count_if":
        "select o_orderstatus, stddev_samp(distinct o_custkey), "
        "var_pop(distinct o_shippriority), count_if(distinct o_custkey > 50), "
        "geometric_mean(distinct o_custkey) from orders group by o_orderstatus "
        "order by o_orderstatus",
    "single_row_groups":
        "select o_orderkey, var_samp(o_totalprice), stddev_pop(o_totalprice), "
        "covar_samp(o_totalprice, o_custkey), corr(o_totalprice, o_custkey) "
        "from orders where o_orderkey < 40 group by o_orderkey order by o_orderkey",
})


@pytest.fixture(scope="module")
def sessions():
    return (jax_session(SF, result_cache=False),
            torch_session(SF, device="cpu"))


@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_aggregate_statements_match_jax(sessions, name):
    assert_same_pages(sessions, STATEMENTS[name])


def test_every_aggregate_test_statement_is_covered():
    """The extraction reaches the families the JAX tests exercise."""
    text = " ".join(STATEMENTS.values())
    for fn in ("var_samp", "stddev", "geometric_mean", "corr", "regr_slope",
               "bool_and", "every", "bitwise_xor_agg", "checksum", "min_by",
               "max_by", "approx_distinct", "approx_percentile", "arbitrary"):
        assert fn + "(" in text, fn


ARRAY_AGGREGATES = (
    "select array_agg(o_orderkey) from orders where o_orderkey < 200",
    "select o_orderstatus, array_agg(o_orderpriority), listagg(o_clerk, ','), "
    "map_agg(o_orderkey, o_totalprice) from orders where o_custkey < 40 "
    "group by o_orderstatus order by o_orderstatus",
    "select o_custkey, array_agg(o_totalprice), listagg(o_orderstatus, '') "
    "from orders group by o_custkey order by o_custkey",
)


@pytest.mark.parametrize("i", range(len(ARRAY_AGGREGATES)))
def test_array_aggregates_match_jax(sessions, i):
    """array_agg / map_agg / listagg (refused by name until the arrays
    slice) over one group, direct groups and hash-sort groups."""
    assert_same_pages(sessions, ARRAY_AGGREGATES[i])


def test_streaming_spill_and_split_steps_stay_refused():
    """The JAX package's memory, spill and streaming properties are the
    port's now, with its defaults; what stays refused is a host-staged
    aggregate inside a PARTIAL/FINAL step, as in the JAX package, and an
    oversized plan that cannot be tiled when spill is off."""
    from trino_tpu_torch.utils.memory import ExceededMemoryLimitError

    props = torch_session(SF, device="cpu").properties
    assert [props.get(p) for p in ("query_max_memory_bytes", "spill_enabled",
                                   "memory_blocked_timeout_s", "double_buffer_depth")
            ] == [8 << 30, True, 0.0, 1]
    tight = torch_session(SF, device="cpu", query_max_memory_bytes=50_000,
                          spill_enabled=False)
    with pytest.raises(ExceededMemoryLimitError, match="not spillable"):
        tight.execute("select l_orderkey, l_partkey from lineitem")
    lane = (torch.zeros(3, dtype=torch.int64), torch.ones(3, dtype=torch.bool))
    spec = tagg.AggSpec("array_agg", "x", "o")
    assert spec.accumulator_names == ["o$val", "o$valid"]
    with pytest.raises(NotImplementedError, match="array_agg is host-staged"):
        tagg.accumulate([spec], {"x": lane}, torch.zeros(3, dtype=torch.int64),
                        torch.ones(3, dtype=torch.bool), 1, step="partial")


def test_sketch_steps_name_the_mesh_slice():
    """approx_distinct / approx_percentile at the PARTIAL step, once
    refused until the mesh slice, ship the JAX package's sketch states:
    the same accumulator names and, on seeded inputs, the same values
    (tests/test_torch_sketches.py holds the pages)."""
    rng = np.random.default_rng(7)
    v = rng.integers(0, 500, 400).astype(np.int64)
    gid = rng.integers(0, 3, 400).astype(np.int64)
    sel = rng.random(400) < 0.9
    for kind, param in (("approx_distinct", None), ("approx_percentile", 0.5)):
        t = tagg.AggSpec(kind, "x", "o", param=param)
        j = jagg.AggSpec(kind, "x", "o", param=param)
        assert t.accumulator_names == j.accumulator_names
        got = tagg.accumulate(
            [t], {"x": (torch.as_tensor(v), torch.ones(400, dtype=torch.bool))},
            torch.as_tensor(gid), torch.as_tensor(sel), 3, step="partial")
        want = jagg.accumulate(
            [j], {"x": (jnp.asarray(v), jnp.ones(400, dtype=bool))},
            jnp.asarray(gid), jnp.asarray(sel), 3, step="partial")
        assert sorted(got) == sorted(want)
        for name in want:
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))


# -- module-level parity on seeded inputs ------------------------------------


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


I64_EDGES = np.array([-(2**63), 2**63 - 1, -1, 0, 1, 2**62, -(2**62) - 7],
                     dtype=np.int64)


def _groups(seed, n=640, cap=9, empty=(4,)):
    """Seeded int64 values (int64 extremes mixed in), validity, selection
    and group ids; the groups in `empty` hold no live row."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64, endpoint=True)
    v[:: 37] = I64_EDGES[np.arange(len(v[:: 37])) % len(I64_EDGES)]
    gid = rng.integers(0, cap, n).astype(np.int64)
    ok = rng.random(n) < 0.8
    sel = rng.random(n) < 0.9
    for g in empty:
        ok[gid == g] = False
    return v, ok, sel, gid, cap


@pytest.mark.parametrize("ordered", [False, True])
@pytest.mark.parametrize("op", ["and", "or", "xor"])
@pytest.mark.parametrize("seed", [0, 1])
def test_segment_bitwise_matches_jax(seed, op, ordered):
    """Both ways of counting the bit planes: one plane at a time, and
    two planes to a prefix sum over the rows in group order."""
    v, ok, sel, gid, cap = _groups(seed)
    live = ok & sel
    j = jagg._segment_bitwise(jnp.asarray(v), jnp.asarray(live), jnp.asarray(gid), cap, op)
    tg = torch.as_tensor(gid)
    order = tagg._GroupOrder(tg, cap) if ordered else None
    t = tagg._segment_bitwise(torch.as_tensor(v), torch.as_tensor(live), tg, cap, op,
                              order=order)
    np.testing.assert_array_equal(_np(j), _np(t))
    assert _np(t)[4] == 0  # the all-NULL group


@pytest.mark.parametrize("cap", [1, 9, 40])
def test_group_order_sums_match_row_order_scatter(cap):
    """_GroupOrder's float sums take each group's rows in row order (the
    JAX package's scatter-add order on the CPU, so bit for bit) and its
    integer sums are exact; an empty group sums to 0."""
    rng = np.random.default_rng(17)
    n = 3000
    gid = rng.integers(0, cap, n).astype(np.int64)
    if cap > 1:
        gid[gid == 1] = 0
    x = rng.normal(size=n) * 10.0 ** rng.integers(-3, 6, n)
    v, ok, sel, _, _ = _groups(3, n=n, cap=cap, empty=())
    order = tagg._GroupOrder(torch.as_tensor(gid), cap)
    jf = jagg._seg_sum(jnp.asarray(x), jnp.asarray(gid), cap)
    assert _np(order.fsum(torch.as_tensor(x))).tobytes() == _np(jf).tobytes()
    ji = jagg._seg_sum(jnp.asarray(v), jnp.asarray(gid), cap)
    np.testing.assert_array_equal(_np(order.isum(torch.as_tensor(v))), _np(ji))


def test_splitmix64_matches_jax():
    rng = np.random.default_rng(5)
    v = np.concatenate([I64_EDGES, rng.integers(-(2**63), 2**63 - 1, 4000,
                                                dtype=np.int64, endpoint=True)])
    j = jagg._splitmix64(jnp.asarray(v))
    t = tagg._splitmix64(torch.as_tensor(v))
    np.testing.assert_array_equal(_np(j), _np(t))
    # int32 lanes (dates, dictionary codes) hash their sign-extended value
    v32 = rng.integers(-(2**31), 2**31 - 1, 1000).astype(np.int32)
    np.testing.assert_array_equal(_np(jagg._splitmix64(jnp.asarray(v32))),
                                  _np(tagg._splitmix64(torch.as_tensor(v32))))


@pytest.mark.parametrize("take_min", [True, False])
@pytest.mark.parametrize("kind", ["int", "float", "ties"])
def test_first_by_key_matches_jax(kind, take_min):
    rng = np.random.default_rng(7)
    n, cap = 500, 11
    gid = rng.integers(0, cap, n).astype(np.int64)
    if kind == "float":
        key = rng.normal(size=n)
    elif kind == "ties":
        key = rng.integers(0, 3, n).astype(np.int64)
    else:
        key = rng.integers(-(2**40), 2**40, n).astype(np.int64)
    x = rng.integers(-1000, 1000, n).astype(np.int64)
    xok = rng.random(n) < 0.8
    live = rng.random(n) < 0.85
    live[gid == 3] = False  # a group without any keyed row
    j = jagg._first_by_key((jnp.asarray(x), jnp.asarray(xok)), jnp.asarray(key),
                           jnp.asarray(live), jnp.asarray(gid), cap, take_min)
    t = tagg._first_by_key((torch.as_tensor(x), torch.as_tensor(xok)),
                           torch.as_tensor(key), torch.as_tensor(live),
                           torch.as_tensor(gid), cap, take_min)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("frac", [0.0, 0.1, 0.5, 0.75, 1.0])
@pytest.mark.parametrize("kind", ["int", "float"])
def test_percentile_matches_jax(kind, frac):
    rng = np.random.default_rng(11)
    n, cap = 700, 13
    gid = rng.integers(0, cap, n).astype(np.int64)
    if kind == "float":
        v = rng.choice([-2.5, 0.0, 1.0, 3.75, 1e300, -np.inf], n)
    else:
        v = rng.integers(-50, 50, n).astype(np.int64)
        v[::41] = I64_EDGES[1]
    ok = rng.random(n) < 0.85
    sel = rng.random(n) < 0.9
    ok[gid == 5] = False  # an all-NULL group
    j = jagg._percentile((jnp.asarray(v), jnp.asarray(ok)), jnp.asarray(sel),
                         jnp.asarray(gid), cap, frac)
    t = tagg._percentile((torch.as_tensor(v), torch.as_tensor(ok)),
                         torch.as_tensor(sel), torch.as_tensor(gid), cap, frac)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(_np(a), _np(b))


MOMENT_SPECS = [(k, None) for k in tagg.MOMENT_KINDS] + [
    (k, "x") for k in tagg.BINARY_MOMENT_KINDS] + [("geometric_mean", None)]


@pytest.mark.parametrize("kind,second", MOMENT_SPECS)
def test_moment_aggregates_match_jax(kind, second):
    """accumulate + finalize over decimal inputs, with single-row and
    all-NULL groups: validity exact, values at RTOL."""
    from trino_tpu import types as JT
    from trino_tpu_torch import types as TT

    rng = np.random.default_rng(13)
    n, cap = 600, 8
    gid = rng.integers(0, cap, n).astype(np.int64)
    gid[gid == 6] = 5
    gid[0] = 6  # a single-row group
    y = rng.integers(-10**6, 10**6, n).astype(np.int64)
    x = rng.integers(1, 10**4, n).astype(np.int64)
    yok = rng.random(n) < 0.9
    xok = rng.random(n) < 0.9
    yok[gid == 7] = False  # an all-NULL group
    sel = np.ones(n, dtype=bool)
    res = []
    for A, T, mk in ((jagg, JT, jnp.asarray), (tagg, TT, torch.as_tensor)):
        dec = T.decimal(12, 2)
        spec = A.AggSpec(kind, "y", "o", dec, T.DOUBLE, False,
                         second, dec if second else None)
        lanes = {"y": (mk(y), mk(yok)), "x": (mk(x), mk(xok))}
        accs = A.accumulate([spec], lanes, mk(gid), mk(sel), cap)
        v, ok = A.finalize([spec], accs)["o"]
        res.append((_np(v), _np(ok)))
    (jv, jok), (tv, tok) = res
    np.testing.assert_array_equal(jok, tok)
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=0)

"""The port's mergeable sketches and PARTIAL/FINAL aggregation steps
against the JAX package.

The sketch functions (HLL registers, the k-minimum-hash sample and
their merges and estimators) take the same seeded numpy inputs in both
packages and must give the same integers.  The PARTIAL accumulator
pages of sum, avg over wide decimals, the moments, min_by/max_by, the
varchar extremes, approx_distinct and approx_percentile must equal the
JAX package's column for column (names, types, values, validity,
dictionaries; float64 states at relative 1e-12), and so must the pages
of an INTERMEDIATE and a FINAL step over them and the streamed runs of
the same statements.  The port runs on the CPU.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from trino_tpu.exec.fragment_exec import FragmentExecutor as JaxFragmentExecutor
from trino_tpu.ops import sketches as jsk
from trino_tpu.plan import nodes as JP
from trino_tpu.session import tpch_session as _jax_session
from trino_tpu_torch import convert
from trino_tpu_torch.exec.fragment_exec import FragmentExecutor
from trino_tpu_torch.ops import sketches as tsk
from trino_tpu_torch.plan import nodes as TP
from trino_tpu_torch.session import tpch_session as _torch_session

RTOL = 1e-12
SF = 0.01
SEED = 20261017


def jax_session(sf, **props):
    return _jax_session(sf, device_generation=False, result_cache=False, **props)


def torch_session(sf, **props):
    return _torch_session(sf, device="cpu", **props)


# ---------------------------------------------------------------------------
# the sketch functions on the same inputs


def _inputs(n=5000, cap=7, seed=SEED):
    rng = np.random.default_rng(seed)
    bits = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)
    vals = rng.normal(1000.0, 250.0, n)
    live = rng.random(n) < 0.8
    gid = rng.integers(0, cap, n, dtype=np.int64)
    return bits, vals, live, gid, cap


def _hll_np(packed):
    return np.stack([np.asarray(packed[i]) for i in range(len(packed))], 1)


def test_hll_registers_merge_and_estimate_match_jax():
    bits, _, live, gid, cap = _inputs()
    j = jsk.hll_accumulate(jnp.asarray(bits), jnp.asarray(live), jnp.asarray(gid), cap)
    t = tsk.hll_accumulate(torch.as_tensor(bits), torch.as_tensor(live),
                           torch.as_tensor(gid), cap)
    np.testing.assert_array_equal(_hll_np(j), _hll_np(t))
    # merge the groups' rows into two final groups, one partial row dead
    sel = np.ones(cap, bool)
    sel[3] = False
    g2 = np.arange(cap, dtype=np.int64) % 2
    jm = jsk.hll_merge(j, jnp.asarray(sel), jnp.asarray(g2), 2)
    tm = tsk.hll_merge(t, torch.as_tensor(sel), torch.as_tensor(g2), 2)
    np.testing.assert_array_equal(_hll_np(jm), _hll_np(tm))
    np.testing.assert_array_equal(np.asarray(jsk.hll_cardinality(jm, 2)),
                                  tsk.hll_cardinality(tm, 2).numpy())
    np.testing.assert_array_equal(np.asarray(jsk.hll_cardinality(j, cap)),
                                  tsk.hll_cardinality(t, cap).numpy())


@pytest.mark.parametrize("dtype", ["float64", "int64"])
def test_kmv_sample_merge_and_quantile_match_jax(dtype):
    _, vals, live, gid, cap = _inputs(n=3000, cap=5)
    v = vals.astype(dtype) if dtype == "float64" else (vals * 100).astype(np.int64)
    jv, jh = jsk.kmv_accumulate(jnp.asarray(v), jnp.asarray(live), jnp.asarray(gid), cap)
    tv, th = tsk.kmv_accumulate(torch.as_tensor(v), torch.as_tensor(live),
                                torch.as_tensor(gid), cap)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(jh), th.numpy())
    K = jsk.KMV_K
    sel = np.array([True, True, False, True, True])
    g2 = np.array([0, 1, 0, 0, 1], dtype=np.int64)
    jmv, jmh = jsk.kmv_merge(jv.reshape(cap, K), jnp.where(
        jnp.asarray(sel)[:, None], jh.reshape(cap, K), jsk._H_EMPTY),
        jnp.asarray(sel), jnp.asarray(g2), 2)
    tmv, tmh = tsk.kmv_merge(tv.reshape(cap, K), torch.where(
        torch.as_tensor(sel)[:, None], th.reshape(cap, K), tsk._H_EMPTY),
        torch.as_tensor(sel), torch.as_tensor(g2), 2)
    np.testing.assert_array_equal(np.asarray(jmv), tmv.numpy())
    np.testing.assert_array_equal(np.asarray(jmh), tmh.numpy())
    for q in (0.1, 0.5, 0.99):
        jq, jhas = jsk.kmv_quantile(jmv, jmh, 2, q)
        tq, thas = tsk.kmv_quantile(tmv, tmh, 2, q)
        np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
        np.testing.assert_array_equal(np.asarray(jhas), thas.numpy())


def test_sketch_guard_refuses_oversized_state():
    with pytest.raises(ValueError, match="2\\^30-slot"):
        tsk.hll_accumulate(torch.zeros(1, dtype=torch.int64),
                           torch.ones(1, dtype=torch.bool),
                           torch.zeros(1, dtype=torch.int64), 1 << 22)


# ---------------------------------------------------------------------------
# PARTIAL, INTERMEDIATE and FINAL pages


STATEMENTS = {
    "sums_wide_avg": "select l_returnflag, sum(l_quantity), avg(l_extendedprice), "
                     "sum(l_extendedprice * (1 - l_discount)), count(*) "
                     "from lineitem group by l_returnflag",
    "moments": "select l_returnflag, var_samp(l_quantity), stddev_pop(l_extendedprice), "
               "corr(l_quantity, l_discount), geometric_mean(l_tax) "
               "from lineitem group by l_returnflag",
    "by_and_extremes": "select l_linestatus, min_by(l_orderkey, l_extendedprice), "
                       "max_by(l_shipmode, l_shipdate), min(l_comment), "
                       "max(l_shipinstruct), arbitrary(l_shipmode) "
                       "from lineitem group by l_linestatus",
    "approx_grouped": "select l_returnflag, approx_distinct(l_partkey), "
                      "approx_percentile(l_extendedprice, 0.5) "
                      "from lineitem group by l_returnflag",
    "approx_global": "select approx_distinct(l_partkey), "
                     "approx_percentile(l_discount, 0.9) from lineitem",
    "many_groups": "select o_custkey, approx_distinct(o_clerk), count(*), "
                   "bool_and(o_totalprice > 1000), bitwise_or_agg(o_shippriority), "
                   "checksum(o_orderkey) from orders group by o_custkey",
}


def _aggregate(plan, P):
    if isinstance(plan, P.Aggregate):
        return plan
    for s in plan.sources:
        found = _aggregate(s, P)
        if found is not None:
            return found
    return None


def _steps(session, P, FE, sql, device_cfg):
    """The PARTIAL page of the statement's aggregate, then the
    INTERMEDIATE and FINAL pages over it run as remote input of a
    FragmentExecutor."""
    agg = _aggregate(session.plan(sql), P)
    part = P.Aggregate(agg.source, agg.keys, agg.aggs, "partial")
    psyms = tuple(part.output_symbols())
    partial = session._executor().execute(P.Output(part, psyms, psyms))
    rs = P.RemoteSource(1, psyms, tuple(part.output_types().items()))
    pages = [partial]
    for step in ("intermediate", "final"):
        node = P.Aggregate(rs, agg.keys, agg.aggs, step)
        syms = tuple(node.output_symbols())
        fe = FE(session.catalogs, dict(device_cfg), {}, {1: [partial, partial]})
        pages.append(fe.execute(P.Output(node, syms, syms)))
    return pages


@pytest.fixture(scope="module")
def sessions():
    return jax_session(SF), torch_session(SF)


@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_partial_intermediate_final_pages_match_jax(sessions, name):
    js, ts = sessions
    want = _steps(js, JP, JaxFragmentExecutor, STATEMENTS[name], {})
    got = _steps(ts, TP, FragmentExecutor, STATEMENTS[name], {"device": "cpu"})
    for step, a, b in zip(("partial", "intermediate", "final"), want, got):
        assert a.names == b.names, step
        convert.assert_pages_match(a, b, RTOL)


# the statements whose tiles' partial pages fit the limit they stream
# under (the many-groups states of 64 HLL lanes a group do not)
@pytest.mark.parametrize("name", ["approx_grouped", "by_and_extremes", "moments",
                                  "sums_wide_avg"])
def test_streamed_aggregates_match_jax(name):
    sql = STATEMENTS[name]
    limit = 600_000
    ts = torch_session(SF, query_max_memory_bytes=limit)
    b = ts.execute(sql)
    a = jax_session(SF, query_max_memory_bytes=limit).execute(sql)
    convert.assert_pages_match(a, b, RTOL)
    assert ts.last_kernel_profile["outOfCore"] == "stream"
    assert max(ts.last_kernel_profile["streamedTiles"].values()) > 1


def test_streamed_approx_distinct_within_its_error():
    """The HLL estimate of a streamed run lies within three standard
    errors (3 x 1.04 / sqrt(512)) of the exact distinct count."""
    sql = ("select l_returnflag, approx_distinct(l_partkey), count(distinct l_partkey) "
           "from lineitem group by l_returnflag order by l_returnflag")
    ts = torch_session(0.05, query_max_memory_bytes=3_000_000)
    rows = ts.execute(sql.replace(", count(distinct l_partkey)", "")).to_pylist()
    exact = torch_session(0.05).execute(sql).to_pylist()
    assert ts.last_kernel_profile["outOfCore"] == "stream"
    for (flag, est), (flag2, _e, want) in zip(rows, exact):
        assert flag == flag2
        assert abs(est - want) <= 3 * 1.04 / 512 ** 0.5 * want


def test_final_min_over_a_null_partial_row_differs_from_jax():
    """A FINAL min over varchar ranks (int32 codes) where one partial row
    of the group saw only NULLs: the port's merge keeps the other rows'
    minimum, 'b'; the JAX package's 2^62 sentinel wraps to 0 in the
    int32 lane and returns the dictionary's first entry, 'a', which no
    row of the group holds (ROADMAP.md, C)."""
    from trino_tpu import types as JT
    from trino_tpu.page import Column as JColumn, Page as JPage
    from trino_tpu_torch import types as TT
    from trino_tpu_torch.page import Column as TColumn, Page as TPage

    out = []
    for P, T, Column, Page, FE, cfg in (
        (JP, JT, JColumn, JPage, JaxFragmentExecutor, {}),
        (TP, TT, TColumn, TPage, FragmentExecutor, {"device": "cpu"}),
    ):
        sorted_d = np.array(["a", "b", "c"], dtype=object)
        types = (("g", T.BIGINT), ("m$val", T.VARCHAR), ("m$valid", T.BIGINT))

        def page(code, valid):
            return Page([Column(T.BIGINT, np.array([1], np.int64)),
                         Column(T.VARCHAR, np.array([code], np.int32), None, sorted_d),
                         Column(T.BIGINT, np.array([valid], np.int64))],
                        1, ["g", "m$val", "m$valid"])

        rs = P.RemoteSource(1, ("g", "m$val", "m$valid"), types)
        agg = P.Aggregate(rs, ("g",), (P.AggInfo("m", "min", "s", False, T.VARCHAR,
                                                  T.VARCHAR),), "final")
        fe = FE(None, dict(cfg), {}, {1: [page(2, 0), page(1, 1)]})
        out.append(fe.execute(P.Output(agg, ("g", "m"), ("g", "m"))).to_pylist())
    jax_rows, port_rows = out
    assert port_rows == [(1, "b")]
    assert jax_rows == [(1, "a")]

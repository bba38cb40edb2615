"""The port's on-device TPC-H generator against the host generator and
the JAX package's.

The cases of tests/test_tpch_device.py: every table's device lanes
(trino_tpu_torch/connectors/tpch_device.py, run here on the CPU) must
equal the host generator's arrays (trino_tpu_torch/connectors/tpch.py)
and the JAX package's `device_lanes` for the same row range byte for
byte, lineitem's split ranges included; then end to end, Q1, Q3, Q6 and
a streamed Q1 with device generation on in both packages give the JAX
package's pages, a scan reading a column the generator cannot make
takes the host generator (counted in the kernel profile), a failing
generator raises, and the out-of-core gate, which counts the
generator's temporaries, takes the JAX package's decisions at SF10.
"""
import numpy as np
import pytest

import chip_smoke
from test_torch_streaming import decision
from tpch_sql import QUERIES
from trino_tpu.connectors import tpch_device as jax_device
from trino_tpu.exec import spill as jax_spill
from trino_tpu.exec import streaming as jax_streaming
from trino_tpu.session import tpch_session as jax_session
from trino_tpu_torch import convert
from trino_tpu_torch.connectors import tpch, tpch_device
from trino_tpu_torch.exec import spill as torch_spill
from trino_tpu_torch.exec import streaming as torch_streaming
from trino_tpu_torch.session import tpch_session as _torch_session

SF = 0.01


def torch_session(sf, **props):
    return _torch_session(sf, device="cpu", **props)


def _jax_lanes(table, cols, lo, hi, count):
    """The JAX package's device lanes for rows [lo, hi), cut to `count`."""
    cap = max(128, 1 << max(count - 1, 0).bit_length())
    got = jax_device.device_lanes(table, cols, lo, hi, cap, SF, count)
    return {c: np.asarray(got[c][0])[:count] for c in cols}


@pytest.mark.parametrize("table", sorted(tpch_device.DEVICE_COLS))
def test_device_lanes_match_host_and_jax(table):
    cols = sorted(tpch_device.DEVICE_COLS[table])
    values, _dicts, count = tpch.generate(table, SF, columns=cols)
    n = tpch._counts(SF)
    base = n["orders"] if table == "lineitem" else n[table]
    got = tpch_device.device_lanes(table, cols, 0, base, SF, count, "cpu")
    jax = _jax_lanes(table, cols, 0, base, count)
    for c in cols:
        dev, ok = (t.numpy() for t in got[c])
        host = np.asarray(values[c])
        assert dev.dtype == host.dtype == jax[c].dtype, (c, dev.dtype, host.dtype)
        np.testing.assert_array_equal(dev, host, err_msg=f"{table}.{c}")
        np.testing.assert_array_equal(dev, jax[c], err_msg=f"{table}.{c}")
        assert ok.all() and ok.shape == dev.shape == (count,)


@pytest.mark.parametrize("split", range(3))
def test_lineitem_split_ranges(split):
    """A split's orders, made on the device, equal the host split (and
    the JAX package's lanes): lines of an order never straddle splits."""
    cols = sorted(tpch_device.DEVICE_COLS["lineitem"])
    n = tpch._counts(SF)
    values, _d, count = tpch.generate("lineitem", SF, split=split, num_splits=3,
                                      columns=cols)
    lo = (n["orders"] * split) // 3
    hi = (n["orders"] * (split + 1)) // 3
    assert tpch_device.lineitem_count(lo, hi) == count == jax_device.lineitem_count(lo, hi)
    got = tpch_device.device_lanes("lineitem", cols, lo, hi, SF, count, "cpu")
    jax = _jax_lanes("lineitem", cols, lo, hi, count)
    for c in cols:
        np.testing.assert_array_equal(got[c][0].numpy(), values[c], err_msg=c)
        np.testing.assert_array_equal(got[c][0].numpy(), jax[c], err_msg=c)


def test_generation_in_chunks_equals_one_pass(monkeypatch):
    """The chunked generation (bounded temporaries) gives the lanes one
    pass over every row gives, at chunk edges inside an order too."""
    cols = ["l_orderkey", "l_linenumber", "l_extendedprice", "l_returnflag"]
    n = tpch._counts(SF)
    lo, hi = 1234, n["orders"] - 777
    count = tpch_device.lineitem_count(lo, hi)
    whole = tpch_device.device_lanes("lineitem", cols, lo, hi, SF, count, "cpu")
    monkeypatch.setattr(tpch_device, "_MIN_CHUNK_ROWS", 997)
    assert tpch_device.chunk_rows(count) <= count // 4
    chunked = tpch_device.device_lanes("lineitem", cols, lo, hi, SF, count, "cpu")
    for c in cols:
        np.testing.assert_array_equal(whole[c][0].numpy(), chunked[c][0].numpy())
    parts = tpch_device.device_lanes("orders", ["o_orderstatus"], lo, hi, SF,
                                     hi - lo, "cpu")
    values, _d, _n = tpch.generate("orders", SF, columns=["o_orderstatus"])
    np.testing.assert_array_equal(parts["o_orderstatus"][0].numpy(),
                                  values["o_orderstatus"][lo:hi])


def test_a_wrong_line_count_raises():
    with pytest.raises(ValueError, match="lines on the device"):
        tpch_device.device_lanes("lineitem", ["l_orderkey"], 0, 100, SF, 5, "cpu")


END_TO_END = [
    # numeric + date filter over lineitem (the q6 shape)
    "select sum(l_extendedprice * l_discount) from lineitem "
    "where l_discount between 0.05 and 0.07 and l_quantity < 24",
    # dictionary-encoded group keys from the device generator
    "select l_returnflag, l_linestatus, count(*), sum(l_quantity) "
    "from lineitem group by l_returnflag, l_linestatus "
    "order by l_returnflag, l_linestatus",
    "select o_orderstatus, count(*) from orders "
    "group by o_orderstatus order by o_orderstatus",
]


@pytest.fixture(scope="module")
def sessions():
    return (jax_session(SF, result_cache=False),
            torch_session(SF),
            torch_session(SF, device_generation=False))


@pytest.mark.parametrize("i", range(len(END_TO_END)))
def test_session_device_generation_end_to_end(sessions, i):
    js, ts, host = sessions
    page = ts.execute(END_TO_END[i])
    assert ts.last_kernel_profile["deviceGeneratedScans"] == 1
    convert.assert_pages_identical(js.execute(END_TO_END[i]), page)
    convert.assert_pages_identical(host.execute(END_TO_END[i]), page)
    assert host.last_kernel_profile.get("deviceGeneratedScans") is None


@pytest.mark.parametrize("q", [1, 3, 6])
def test_tpch_queries_match_jax_with_device_generation(sessions, q):
    """A session of its own: the module's would hold an earlier query's
    columns, which a scan reads from the scan cache."""
    js = sessions[0]
    ts = torch_session(SF)
    page = ts.execute(QUERIES[q][0])
    convert.assert_pages_identical(js.execute(QUERIES[q][0]), page)
    prof = ts.last_kernel_profile
    assert prof["deviceGeneratedScans"] == {1: 1, 3: 3, 6: 1}[q]
    assert prof["summary"]["h2dBytes"] == 0  # nothing was copied to the device


def test_streamed_q1_matches_jax_with_device_generation():
    """Every tile generates its own row range (both packages stream Q1
    in the same tiles)."""
    limit = 300_000
    js = jax_session(SF, result_cache=False, query_max_memory_bytes=limit)
    ts = torch_session(SF, query_max_memory_bytes=limit)
    page = ts.execute(QUERIES[1][0])
    convert.assert_pages_identical(js.execute(QUERIES[1][0]), page)
    prof = ts.last_kernel_profile
    assert prof["outOfCore"] == "stream"
    tiles = sum(prof["streamedTiles"].values())
    assert tiles > 1 and prof["deviceGeneratedScans"] == tiles
    assert prof.get("pregenerated_bytes", 0) > 0 and prof.get("preupload_bytes", 0) == 0


def test_host_formatted_columns_take_the_host_generator(sessions):
    """o_clerk is formatted per row on the host: that scan (only) takes
    the host generator, and the profile counts it (a session of its own,
    whose scan cache holds neither table)."""
    js = sessions[0]
    ts = torch_session(SF)
    sql = ("select count(*), min(o_clerk) from orders join lineitem "
           "on o_orderkey = l_orderkey where l_quantity < 5")
    page = ts.execute(sql)
    prof = ts.last_kernel_profile
    assert (prof["deviceGeneratedScans"], prof["hostGeneratedScans"]) == (1, 1)
    convert.assert_pages_identical(js.execute(sql), page)


def test_a_failing_generator_raises(monkeypatch):
    """No hidden fallback: a generator fault surfaces, the host path does
    not take over."""
    ts = torch_session(0.001, scan_cache_enabled=False)

    def broken(*args, **kwargs):
        raise RuntimeError("generator fault")

    monkeypatch.setattr(tpch_device, "device_lanes", broken)
    with pytest.raises(RuntimeError, match="generator fault"):
        ts.execute("select count(*) from orders")


# -- the out-of-core gate with the generator's temporaries --------------------


@pytest.fixture(scope="module")
def sf10():
    sessions = {}

    def get(**props):
        key = tuple(sorted(props.items()))
        if key not in sessions:
            sessions[key] = (jax_session(10.0, result_cache=False, **props),
                             torch_session(10.0, **props))
        return sessions[key]

    return get


def test_generator_temporaries_counted_like_jax(sf10):
    js, ts = sf10()
    for q in (1, 3, 6):
        plan_j, plan_t = js.plan(QUERIES[q][0]), ts.plan(QUERIES[q][0])
        want = jax_streaming._devgen_temp_bytes(js._executor(), plan_j)
        assert torch_streaming._devgen_temp_bytes(ts._executor(), plan_t) == want > 0
    assert torch_streaming.DEVGEN_TEMP_LANES == jax_streaming.DEVGEN_TEMP_LANES


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_tpch_sf10_decisions_with_device_generation(sf10, q):
    js, ts = sf10()
    want = decision(jax_spill, jax_streaming, js, QUERIES[q][0], 8 << 30)
    assert decision(torch_spill, torch_streaming, ts, QUERIES[q][0], 8 << 30) == want


OOC_CASES = [(limit, props, label, sql)
             for limit, props, stmts in chip_smoke._ooc_statements()
             for label, sql in stmts]


@pytest.mark.parametrize("limit,props,label,sql", OOC_CASES,
                         ids=[f"{c[2]}-{c[0] >> 20}MiB" for c in OOC_CASES])
def test_ooc_decisions_with_device_generation(sf10, limit, props, label, sql):
    """chip_smoke.py's out-of-core statements, with device generation at
    its default as the card runs them: the JAX package's decisions, which
    the chip's table OOC_WANT holds."""
    js, ts = sf10(**props)
    want = decision(jax_spill, jax_streaming, js, sql, limit)
    assert decision(torch_spill, torch_streaming, ts, sql, limit) == want
    assert chip_smoke.OOC_WANT[(label, limit)] == want

"""The port's fused aggregate past the table-wide int64 gate.

A wide (DECIMAL(38, s)) sum or avg whose whole-table bound, rows times
the input's bound, passes 2^62 still fuses where each of its terms' sums
is proven below 2^62 (ops/megakernel.py), and its output is rebuilt from
the term sums in 128-bit chunks (`fusedWideSums` counts such outputs).

The table is TPC-H lineitem at SF 0.15 (900,000 rows by its statistics).
Its Q1-shaped input, the DECIMAL(15,2) price times two short factors,
l_extendedprice * (2 - l_discount) * (l_tax + 327), is bounded by about
2^46 a row, so the table-wide bound is about 2^65.8, and the sums below
pass 2^63 in a group.  On one node, on a mesh of 8 CPU shards (whose
per-term partials are merged before the rebuild) and on a two-worker
cluster whose PARTIAL streams in tiles, the answer is the one-node
unfused answer, exactly, and Python's exact integer sums.  A narrow
bigint sum past the gate is still refused.
"""
import collections
from decimal import Decimal

import numpy as np
import pytest

from trino_tpu_torch import convert
from trino_tpu_torch.ops import megakernel as MK
from trino_tpu_torch.session import tpch_session

SF = 0.15
X = "l_extendedprice * (2 - l_discount) * (l_tax + 327)"
SCALE = 6  # of X: 2 + 2 + 2
KEYS = {"one_group": [], "grouped": ["l_returnflag", "l_linestatus"]}


def _sql(keys):
    sel = "".join(f"{k}, " for k in keys)
    tail = (" group by " + ", ".join(keys) + " order by " + ", ".join(keys)
            if keys else "")
    return (f"select {sel}sum({X}) as s, avg({X}) as a, "
            f"sum(l_extendedprice) as p, count(*) as n from lineitem{tail}")


NARROW = "select sum(l_orderkey * 1000 * l_partkey) as s from lineitem"


def _session(**props):
    return tpch_session(SF, device="cpu", result_cache=False, **props)


@pytest.fixture(scope="module")
def unfused():
    return _session(megakernels="off")


@pytest.fixture(scope="module")
def exact_sums(unfused):
    """keys tuple -> Python's exact sum of X's lanes over the group."""
    page = unfused.execute(
        "select l_returnflag, l_linestatus, l_extendedprice, l_discount, "
        "l_tax from lineitem")
    flag, status, price, disc, tax = [c.to_numpy() for c in page.columns]
    d_flag, d_status = page.columns[0].dictionary, page.columns[1].dictionary
    # below 2^46 a row: exact in int64
    v = price.astype(np.int64) * (200 - disc) * (32700 + tax)
    out = {(): sum(v.tolist())}
    for f in np.unique(flag):
        for s in np.unique(status):
            m = (flag == f) & (status == s)
            if m.any():
                out[(str(d_flag[f]), str(d_status[s]))] = sum(v[m].tolist())
    return out


@pytest.fixture(scope="module")
def want(unfused):
    return {name: unfused.execute(_sql(keys)) for name, keys in KEYS.items()}


def _profile(s):
    prof = s.last_kernel_profile
    return (prof.get("fusedAggregates"), prof.get("fusedWideSums"),
            prof.get("fusionRejects"))


@pytest.mark.parametrize("name", sorted(KEYS))
def test_a_wide_sum_past_the_gate_fuses_and_rebuilds_exactly(
        unfused, exact_sums, want, name):
    keys = KEYS[name]
    s = _session(megakernels="on")
    got = s.execute(_sql(keys))
    # sum and avg of X share its terms, each fused past the gate;
    # sum(l_extendedprice) stays under it, so it is not counted
    assert _profile(s) == (1, 2, None)
    convert.assert_pages_identical(want[name], got)
    rows = got.to_pylist()
    for r in rows:
        total = exact_sums[tuple(r[:len(keys)])]
        assert r[len(keys)] == Decimal(total).scaleb(-SCALE)
    # the point of the case: a group's sum is past the int64 range
    assert max(exact_sums[tuple(r[:len(keys)])] for r in rows) > 2 ** 63


def test_explain_analyze_counts_the_wide_sums():
    s = _session(megakernels="on")
    text = "\n".join(r[0] for r in s.execute(
        "explain analyze " + _sql(KEYS["one_group"])).to_pylist())
    assert "fused aggregates: 1 (" in text
    assert ", 2 wide sums rebuilt in 128-bit chunks" in text


def test_a_narrow_bigint_sum_past_the_gate_is_still_refused(unfused):
    """A bigint sum's overflow is the SQL result's business: its
    table-wide bound (about 2^64.4) refuses fusion, though each of its
    terms would pass, and the unfused path answers."""
    s = _session(megakernels="on")
    got = s.execute(NARROW)
    prof = s.last_kernel_profile
    assert prof.get("fusedAggregates") is None and prof["fusionRejects"] == 1
    assert prof["lastFusionReject"] == "table-wide sum could exceed int64"
    convert.assert_pages_identical(unfused.execute(NARROW), got)
    page = unfused.execute("select l_orderkey, l_partkey from lineitem")
    okey, pkey = [c.to_numpy().astype(np.int64) for c in page.columns]
    assert got.to_pylist() == [(sum((okey * 1000 * pkey).tolist()),)]


@pytest.mark.parametrize("name", sorted(KEYS))
def test_a_mesh_merges_term_partials_before_the_rebuild(want, name):
    s = _session(megakernels="on", distributed=True, num_devices=8)
    got = s.execute(_sql(KEYS[name]))
    assert _profile(s) == (1, 2, None)
    convert.assert_pages_identical(want[name], got)


# Q6 at SF30 (179,996,449 lineitem rows): sum(l_extendedprice *
# l_discount) fuses as the price's two 16-bit limbs, each times the
# discount (at most 10), at shifts 0 and 16, beside the count (term 0)
Q6_ROWS = 179_996_449
Q6_TERMS = ((0, 0xFFFF * 10), (16, (10_494_950 >> 16) * 10))


@pytest.mark.parametrize("shifts,bounds", [
    pytest.param((0, 16, 16, 32), None, id="shifts0"),
    pytest.param((31, 63), None, id="shifts1"),
    pytest.param((1, 33, 47, 62), None, id="shifts2"),
    pytest.param(tuple(sh for sh, _ in Q6_TERMS),
                 tuple(Q6_ROWS * hi for _, hi in Q6_TERMS), id="q6-under-the-gate"),
])
def test_wide_chunks_rebuild_shifted_term_sums(shifts, bounds):
    """Term sums up to 2^62 - 1 at any shift below 64 give the canonical
    chunks of the 128-bit total, as Python's integers add them.  Term
    sums under their bounds whose total fits one int64 (Q6's, under the
    table-wide gate) give the lanes of the int64 rebuild."""
    import torch

    from trino_tpu_torch.ops import wide_decimal as wd

    g = torch.Generator().manual_seed(len(shifts))
    sums = torch.randint(0, 2 ** 62, (len(shifts) + 1, 5), generator=g)
    if bounds is None:
        sums[1:, 0] = 2 ** 62 - 1
    else:
        top = torch.tensor(bounds).reshape(-1, 1)
        sums[1:] %= top + 1
        sums[1:, 0] = top[:, 0]
    sums[1:, 1] = 0
    slots = [(i + 1, sh) for i, sh in enumerate(shifts)]
    cs = MK._wide_chunks(sums, slots)
    for grp in range(sums.shape[1]):
        total = sum(int(sums[i, grp]) << sh for i, sh in slots)
        got = [int(c[grp]) for c in cs]
        assert all(0 <= c < 2 ** 32 for c in got[:3])
        assert sum(c << (32 * j) for j, c in enumerate(got)) == total
    if bounds is not None:
        val = MK._int64_sum(sums, slots)
        zero = torch.zeros_like(val)
        want = wd.normalize_chunks([val & 0xFFFFFFFF, val >> 32, zero, zero])
        assert len(cs) == len(want) == 4
        for c, w in zip(cs, want):
            assert torch.equal(c, w)


def _exact(rows, page):
    """Rows with each decimal column's value as the Decimal it states."""
    dec = [c.type.is_decimal for c in page.columns]
    return [tuple(Decimal(str(v)) if d and v is not None else v
                  for v, d in zip(r, dec)) for r in rows]


# each worker's PARTIAL over its half of lineitem streams in several tiles
CLUSTER_LIMIT = 3_000_000


@pytest.fixture(scope="module")
def cluster():
    from trino_tpu_torch.testing import DistributedQueryRunner

    with DistributedQueryRunner(
            workers=2, device="cpu",
            catalogs=(("tpch", "tpch", {"tpch.scale-factor": SF}),),
            properties={"query_max_memory_bytes": CLUSTER_LIMIT,
                        "megakernels": "on"}) as r:
        yield r


@pytest.mark.parametrize("name", sorted(KEYS))
def test_a_cluster_streams_fused_wide_partials(cluster, want, monkeypatch,
                                               name):
    """Every tile of both workers' PARTIAL fuses, rebuilds its wide
    outputs in chunk lanes, and the FINAL step's answer is the one-node
    unfused answer exactly."""
    from trino_tpu_torch.utils.tracing import TRACER

    runs = []
    run = MK._run

    def spy(ctx, node):
        try:
            out = run(ctx, node)
        except MK.Reject as r:
            runs.append((node.step, str(r)))
            raise
        runs.append((node.step, ctx.ex.kernel_profile.get("fusedWideSums")))
        return out

    monkeypatch.setattr(MK, "_run", spy)
    monkeypatch.setattr(TRACER, "spans", collections.deque(maxlen=1 << 20))
    rows = cluster.rows(_sql(KEYS[name]))
    tiles = [s for s in TRACER.spans if s.name == "stream_tile"]
    by_task = collections.Counter(s.parent_id for s in tiles)
    assert len(by_task) >= 2 and min(by_task.values()) >= 2, by_task
    assert len(runs) == len(tiles) and set(runs) == {("partial", 2)}, runs
    page = want[name]
    assert _exact(rows, page) == _exact(page.to_pylist(), page)

"""The port's mesh as a first-class target, against the JAX package's.

The cases of tests/test_mesh_fused.py on the port: fused aggregates on
every shard (Q6, Q1), Q3 over broadcast and over partitioned joins, the
grouped count(DISTINCT) that repartitions instead of gathering, the HLL
register-wise max, approx_distinct, a seeded device loss that shrinks
the mesh from 8 shards to 7, and the per-shard tasks of the timeline.
Pages equal the JAX package's mesh sessions (8 virtual CPU devices) and
its one-device sessions byte for byte, and the sqlite oracle as the
reference's tests hold them.  The reference's two HLO-text cases (an
all-gather in the fused Q6 module; all-to-all and dynamic-slice in the
repartition) become counts of the port's collectives
(parallel/collectives.CALLS): the port has no compiled module to read,
and no chunk to dynamic-slice.
"""
import json
import sqlite3

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trino_tpu.session as jsession
from oracle import assert_rows_match, load_tpch
from tpch_sql import QUERIES, oracle_dialect
from trino_tpu.obs import journal as jax_journal
from trino_tpu.ops import sketches as jsketches
from trino_tpu.parallel import mesh_executor as JMX
from trino_tpu_torch.obs import doctor, journal
from trino_tpu_torch.ops import kernels as kn
from trino_tpu_torch.ops import sketches
from trino_tpu_torch.parallel import collectives as C
from trino_tpu_torch.parallel import mesh_executor as MX
from trino_tpu_torch.runtime.supervisor import QUARANTINED
from trino_tpu_torch.session import tpch_session

SF = 0.001
Q1 = QUERIES[1][0]
Q3 = QUERIES[3][0]
Q6 = QUERIES[6][0]

DISTINCT_SQL = (
    "select o_orderpriority, count(distinct o_custkey) from orders "
    "group by o_orderpriority order by o_orderpriority"
)


@pytest.fixture(autouse=True, scope="module")
def _jax_compile_cache_of_its_own():
    """The JAX package's compiled fragments stay this module's (its
    process-global compile cache swapped for a fresh one meanwhile)."""
    import trino_tpu.cache.compile_cache as jax_compile_cache

    saved = jax_compile_cache._SHARED
    jax_compile_cache._SHARED = None
    yield
    jax_compile_cache._SHARED = saved


@pytest.fixture(autouse=True)
def _fresh_journals():
    for j in (journal, jax_journal):
        j._reset_journal()
    doctor._reset_diagnoses()
    yield


@pytest.fixture(scope="module")
def oracle_conn():
    conn = sqlite3.connect(":memory:")
    load_tpch(conn, SF, ["lineitem", "orders", "customer"])
    return conn


def _mesh_session(**props):
    return tpch_session(SF, device="cpu", distributed=True, num_devices=8,
                        result_cache=False, **props)


def _jax_mesh_session(**props):
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return jsession.tpch_session(SF, distributed=True, num_devices=8,
                                 result_cache=False, **props)


def _megakernels(prof):
    return [k for k in (prof or {}).get("kernels", ()) if k.get("mode") == "megakernel"]


def _calls(run):
    before = dict(C.CALLS)
    out = run()
    return out, {k: C.CALLS[k] - before[k] for k in C.CALLS}


# --- fused shard bodies: mesh vs local vs the JAX mesh vs the oracle -------


@pytest.mark.parametrize("q", [6, 1])
def test_mesh_fused_parity_and_oracle(q, oracle_conn):
    """Each shard runs the fused kernel over its split; the int64 (term,
    group) partials are all_gathered and summed, so the merge is exact
    and the page is the one-device page byte for byte."""
    sql = QUERIES[q][0]
    on = _mesh_session(megakernels="on")
    page, calls = _calls(lambda: on.execute(sql))
    prof = on.last_kernel_profile
    assert prof["fusedAggregates"] == 1
    mk = _megakernels(prof)
    want = "mesh:8/megakernel:lineitem/" if q == 6 else "mesh:8/megakernel:"
    assert mk and mk[0]["digest"].startswith(want)
    # every record carries the shard count
    assert all(k["digest"].startswith("mesh:8/") for k in prof["kernels"]), prof["kernels"]
    assert calls["all_gather"] >= 1
    a = page.to_pylist()
    off = tpch_session(SF, device="cpu", megakernels="off", result_cache=False)
    assert a == off.execute(sql).to_pylist()
    assert a == _jax_mesh_session(megakernels="on").execute(sql).to_pylist()
    expected = oracle_conn.execute(oracle_dialect(sql)).fetchall()
    assert_rows_match(a, expected, tol=2e-2, ordered=True)


def test_q1_mesh_unfused_psums():
    """Q1 with megakernels off: each shard's grouped count and grouped
    sums (the grouped_count / grouped_sum_i64 path), merged by psum."""
    mesh = _mesh_session(megakernels="off")
    page, calls = _calls(lambda: mesh.execute(Q1))
    assert calls["psum"] >= 1 and calls["all_to_all"] == 0
    assert page.to_pylist() == _jax_mesh_session(megakernels="off").execute(Q1).to_pylist()


def test_q3_mesh_parity_and_oracle(oracle_conn):
    mesh = _mesh_session()
    a, calls = _calls(lambda: mesh.execute(Q3).to_pylist())
    # broadcast joins: the build sides gathered, nothing repartitioned
    assert calls["all_gather"] >= 2 and calls["all_to_all"] == 0
    assert a == tpch_session(SF, device="cpu", result_cache=False).execute(Q3).to_pylist()
    assert a == _jax_mesh_session().execute(Q3).to_pylist()
    expected = oracle_conn.execute(oracle_dialect(Q3)).fetchall()
    assert_rows_match(a, expected, tol=2e-2, ordered=True)


# --- the exchanges: the collectives they are made of ------------------------


def test_mesh_fused_q6_merges_with_all_gather():
    """The fused Q6 merges the shards' partials with an all_gather (the
    reference finds an all-gather in the compiled module) and moves no
    rows between shards."""
    _, calls = _calls(lambda: _mesh_session(megakernels="on").execute(Q6))
    assert calls["all_gather"] >= 1
    assert calls["all_to_all"] == 0 and calls["psum"] == 0


def test_mesh_repartition_shows_all_to_all_and_all_gather():
    """count(DISTINCT) grouped: an all_to_all repartitions on the group
    keys, an all_gather brings the groups to the root (the reference's
    all-to-all, dynamic-slice and all-gather in the compiled module)."""
    _, calls = _calls(lambda: _mesh_session().execute(DISTINCT_SQL))
    assert calls["all_to_all"] >= 1
    assert calls["all_gather"] >= 1


# --- the HLL register-wise max ------------------------------------------------


def test_hll_pmax_merge_is_registerwise_max():
    """The union of HLL sketches across shards is the register-wise max.
    The port's merge of 4 shards' packed lanes equals the JAX function
    under a shard_map over 4 devices, bit for bit; a max of the packed
    words (8 registers compared lexicographically) is a different
    answer on this seed."""
    ndev, cap = 4, 3
    regs = np.random.default_rng(7).integers(
        0, 56, size=(ndev, cap, jsketches.HLL_M)).astype(np.int64)

    def body(r):
        merged = jsketches.hll_pmax_merge(jsketches._pack(jnp.asarray(r[0])), cap, JMX.AXIS)
        return jnp.stack([merged[i] for i in range(jsketches.HLL_LANES)], axis=1)[None]

    fn = jax.jit(JMX._shard_map(body, JMX.default_mesh(ndev), (JMX.P_(JMX.AXIS),),
                                JMX.P_(JMX.AXIS)))
    want = np.asarray(fn(jnp.asarray(regs)))  # [ndev, cap, HLL_LANES]
    packed = [sketches._pack(torch.from_numpy(regs[d])) for d in range(ndev)]
    before = C.CALLS["pmax"]
    got = sketches.hll_pmax_merge(packed, cap, torch.device("cpu"))
    assert C.CALLS["pmax"] == before + 1
    got_words = torch.stack([got[i] for i in range(sketches.HLL_LANES)], 1).numpy()
    for d in range(ndev):
        assert np.array_equal(got_words, want[d])
    assert np.array_equal(sketches._unpack(got, cap).numpy(), regs.max(axis=0))
    word_max = {i: torch.stack([p[i] for p in packed]).max(0).values
                for i in range(sketches.HLL_LANES)}
    assert not np.array_equal(sketches._unpack(word_max, cap).numpy(), regs.max(axis=0))


def test_approx_distinct_global_mesh_matches_local():
    sql = "select approx_distinct(o_custkey) from orders"
    got = _mesh_session().execute(sql).to_pylist()
    assert got == tpch_session(SF, device="cpu", result_cache=False).execute(sql).to_pylist()
    assert got == _jax_mesh_session().execute(sql).to_pylist()


def test_grouped_approx_distinct_merges_registers():
    """A grouped approx_distinct on direct keys merges the shards' HLL
    registers by pmax (the JAX mesh's estimate, bit for bit)."""
    sql = ("select o_orderpriority, approx_distinct(o_custkey) from orders "
           "group by o_orderpriority order by o_orderpriority")
    got, calls = _calls(lambda: _mesh_session().execute(sql).to_pylist())
    assert calls["pmax"] >= 1
    assert got == _jax_mesh_session().execute(sql).to_pylist()


# --- hash-partitioned memory headroom -----------------------------------------


def test_grouped_count_distinct_repartitions_not_gathers(monkeypatch):
    """count(DISTINCT) grouped: a hash repartition on the group keys
    (each shard dedupes its own key range), not a gather of raw rows."""
    calls = []
    orig = MX._MeshTraceCtx._hash_repartition

    def spy(self, b, keys):
        calls.append(keys)
        return orig(self, b, keys)

    monkeypatch.setattr(MX._MeshTraceCtx, "_hash_repartition", spy)
    got = _mesh_session().execute(DISTINCT_SQL).to_pylist()
    assert got == tpch_session(SF, device="cpu", result_cache=False).execute(
        DISTINCT_SQL).to_pylist()
    assert got == _jax_mesh_session().execute(DISTINCT_SQL).to_pylist()
    assert calls, "grouped DISTINCT did not take the repartition path"


def test_q3_partitioned_join_exceeds_broadcast_budget(oracle_conn):
    """With the broadcast budget below the build side, the JAX mesh's
    page.  Both packages' cost-based planners keep Q3's joins broadcast
    at that budget (the plan's distribution decides before the
    executor's threshold does), so the partitioned joins run when the
    session asks for them (join_distribution_type): every join then
    repartitions both sides, each shard holding 1/8 of each build."""
    local = tpch_session(SF, device="cpu", result_cache=False).execute(Q3).to_pylist()
    a = _mesh_session(broadcast_join_threshold_rows=1).execute(Q3).to_pylist()
    assert a == local
    assert a == _jax_mesh_session(broadcast_join_threshold_rows=1).execute(Q3).to_pylist()
    mesh = _mesh_session(join_distribution_type="partitioned")
    b, calls = _calls(lambda: mesh.execute(Q3).to_pylist())
    assert calls["all_to_all"] >= 4  # two joins, both sides each
    assert b == local
    assert b == _jax_mesh_session(join_distribution_type="partitioned").execute(
        Q3).to_pylist()
    expected = oracle_conn.execute(oracle_dialect(Q3)).fetchall()
    assert_rows_match(b, expected, tol=2e-2, ordered=True)


# --- supervised dispatch: a shard lost mid-query -------------------------------


def test_device_loss_mid_mesh_shrinks_and_recovers(oracle_conn):
    """A seeded device_loss at the first mesh step: the query finishes on
    the 7 healthy shards, the lost shard is quarantined, the shrink is
    journaled, and the doctor cites it below the device fault.  No step
    runs on another device: the port has no CPU re-run."""
    spec = json.dumps({"device_loss": {"nth": 1, "match": "mesh:"}})
    s = _mesh_session(fault_injection=spec, device_probe_backoff_s=30.0,
                      query_doctor=True)
    page = s.execute(Q6)
    expected = oracle_conn.execute(oracle_dialect(Q6)).fetchall()
    assert_rows_match(page.to_pylist(), expected, tol=2e-2, ordered=True)
    assert page.to_pylist() == tpch_session(
        SF, device="cpu", result_cache=False).execute(Q6).to_pylist()
    prof = s.last_kernel_profile
    assert prof.get("meshShrinks", 0) >= 1 and prof["mesh"]["shards"] == 7
    assert s.device_supervisor.device_state(device_id=0) == QUARANTINED
    evs = [e for e in journal.get_journal().tail(200)
           if e.get("eventType") == journal.MESH_SHRINK]
    assert evs, "mesh shrink left no journal event"
    detail = evs[-1].get("detail") or {}
    assert detail.get("fromSize") == 8 and detail.get("toSize") == 7
    assert detail.get("deviceState") == QUARANTINED
    codes = [f.get("code") for f in (s.last_diagnosis or {}).get("findings", ())]
    assert "mesh_shrink" in codes
    # the fault is the root cause, the shrink its effect
    assert codes.index("device_fault") < codes.index("mesh_shrink")


def test_doctor_rule_precedence_mesh_shrink():
    names = [r.__name__ for r in doctor._RULES]
    assert (names.index("_rule_node_churn") < names.index("_rule_mesh_shrink")
            < names.index("_rule_memory_pressure"))


def test_mesh_refuses_when_no_shard_is_healthy():
    """Every shard quarantined: DeviceFaultError, no CPU re-run."""
    from trino_tpu_torch.runtime import DeviceFaultError

    s = _mesh_session(device_probe_backoff_s=30.0)
    sup = s.device_supervisor
    for d in range(8):
        sup._device(d).state = QUARANTINED
        sup._device(d).next_probe = float("inf")
    with pytest.raises(DeviceFaultError):
        s.execute(Q6)


# --- per-shard task rollups in the timeline ------------------------------------


def test_mesh_timeline_has_per_shard_tasks():
    s = _mesh_session(operator_stats=True)
    s.execute(Q6)
    tl = s.last_timeline
    assert tl and tl.get("stages")
    tasks = [t for st in tl["stages"] for t in st["tasks"]]
    assert len(tasks) == 8
    assert {t["nodeId"] for t in tasks} == {"device-%d" % d for d in range(8)}
    assert all(t["wallS"] >= 0.0 for t in tasks)
    assert sum(t["outputRows"] for t in tasks) > 0


@pytest.mark.parametrize("q", [1, 3, 6])
def test_explain_analyze_over_the_mesh_matches_jax(q):
    """EXPLAIN ANALYZE under distributed = true runs the mesh (the port
    runs the session's own settings; the JAX package its single-node
    executor): every operator's rows over all shards are the JAX
    package's operator rows."""
    sql = "explain analyze " + QUERIES[q][0]
    frames = []
    for s in (_jax_mesh_session(), _mesh_session()):
        s.execute(sql)
        frames.append([(f["operatorType"], f["outputRows"], f.get("inputRows"))
                       for f in s.last_timeline["operators"]])
    assert frames[1] == frames[0] and len(frames[0]) >= 5


# --- on the card ------------------------------------------------------------------


@pytest.mark.cuda
def test_q6_mesh_on_the_card():
    """Q6 over 8 shards on the card: the fused kernel launches once a
    shard, and the page is the one-device page."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python3 chip_smoke.py --phase mesh)")
    mesh = tpch_session(0.01, distributed=True, num_devices=8, result_cache=False)
    one = tpch_session(0.01, result_cache=False)
    before = kn.LAUNCHES["fused_agg_sums"]
    page = mesh.execute(Q6)
    assert kn.LAUNCHES["fused_agg_sums"] - before == 8
    assert page.to_pylist() == one.execute(Q6).to_pylist()

"""The port's device supervisor against the JAX package's.

The unit tests of tests/test_supervisor.py:65-194 on the port's
DeviceSupervisor, with a launch's fault surfacing at the next supervised
sync (CUDA reports an illegal address there) and the loss signatures in
CUDA's words (a launch's non-sticky cudaError is not a loss); Q6 under a
seeded device loss through both sessions, each raising DeviceFaultError
(the JAX package with its `device_cpu_fallback` off: the port has no CPU
re-run), the device quarantined, then restored by the canary and
answering the JAX session's page; the breadcrumb in the kernel profile; and
each of the four kernel wrappers of ops/kernels.py named by a fault
keyed to it (the counterpart of the JAX package's dispatch-guard lint:
every launch crosses the supervised boundary).
"""
import json
import time

import pytest
import torch

import trino_tpu.session as jsession
from tpch_sql import QUERIES
from trino_tpu_torch import convert
from trino_tpu_torch.obs import journal
from trino_tpu_torch.ops import kernels as kn
from trino_tpu_torch.runtime import (
    Breadcrumb,
    DeviceFaultError,
    DeviceSupervisor,
    last_breadcrumb,
)
from trino_tpu_torch.runtime import supervisor as rt
from trino_tpu_torch.runtime.supervisor import ACTIVE, BLACKLISTED, QUARANTINED
from trino_tpu_torch.session import tpch_session
from trino_tpu_torch.utils.faults import FaultInjector

SF = 0.001
Q6 = QUERIES[6][0]


def _sup(**kw):
    kw.setdefault("node_id", "t")
    kw.setdefault("probe_backoff_s", 0.05)
    kw.setdefault("watchdog_timeout_s", 0.0)
    kw.setdefault("device", "cpu")
    return DeviceSupervisor(**kw)


def _sync(sup, what="sync"):
    return sup.device_get(lambda: 1, Breadcrumb(what, mode="sync"))


# --- supervised boundary unit behavior -----------------------------------


def test_dispatch_passthrough_when_healthy():
    sup = _sup()
    bc = Breadcrumb("k0", query_id="q0")
    assert sup.dispatch(lambda: 41 + 1, bc) == 42
    assert _sync(sup) == 1
    assert sup.device_state() == ACTIVE
    assert sup.last_breadcrumb.kernel == "sync"


def test_device_loss_names_culprit_kernel_and_quarantines():
    sup = _sup(fault_injector=FaultInjector({"device_loss": {"nth": 1}}))
    bc = Breadcrumb("grouped_sum_i64", query_id="q1", mode="launch",
                    shapes={"values": "int64(6005,)"}, hbm_reserved_bytes=207360)
    # the launch itself returns (asynchronous); the fault surfaces at the
    # next sync, named after the launch
    assert sup.dispatch(lambda: 1, bc) == 1
    assert sup.device_state() == ACTIVE
    with pytest.raises(DeviceFaultError) as ei:
        _sync(sup, "output copy")
    e = ei.value
    assert e.kind == "device_loss"
    assert e.breadcrumb is bc
    assert e.surfaced_at.kernel == "output copy"
    assert "grouped_sum_i64" in str(e) and "int64(6005,)" in str(e)
    assert "hbm_reserved=207360" in str(e)
    assert "an illegal memory access was encountered" in e.cause_text
    assert [r["recordType"] for r in e.recent][-2:] == ["fault", "fault"]
    assert sup.device_state() == QUARANTINED
    with pytest.raises(DeviceFaultError) as ei2:
        sup.dispatch(lambda: 2, Breadcrumb("k2"))
    assert ei2.value.kind == "device_quarantined"


def test_device_fault_error_is_not_an_out_of_memory_error():
    """The executor's out-of-memory handler (a streamed re-run) must never
    take a device fault for a shortage."""
    e = DeviceFaultError("device_loss", Breadcrumb("k"))
    assert isinstance(e, RuntimeError)
    assert not isinstance(e, torch.OutOfMemoryError)


def test_unrelated_errors_pass_through_unchanged():
    sup = _sup()

    def boom():
        raise ValueError("cap 40 outside [1, 32]")  # an argument-limit error

    with pytest.raises(ValueError):
        sup.dispatch(boom, Breadcrumb("k"))
    with pytest.raises(torch.OutOfMemoryError):
        sup.device_get(lambda: (_ for _ in ()).throw(
            torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")),
            Breadcrumb("s", mode="sync"))
    assert sup.device_state() == ACTIVE  # no strike for non-device errors


@pytest.mark.parametrize("message", [
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: unspecified launch failure",
    "CUDA error: device-side assert triggered",
    "CUDA error: CUDA-capable device(s) is/are busy or unavailable",
    "CUDA error: uncorrectable ECC error encountered",
    "direct_probe launch failed: cudaError 700 (an illegal memory access was "
    "encountered)",
])
def test_cuda_loss_signatures_fault_at_a_sync(message):
    sup = _sup()
    sup.dispatch(lambda: None, Breadcrumb("grouped_count"))
    _sync(sup)  # settles grouped_count
    sup.dispatch(lambda: None, Breadcrumb("fused_agg_sums"))
    sup.dispatch(lambda: None, Breadcrumb("direct_probe", shapes={"key": "int64(9,)"}))

    def raise_it():
        raise RuntimeError(message)

    with pytest.raises(DeviceFaultError) as ei:
        sup.device_get(raise_it, Breadcrumb("output copy", mode="sync"))
    # a real fault names the launches since the last good sync: the last
    # as its breadcrumb, all of them as suspects
    assert ei.value.kind == "device_loss"
    assert ei.value.breadcrumb.kernel == "direct_probe"
    assert ei.value.suspects == ["fused_agg_sums", "direct_probe"]
    assert sup.device_state() == QUARANTINED


def test_wedge_trips_watchdog_and_quarantines():
    sup = _sup(watchdog_timeout_s=0.2, fault_injector=FaultInjector(
        {"device_wedge": {"nth": 1, "stall_s": 1.5}}))
    sup.dispatch(lambda: 1, Breadcrumb("wedgy"))
    t0 = time.time()
    with pytest.raises(DeviceFaultError) as ei:
        _sync(sup)
    assert ei.value.kind == "device_wedge"
    assert ei.value.breadcrumb.kernel == "wedgy"
    assert time.time() - t0 < 1.4  # watchdog fired, not the full stall
    assert sup.device_state() == QUARANTINED


def test_probe_backoff_then_recovery():
    sup = _sup(probe_backoff_s=0.2,
               fault_injector=FaultInjector({"device_loss": {"nth": 1}}))
    sup.dispatch(lambda: 1, Breadcrumb("k"))
    with pytest.raises(DeviceFaultError):
        _sync(sup)
    assert sup.device_state() == QUARANTINED
    assert sup.maybe_probe() is False  # inside the backoff window
    assert sup.device_state() == QUARANTINED
    time.sleep(0.25)
    # rule exhausted: the canary (grouped_count over 8 rows) passes
    assert sup.maybe_probe() is True
    assert sup.last_breadcrumb.mode == "probe"
    assert sup.last_breadcrumb.kernel == "grouped_count"
    assert sup.device_state() == ACTIVE
    assert sup.dispatch(lambda: 7, Breadcrumb("k2")) == 7


def test_n_strikes_blacklists_for_process_lifetime():
    sup = _sup(max_strikes=2, probe_backoff_s=0.01)
    for strike in range(2):
        sup.fault_injector = FaultInjector({"device_loss": {"nth": 1}})
        sup.dispatch(lambda: 1, Breadcrumb(f"k{strike}"))
        with pytest.raises(DeviceFaultError):
            _sync(sup)
        if sup.device_state() != BLACKLISTED:
            time.sleep(0.03)
            sup.fault_injector = None
            assert sup.maybe_probe() is True  # recovered between strikes
    assert sup.device_state() == BLACKLISTED
    time.sleep(0.05)
    assert sup.maybe_probe() is False  # never probed again
    with pytest.raises(DeviceFaultError) as ei:
        sup.dispatch(lambda: 1, Breadcrumb("after"))
    assert ei.value.kind == "device_blacklisted"


@pytest.mark.parametrize("rc", [9, 1, 700, 719])
def test_only_sticky_launch_errors_are_a_loss(rc):
    """ops/kernels._check_rc: a sticky cudaError (the context is lost)
    faults the device; a bad argument or launch configuration fails the
    step and leaves the device ACTIVE."""
    sup = _sup()

    def launch():
        kn._check_rc(rc, "grouped_count")

    if rc in kn._STICKY_ERRORS:
        with pytest.raises(DeviceFaultError) as ei:
            sup.dispatch(launch, Breadcrumb("grouped_count"))
        assert ei.value.kind == "device_loss"
        assert sup.device_state() == QUARANTINED
    else:
        with pytest.raises(RuntimeError, match=f"cudaError {rc}$"):
            sup.dispatch(launch, Breadcrumb("grouped_count"))
        assert sup.device_state() == ACTIVE and sup.faults() == 0


def test_node_state_follows_device_health():
    sup = _sup(fault_injector=FaultInjector({"device_loss": {"nth": 1}}))
    sup._device(1)  # a second card, healthy
    assert sup.node_state() == "ACTIVE"
    sup.dispatch(lambda: 1, Breadcrumb("k"))
    with pytest.raises(DeviceFaultError):
        _sync(sup)
    assert sup.node_state() == "DEGRADED"
    sup.fault_injector = FaultInjector({"device_loss": {"nth": 1}})
    sup.dispatch(lambda: 1, Breadcrumb("k"), device_id=1)
    with pytest.raises(DeviceFaultError):
        sup.device_get(lambda: 1, Breadcrumb("s", mode="sync"), device_id=1)
    assert sup.node_state() == "QUARANTINED"
    assert "fallbacksAttempted" not in sup.snapshot()


def test_breadcrumb_serialization():
    bc = Breadcrumb("dead_beef", query_id="q9", task_id="q9.0.0", node_id="w1",
                    mode="launch", shapes={"a": "int64(10,)"}, hbm_reserved_bytes=80)
    d = bc.to_dict()
    assert d["kernel"] == "dead_beef"
    assert d["queryId"] == "q9"
    assert d["taskId"] == "q9.0.0"
    assert d["hbmReservedBytes"] == 80
    assert d["shapes"] == {"a": "int64(10,)"}
    assert d["ts"] > 0


# --- the session's supervised query path ---------------------------------


def test_q6_device_loss_raises_quarantines_and_recovers():
    """Both packages raise DeviceFaultError (the JAX package with its CPU
    re-run off; the port has none, and SET refuses the property) and
    quarantine the device, which then refuses queries at the gate, also
    EXPLAIN ANALYZE; once the condition clears the canary restores it
    and the port answers the JAX session's page."""
    spec = json.dumps({"device_loss": {"nth": 1}})
    js = jsession.Session(config={"result_cache": False, "fault_injection": spec,
                                  "device_probe_backoff_s": 30.0,
                                  "device_cpu_fallback": False})
    js.create_catalog("tpch", "tpch", {"tpch.scale-factor": SF})
    ts = tpch_session(SF, device="cpu", result_cache=False, fault_injection=spec,
                      device_probe_backoff_s=30.0)
    with pytest.raises(KeyError, match="unknown session property: device_cpu_fallback"):
        ts.execute("set session device_cpu_fallback = true")
    journal._reset_journal()
    for s in (js, ts):
        with pytest.raises(Exception) as ei:
            s.execute(Q6)
        assert type(ei.value).__name__ == "DeviceFaultError"
        assert ei.value.kind == "device_loss"
        assert s.device_supervisor.device_state() == QUARANTINED
        assert s.device_supervisor.node_state() == "QUARANTINED"
    kinds = [e["eventType"] for e in journal.get_journal().tail()]
    assert kinds[:3] == [journal.FAULT_INJECTED, journal.DEVICE_FAULT,
                         journal.DEVICE_QUARANTINE]
    assert journal.CPU_FALLBACK not in kinds
    # the device stays out: the next query is refused at the gate
    for sql in (Q6, "explain analyze " + Q6):
        with pytest.raises(DeviceFaultError, match="device_quarantined"):
            ts.execute(sql)
    # the condition clears: the canary restores the device
    sup = ts.device_supervisor
    ts.properties.set("fault_injection", "")
    js.properties.set("fault_injection", "")
    for s in (js, ts):
        with s.device_supervisor._lock:
            s.device_supervisor._device(0).next_probe = 0.0
        assert s.device_supervisor.maybe_probe() is True
    assert sup.node_state() == "ACTIVE"
    convert.assert_pages_identical(js.execute(Q6), ts.execute(Q6))


def test_kernel_profile_carries_breadcrumb():
    s = tpch_session(SF, device="cpu", result_cache=False)
    s.execute(Q6)
    bc = s.last_kernel_profile.get("last_breadcrumb")
    assert bc is not None and bc["kernel"]
    assert bc["mode"] in ("launch", "operator", "sync", "gate")
    assert (last_breadcrumb() or {}).get("kernel")
    assert s.device_supervisor.device_state() == ACTIVE
    assert s.device_supervisor.faults() == 0
    recs = s.device_supervisor.flight_recorder.tail()
    assert {r["recordType"] for r in recs} <= {"dispatch", "complete"}
    assert any(r["kernel"].startswith("op:") for r in recs)


WRAPPER_QUERIES = {
    "fused_agg_sums": (6, "on"),
    "grouped_count": (1, "off"),
    "grouped_sum_i64": (1, "off"),
    "direct_probe": (3, "on"),
}


@pytest.mark.parametrize("wrapper", sorted(WRAPPER_QUERIES))
def test_every_kernel_wrapper_is_named_by_its_fault(wrapper):
    """A device_loss keyed to one wrapper's name fires at that wrapper's
    launch and surfaces at the next supervised sync, named after the
    wrapper and its shapes: every launch crosses the boundary."""
    q, mode = WRAPPER_QUERIES[wrapper]
    spec = json.dumps({"device_loss": {"match": wrapper, "nth": 1}})
    s = tpch_session(0.002, device="cpu", result_cache=False, megakernels=mode,
                     fault_injection=spec)
    with pytest.raises(DeviceFaultError) as ei:
        s.execute(QUERIES[q][0])
    e = ei.value
    assert e.breadcrumb.kernel == wrapper and e.breadcrumb.mode == "launch"
    assert e.breadcrumb.shapes and e.surfaced_at.mode == "sync"
    assert wrapper in str(e)
    assert s.device_supervisor.snapshot()["lastBreadcrumb"]["kernel"]


def test_kernel_wrappers_outside_a_scope_run_unsupervised():
    assert rt.active() is None
    flags = torch.tensor([True, False, True])
    gid = torch.tensor([0, 1, 0])
    assert kn.grouped_count(flags, gid, 2).tolist() == [2, 0]

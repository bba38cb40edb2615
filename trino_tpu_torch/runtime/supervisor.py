"""Supervised device work: crash attribution and quarantine.

Counterpart of trino_tpu/runtime/supervisor.py, redesigned for an eager
executor on a CUDA card.  The JAX package dispatches one jitted fragment
at a time and syncs it with ``device_get``; the port enqueues thousands
of small torch ops and five hand-written kernels, and a kernel's fault
surfaces only at a later sync, often in another operator.  So the
boundary sits in three places:

- every launch of the five wrappers of ops/kernels.py (``launch``, mode
  "launch"), keyed by the wrapper's name: the ``device_loss`` and
  ``device_wedge`` fault sites match it, as the reference's match its
  fragment digest;
- every operator visit of exec/local.LocalExecutor (``dispatch``, mode
  "operator"), whose breadcrumb names the operator, its input shapes and
  the device bytes reserved, and which turns a CUDA loss raised anywhere
  inside the operator (an unsupervised ``.item()`` of ops/) into a
  DeviceFaultError;
- every device->host sync the executor makes (``device_get``, mode
  "sync"): where asynchronous faults surface.

Each of the three is a span of utils/tracing.TRACER (``operator`` with
the node's type as ``op``, ``launch`` with its ``kernel``, ``sync`` with
its ``what``), whose two clock reads also give the flight recorder's
wall; no span reads the device.

A launch is asynchronous, and so is its fault: an injected fault at a
launch is held pending and raised at the next supervised sync, as CUDA
reports an illegal address.  The DeviceFaultError then names the launch
(``breadcrumb``), the sync it surfaced at (``surfaced_at``) and carries
the flight recorder's last records (``recent``).  A real CUDA error at a
sync names the launches since the last good sync as its suspects.

The watchdog arms only around syncs, never around launches (an enqueue
cannot wedge on its own): ``device_get`` records a CUDA event on the
caller's current stream and polls it from the caller's thread until the
watchdog timeout, so no launch or copy leaves the caller's thread, device
or stream (PyTorch keeps both per thread; a side thread would enqueue on
the default stream and race the streaming executor's upload stream).

On a fault the device goes QUARANTINED with capped exponential backoff
before the next canary probe; after ``device_fault_max_strikes`` faults
inside STRIKE_WINDOW_S it is BLACKLISTED for the process lifetime.  The
canary is a ``grouped_count`` launch on 8 rows, synchronized and held to
its known counts, so recovery is proved on a hand-written kernel (on the
CPU device, its plain version).  A real illegal-address error is sticky:
the process's CUDA context stays broken, the canary then fails for ever,
and the honest outcome is BLACKLISTED.

A fault raises DeviceFaultError and the query fails: the port has no
counterpart of the JAX package's CPU re-run (``device_cpu_fallback``),
so a faulted or misused kernel never hides behind the plain version.

One supervisor exists per node: a Session owns one.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import torch

from ..obs.flight_recorder import device_memory_watermark
from ..utils.metrics import REGISTRY, counter
from ..utils.tracing import TRACER

# device health (per device)
ACTIVE = "ACTIVE"
QUARANTINED = "QUARANTINED"
BLACKLISTED = "BLACKLISTED"
_STATE_CODE = {ACTIVE: 0.0, QUARANTINED: 1.0, BLACKLISTED: 2.0}

# faults inside this window count toward the blacklist strike total;
# older strikes age out (a flaky hour should not doom a week-old process)
STRIKE_WINDOW_S = 600.0

# re-probe backoff never exceeds this, so a recovered device is found
# within half a minute even after a long quarantine
MAX_PROBE_BACKOFF_S = 30.0

# error-message signatures of a LOST or poisoned CUDA context, in the CUDA
# runtime's words (ops/kernels._check_rc names a sticky launch error so).
# Deliberately narrow: torch.OutOfMemoryError (the executor's streaming
# retry handles it), the kernels' argument-limit errors (ValueError) and
# a launch's non-sticky cudaError (a bad argument or launch configuration)
# are never a loss.
_DEVICE_LOSS_SIGNATURES = (
    "an illegal memory access was encountered",
    "unspecified launch failure",
    "device-side assert triggered",
    "CUDA-capable device(s) is/are busy or unavailable",
    "uncorrectable ECC error",
)

# the sync's watchdog spins on the event for this long before polling
# with short sleeps (a short wait then costs no sleep granularity)
_SPIN_S = 0.005
_POLL_S = 0.0002


class Breadcrumb:
    """Crash forensics for ONE supervised step, recorded before it runs.

    When the step never returns (fault, wedge, process death) this is the
    only attribution that exists."""

    def __init__(
        self,
        kernel: str,
        query_id: str = "",
        task_id: str = "",
        node_id: str = "",
        mode: str = "launch",
        shapes: Optional[dict] = None,
        hbm_reserved_bytes: int = 0,
    ):
        self.kernel = kernel          # wrapper name / "op:<Node>" / sync site
        self.query_id = query_id
        self.task_id = task_id
        self.node_id = node_id
        self.mode = mode              # launch | operator | sync | probe | gate
        self.shapes = shapes or {}    # input name -> "dtype(shape)"
        self.hbm_reserved_bytes = int(hbm_reserved_bytes)
        self.ts = time.time()

    def to_dict(self) -> dict:
        return {
            "kernel": self.kernel,
            "queryId": self.query_id,
            "taskId": self.task_id,
            "nodeId": self.node_id,
            "mode": self.mode,
            "shapes": dict(self.shapes),
            "hbmReservedBytes": self.hbm_reserved_bytes,
            "ts": self.ts,
        }

    def __str__(self):
        return (
            f"kernel={self.kernel} mode={self.mode} query={self.query_id}"
            f"{' task=' + self.task_id if self.task_id else ''}"
            f" hbm_reserved={self.hbm_reserved_bytes}"
        )


class DeviceFaultError(RuntimeError):
    """Device work was lost or wedged; names the culprit kernel.

    Not a ``torch.OutOfMemoryError`` on purpose: the executor's
    out-of-memory handler (a streamed re-run) must never take a device
    fault for a shortage."""

    def __init__(self, kind: str, breadcrumb: Breadcrumb,
                 cause: Optional[BaseException] = None,
                 surfaced_at: Optional[Breadcrumb] = None,
                 recent: Optional[List[dict]] = None):
        self.kind = kind              # device_loss | device_wedge | ...
        self.breadcrumb = breadcrumb
        self.surfaced_at = surfaced_at
        self.recent = list(recent or [])
        # a real fault's candidates: the launches since the last good sync
        self.suspects: List[str] = []
        self.cause_text = f"{type(cause).__name__}: {cause}" if cause else ""
        where = ""
        if surfaced_at is not None and surfaced_at is not breadcrumb:
            where = f" surfaced at {surfaced_at.kernel} ({surfaced_at.mode})"
        shapes = f" shapes={breadcrumb.shapes}" if breadcrumb.shapes else ""
        detail = f" [{self.cause_text[:200]}]" if cause else ""
        super().__init__(f"{kind}: {breadcrumb}{shapes}{where}{detail}")


class _WedgeTimeout(Exception):
    """Internal: the watchdog's deadline passed (the card did not finish)."""


class _SimulatedDeviceLoss(RuntimeError):
    """Seeded ``device_loss`` firing: carries a real fault's signature so
    the classifier treats it exactly like a genuine CUDA loss."""


def _is_device_loss(exc: BaseException) -> bool:
    if isinstance(exc, _SimulatedDeviceLoss):
        return True
    if isinstance(exc, (torch.OutOfMemoryError, DeviceFaultError)):
        return False
    msg = str(exc)
    return any(sig in msg for sig in _DEVICE_LOSS_SIGNATURES)


def shape_summary(items: dict, limit: int = 24) -> dict:
    """name -> "dtype(shape)" for tensors (other values as text), at most
    `limit` entries."""
    out = {}
    for name, v in items.items():
        if len(out) >= limit:
            break
        if isinstance(v, torch.Tensor):
            out[name] = f"{str(v.dtype).replace('torch.', '')}{tuple(v.shape)}"
        elif v is not None:
            out[name] = str(v)
    return out


class _DeviceHealth:
    """Per-device fault bookkeeping (state machine + strike window)."""

    def __init__(self, device_id: int):
        self.device_id = device_id
        self.state = ACTIVE
        self.strikes: deque = deque()   # fault timestamps in the window
        self.faults_total = 0
        self.probe_failures = 0
        self.next_probe = 0.0
        self.last_fault_kind = ""


class _Pending:
    """An injected fault of an asynchronous launch, raised at the next
    supervised sync."""

    def __init__(self, kind: str, bc: Breadcrumb, seq: int, stall_s: float):
        self.kind = kind
        self.bc = bc
        self.seq = seq
        self.stall_s = stall_s


# process-wide forensics: the LAST breadcrumb recorded by ANY supervisor
_GLOBAL_LOCK = threading.Lock()
_LAST_BREADCRUMB: Optional[Breadcrumb] = None


def last_breadcrumb() -> Optional[dict]:
    """The most recent breadcrumb in this process (or None)."""
    with _GLOBAL_LOCK:
        return _LAST_BREADCRUMB.to_dict() if _LAST_BREADCRUMB else None


class DeviceSupervisor:
    """Supervised boundary + device state machine for one node.

    The session that owns the node creates one (``device`` is its card)
    and threads it to executors through the exec config
    (``device_supervisor``); chaos specs attach through ``fault_injector``
    like the memory manager's ``oom`` site."""

    def __init__(
        self,
        node_id: str = "local",
        max_strikes: int = 3,
        probe_backoff_s: float = 1.0,
        watchdog_timeout_s: float = 60.0,
        fault_injector=None,
        device=None,
    ):
        self.node_id = node_id
        self.max_strikes = int(max_strikes)
        self.probe_backoff_s = float(probe_backoff_s)
        self.watchdog_timeout_s = float(watchdog_timeout_s)
        self.fault_injector = fault_injector
        self.device = None if device is None else torch.device(device)
        self._lock = threading.RLock()
        self._devices: Dict[int, _DeviceHealth] = {0: _DeviceHealth(0)}
        self.last_breadcrumb: Optional[Breadcrumb] = None
        self._pending: Optional[_Pending] = None
        # the allocator's peak at the last supervised sync
        self._watermark = 0
        # launches since the last settled sync: a real fault's suspects
        self._unsettled: List[Breadcrumb] = []
        from ..obs.flight_recorder import FlightRecorder

        self.flight_recorder = FlightRecorder(
            None, max_records=256, name=node_id
        )
        self._publish_state()

    # -- configuration -------------------------------------------------
    def configure(self, props) -> "DeviceSupervisor":
        """Adopt session properties (dict or SessionProperties)."""
        get = props.get if hasattr(props, "get") else None
        if get is None:
            return self
        for attr, key, cast in (
            ("max_strikes", "device_fault_max_strikes", int),
            ("probe_backoff_s", "device_probe_backoff_s", float),
            ("watchdog_timeout_s", "device_watchdog_timeout_s", float),
        ):
            v = get(key)
            if v is not None and v != "":
                try:
                    setattr(self, attr, cast(v))
                except (TypeError, ValueError):
                    pass
        self._configure_flight_recorder(
            get("flight_recorder_dir"), get("flight_recorder_max_records")
        )
        return self

    def _configure_flight_recorder(self, directory, max_records):
        """Re-point the dispatch ring: an empty dir keeps the in-memory
        mirror; a directory turns on the crash-safe on-disk segments."""
        from ..obs.flight_recorder import FlightRecorder

        directory = str(directory or "").strip() or None
        try:
            max_records = int(max_records or 0) or 512
        except (TypeError, ValueError):
            max_records = 512
        cur = self.flight_recorder
        if (
            cur is not None
            and cur.directory == directory
            and (directory is None or cur.max_records == max_records)
        ):
            return
        if cur is not None:
            cur.close()
        self.flight_recorder = FlightRecorder(
            directory, max_records=max_records, name=self.node_id
        )

    # -- state queries -------------------------------------------------
    def _device(self, device_id: int = 0) -> _DeviceHealth:
        d = self._devices.get(device_id)
        if d is None:
            d = self._devices[device_id] = _DeviceHealth(device_id)
        return d

    def healthy(self, device_id: int = 0) -> bool:
        with self._lock:
            return self._device(device_id).state == ACTIVE

    def device_state(self, device_id: int = 0) -> str:
        with self._lock:
            return self._device(device_id).state

    def faults(self, device_id: int = 0) -> int:
        with self._lock:
            return self._device(device_id).faults_total

    def node_state(self) -> str:
        """ACTIVE (all devices fine) / DEGRADED (some device sick) /
        QUARANTINED (every device out: the node cannot run queries)."""
        with self._lock:
            states = [d.state for d in self._devices.values()]
        if all(s == ACTIVE for s in states):
            return "ACTIVE"
        return "QUARANTINED" if all(s != ACTIVE for s in states) \
            else "DEGRADED"

    def snapshot(self) -> dict:
        """Node + per-device health."""
        with self._lock:
            devices = [
                {
                    "id": d.device_id,
                    "state": d.state,
                    "strikes": len(d.strikes),
                    "faults": d.faults_total,
                    "lastFaultKind": d.last_fault_kind,
                }
                for d in self._devices.values()
            ]
            bc = self.last_breadcrumb
        return {
            "state": self.node_state(),
            "devices": devices,
            "lastBreadcrumb": bc.to_dict() if bc else None,
        }

    # -- breadcrumbs ---------------------------------------------------
    def _record(self, bc: Breadcrumb):
        global _LAST_BREADCRUMB
        bc.node_id = bc.node_id or self.node_id
        with self._lock:
            self.last_breadcrumb = bc
        with _GLOBAL_LOCK:
            _LAST_BREADCRUMB = bc

    # -- fault accounting ----------------------------------------------
    def _fault(self, bc: Breadcrumb, kind: str,
               cause: Optional[BaseException], device_id: int = 0,
               surfaced_at: Optional[Breadcrumb] = None) -> DeviceFaultError:
        now = time.time()
        transition = None
        with self._lock:
            d = self._device(device_id)
            d.faults_total += 1
            d.last_fault_kind = kind
            d.strikes.append(now)
            while d.strikes and now - d.strikes[0] > STRIKE_WINDOW_S:
                d.strikes.popleft()
            if d.state != BLACKLISTED:
                if len(d.strikes) >= self.max_strikes:
                    # N strikes inside the window: out for the process
                    # lifetime — no probe ever reinstates it
                    d.state = BLACKLISTED
                    transition = BLACKLISTED
                else:
                    d.state = QUARANTINED
                    transition = QUARANTINED
                    d.probe_failures += 1
                    d.next_probe = now + self._backoff(d.probe_failures)
            strikes = len(d.strikes)
            self._pending = None
            self._unsettled = []
        counter("trino_tpu_device_faults_total").inc(kind=kind, node=self.node_id)
        self._publish_state()
        from ..obs import journal

        journal.emit(
            journal.DEVICE_FAULT,
            query_id=bc.query_id, task_id=bc.task_id,
            node_id=self.node_id, severity=journal.ERROR,
            kind=kind, kernel=bc.kernel, device=device_id,
            cause=(f"{type(cause).__name__}: {cause}"[:200]
                   if cause else ""),
        )
        if transition is not None:
            journal.emit(
                journal.DEVICE_QUARANTINE if transition == QUARANTINED
                else journal.DEVICE_BLACKLIST,
                query_id=bc.query_id, node_id=self.node_id,
                severity=journal.ERROR,
                device=device_id, strikes=strikes,
            )
        rec = self.flight_recorder
        recent = rec.tail(16) if rec is not None else []
        return DeviceFaultError(kind, bc, cause, surfaced_at, recent)

    def _publish_state(self):
        """The device-state gauge (0 ACTIVE, 1 QUARANTINED, 2 BLACKLISTED)
        of every device of this node."""
        g = REGISTRY.gauge(
            "trino_tpu_device_state",
            "Device health per node (0=ACTIVE, 1=QUARANTINED, "
            "2=BLACKLISTED)",
        )
        with self._lock:
            for d in self._devices.values():
                g.set(_STATE_CODE[d.state], node=self.node_id,
                      device=str(d.device_id))

    def _backoff(self, failures: int) -> float:
        base = max(self.probe_backoff_s, 0.001)
        return min(base * (2 ** max(failures - 1, 0)), MAX_PROBE_BACKOFF_S)

    # -- re-probe ------------------------------------------------------
    def maybe_probe(self, device_id: int = 0) -> bool:
        """Run the canary against a QUARANTINED device once its backoff
        has elapsed; returns True when the device is ACTIVE afterwards.
        BLACKLISTED devices are never probed (process-lifetime ban)."""
        with self._lock:
            d = self._device(device_id)
            if d.state == ACTIVE:
                return True
            if d.state == BLACKLISTED:
                return False
            if time.time() < d.next_probe:
                return False
        ok = self._probe(device_id)
        counter("trino_tpu_device_probe_total").inc(
            node=self.node_id, outcome="ok" if ok else "fail")
        now = time.time()
        with self._lock:
            d = self._device(device_id)
            if d.state == BLACKLISTED:
                return False
            if ok:
                d.state = ACTIVE
                d.probe_failures = 0
                d.next_probe = 0.0
            else:
                d.probe_failures += 1
                d.next_probe = now + self._backoff(d.probe_failures)
        if ok:
            from ..obs import journal

            journal.emit(
                journal.DEVICE_RECOVERED, node_id=self.node_id,
                device=device_id,
            )
        self._publish_state()
        return ok

    def _probe(self, device_id: int) -> bool:
        """The canary: grouped_count over 8 rows on the supervisor's
        device, synchronized and held to its known counts.  Consults the
        fault injector first, so a seeded fault keeps the canary failing
        until its rule clears."""
        from .. import device as D
        from ..ops import kernels as kn

        inj = self.fault_injector
        key = f"probe:{self.node_id}"
        bc = Breadcrumb("grouped_count", node_id=self.node_id, mode="probe",
                        shapes={"flags": "bool(8,)", "gid": "int64(8,)"})
        self._record(bc)
        try:
            if inj is not None:
                if inj.fires("device_wedge", key=key):
                    return False  # a wedged device times the canary out
                if inj.fires("device_loss", key=key):
                    raise _SimulatedDeviceLoss(
                        "an illegal memory access was encountered "
                        "(injected device_loss, canary)"
                    )
            dev = D.resolve(self.device)
            flags = torch.tensor([1, 0, 1, 1, 0, 1, 1, 1], dtype=torch.bool,
                                 device=dev)
            gid = torch.tensor([0, 1, 2, 3, 0, 1, 2, 3], dtype=torch.int64,
                               device=dev)
            with unsupervised():
                got = kn.grouped_count(flags, gid, 4)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return got.cpu().tolist() == [1, 1, 2, 2]
        except Exception:  # noqa: BLE001 — any failure keeps it out
            return False

    # -- the supervised boundary ----------------------------------------
    def _gate(self, bc: Breadcrumb, seq: int, device_id: int):
        with self._lock:
            state = self._device(device_id).state
        if state != ACTIVE:
            # no probe here: this is the hot path; probing happens at
            # the executor's entry
            kind = "device_" + state.lower()
            rec = self.flight_recorder
            if rec is not None:
                rec.record_fault(seq, bc, kind)
            raise DeviceFaultError(kind, bc)

    def dispatch(self, thunk: Callable, bc: Breadcrumb, device_id: int = 0):
        """Run one enqueue — a kernel launch or an operator visit — under
        supervision.

        Records the breadcrumb, refuses if the device is out, fires the
        seeded faults keyed by ``bc.kernel`` (held pending: an
        asynchronous launch's fault surfaces at the next ``device_get``)
        and translates a CUDA loss raised inside the thunk into a
        DeviceFaultError.  Any other exception passes through."""
        self._record(bc)
        rec = self.flight_recorder
        seq = rec.record_dispatch(bc) if rec is not None else 0
        self._gate(bc, seq, device_id)
        inj = self.fault_injector
        if inj is not None:
            rule = inj.rules.get("device_wedge")
            if rule is not None and inj.fires("device_wedge", key=bc.kernel):
                timeout = self.watchdog_timeout_s
                stall = float(rule.get(
                    "stall_s", (timeout * 2.0) if timeout > 0 else 1.0))
                with self._lock:
                    self._pending = _Pending("device_wedge", bc, seq, stall)
            elif inj.fires("device_loss", key=bc.kernel):
                with self._lock:
                    self._pending = _Pending("device_loss", bc, seq, 0.0)
        if bc.mode == "operator":
            # the node's type is an attribute, not the span's name: one
            # name a type would crowd the scan spans out of a trace's
            # top idle-gap names
            span = TRACER.span("operator", op=bc.kernel.rpartition("op:")[2])
        else:
            with self._lock:
                self._unsettled.append(bc)
                del self._unsettled[:-16]
            span = TRACER.span("launch", kernel=bc.kernel)
        with span as sp:
            try:
                out = thunk()
            except DeviceFaultError:
                raise
            except Exception as e:
                if _is_device_loss(e):
                    if rec is not None:
                        rec.record_fault(seq, bc, "device_loss", str(e))
                    raise self._fault(bc, "device_loss", e, device_id) from e
                if rec is not None:
                    # not a device fault: still attributed — the ring shows
                    # which step the error surfaced under
                    rec.record_fault(seq, bc, "error", str(e))
                raise
        if rec is not None:
            # a launch or an operator carries the allocator's peak as the
            # last sync read it: a reading builds the allocator's whole
            # statistics, and a query makes a dozen of these steps; its
            # wall is the span's, off the same two clock reads
            rec.record_complete(seq, bc, sp.end - sp.start, self._watermark)
        return out

    def device_get(self, fn: Callable, bc: Breadcrumb, device=None,
                   device_id: int = 0):
        """A supervised device->host sync: wait for the caller's stream
        under the watchdog, then run ``fn`` (the copy or read) on the
        caller's thread.  A pending injected fault surfaces here, named
        after the launch it fired at; a CUDA loss raised here names the
        launches since the last good sync."""
        self._record(bc)
        rec = self.flight_recorder
        seq = rec.record_dispatch(bc) if rec is not None else 0
        self._gate(bc, seq, device_id)
        with self._lock:
            pending, self._pending = self._pending, None
            suspects = list(self._unsettled)
        with TRACER.span("sync", what=bc.kernel) as sp:
            try:
                self._settle(pending, device)
                if pending is not None and pending.kind == "device_loss":
                    raise _SimulatedDeviceLoss(
                        "an illegal memory access was encountered "
                        f"(injected device_loss at kernel {pending.bc.kernel})"
                    )
                out = fn()
            except _WedgeTimeout as e:
                culprit = pending.bc if pending is not None else bc
                if rec is not None:
                    # the culprit's record last: the ring's tail names it
                    rec.record_fault(seq, bc, "device_wedge", str(e))
                    if pending is not None:
                        rec.record_fault(pending.seq, culprit, "device_wedge", str(e))
                raise self._fault(culprit, "device_wedge", e, device_id,
                                  surfaced_at=bc) from None
            except DeviceFaultError:
                raise
            except Exception as e:
                if _is_device_loss(e):
                    if pending is not None:
                        culprit = pending.bc
                    else:
                        culprit = suspects[-1] if suspects else bc
                    if rec is not None:
                        rec.record_fault(seq, bc, "device_loss", str(e))
                        if culprit is not bc:
                            rec.record_fault(pending.seq if pending else seq,
                                             culprit, "device_loss", str(e))
                    err = self._fault(culprit, "device_loss", e, device_id,
                                      surfaced_at=bc)
                    if pending is None and len(suspects) > 1:
                        err.suspects = [s.kernel for s in suspects]
                    raise err from e
                if rec is not None:
                    rec.record_fault(seq, bc, "error", str(e))
                raise
        with self._lock:
            self._unsettled = []
        if rec is not None:
            self._watermark = device_memory_watermark()
            rec.record_complete(seq, bc, sp.end - sp.start, self._watermark)
        return out

    def _settle(self, pending: Optional[_Pending], device) -> None:
        """Wait until the card has finished the caller's queued work, at
        most the watchdog timeout (0 = no watchdog): an event recorded on
        the caller's current stream, polled from the caller's thread.  A
        pending injected wedge keeps the wait from finishing for its
        stall."""
        stall = pending.stall_s if pending is not None and \
            pending.kind == "device_wedge" else 0.0
        ev = None
        if device is not None and torch.device(device).type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(device))
        timeout = self.watchdog_timeout_s
        start = time.monotonic()
        if not timeout or timeout <= 0:
            if stall:
                time.sleep(stall)  # a wedge without a watchdog ends by itself
            if ev is not None:
                ev.synchronize()
            return
        deadline = start + timeout
        until = start + stall
        while True:
            now = time.monotonic()
            if now >= until and (ev is None or ev.query()):
                return
            if now >= deadline:
                raise _WedgeTimeout(
                    f"device sync exceeded watchdog timeout {timeout:.1f}s"
                )
            if now - start > _SPIN_S:
                time.sleep(min(_POLL_S, max(deadline - now, 0.0)))


# -- the active supervision scope of this thread ---------------------------
# The kernel wrappers have no executor reference: the executor enters a
# scope for the duration of a query, and ops/kernels.launch reads it.

_TLS = threading.local()


class _Scope:
    def __init__(self, sup: DeviceSupervisor, query_id: str, task_id: str,
                 reserved: Callable[[], int]):
        self.sup = sup
        self.query_id = query_id
        self.task_id = task_id
        self.reserved = reserved
        # the supervisor's id of the device the launches go to (a mesh
        # sets it to each shard's id in turn)
        self.device_id = 0

    def crumb(self, kernel: str, mode: str, shapes: dict) -> Breadcrumb:
        return Breadcrumb(kernel, query_id=self.query_id, task_id=self.task_id,
                          mode=mode, shapes=shapes,
                          hbm_reserved_bytes=self.reserved())


def _stack() -> list:
    s = getattr(_TLS, "stack", None)
    if s is None:
        s = _TLS.stack = []
    return s


@contextlib.contextmanager
def supervising(sup: DeviceSupervisor, query_id: str = "", task_id: str = "",
                reserved: Callable[[], int] = lambda: 0):
    """Route this thread's kernel launches through `sup` meanwhile."""
    s = _stack()
    s.append(_Scope(sup, query_id, task_id, reserved))
    try:
        yield s[-1]
    finally:
        s.pop()


@contextlib.contextmanager
def unsupervised():
    """No supervision meanwhile (the canary's own launch)."""
    s = _stack()
    s.append(None)
    try:
        yield
    finally:
        s.pop()


def active() -> Optional[_Scope]:
    s = getattr(_TLS, "stack", None)
    return s[-1] if s else None


def launch(kernel: str, thunk: Callable, shapes: dict):
    """One kernel launch through the thread's active supervisor (the
    wrappers of ops/kernels.py); runs `thunk` alone outside a scope."""
    scope = active()
    if scope is None:
        return thunk()
    return scope.sup.dispatch(
        thunk, scope.crumb(kernel, "launch", shape_summary(shapes)),
        device_id=scope.device_id)


# default supervisor for bare executors (no session wiring)
_DEFAULT: Optional[DeviceSupervisor] = None


def default_supervisor() -> DeviceSupervisor:
    global _DEFAULT
    with _GLOBAL_LOCK:
        if _DEFAULT is None:
            _DEFAULT = DeviceSupervisor(node_id="local")
        return _DEFAULT

"""Seeded fault injection: the chaos harness behind the robustness tests.

Counterpart of trino_tpu/utils/faults.py (copied; firings count through
the port's utils/metrics counters and go to its obs/journal).  Every
site fires in the port as in the JAX package: the device sites at the
supervised kernel boundary, the spool, exchange, task, heartbeat, worker
and coordinator-death sites on the server path.

Reference parity: execution/FailureInjector.java (taskId-addressed one-shot
failures wired through TaskResource's failTask endpoint) generalized into
the config-driven style of Project Tardigrade's BaseFailureRecoveryTest —
named injection SITES across the data plane fire by deterministic seeded
rules, so any chaos run is exactly reproducible from its spec + seed.

A spec is a dict (or its JSON text, shipped as the ``fault_injection``
session/task property): the reserved key ``seed`` seeds every site's RNG;
every other key names a site and maps to a rule:

    {"seed": 7,
     "spool_write_corrupt": {"nth": 1},          # fire on the 1st call
     "exchange_fetch": {"p": 0.5, "times": 2},   # coin-flip, max 2 fires
     "task_stall": {"stall_s": 3.0, "match": ".1.0."}}  # scoped by key

Rule fields: ``nth`` (1-based call index), ``p`` (seeded probability),
neither = always; ``times`` caps total fires; ``match`` restricts the rule
to calls whose key contains the substring; ``stall_s`` / ``flip_byte``
parameterize the stall and corrupt helpers.
"""
from __future__ import annotations

import json
import random
import threading
import time
from typing import Dict, Optional

SITES = (
    "spool_write_corrupt",  # flip a bit in a spool-bound page frame
    "spool_read",           # corrupt spool detection on the read side
    "exchange_fetch",       # transient HTTP failure pulling pages
    "task_run",             # task fails at start (FailureInjector TASK)
    "task_stall",           # straggler injection (TASK_MANAGEMENT_TIMEOUT)
    "heartbeat",            # worker skips an announcement round
    "announce_drop",        # like heartbeat but named for node-churn
                            # chaos: announcement loss without process
                            # death (the GC-pause / partition analog)
    "worker_death",         # hard process exit (kill -9 analog) at task
                            # start; only honored by the WORKER-LEVEL
                            # injector of a subprocess worker — an
                            # in-process worker firing it would take the
                            # whole test runner down
    "cache_read",           # corrupt a spilled result-cache frame on read
    "oom",                  # memory reservation behaves as if the pool
                            # were exhausted (LocalMemoryManager tier)
    "stats_estimate",       # skew a fragment's estimated output rows by
                            # rule field `factor` (adaptive-replan tests)
    "device_loss",          # a kernel launch loses the device (the CUDA
                            # context's illegal-address / launch-failure
                            # class) at the supervised boundary
    "device_wedge",         # kernel dispatch stalls past the watchdog
                            # timeout (rule field `stall_s` overrides)
    "coordinator_death",    # hard coordinator exit (kill -9 analog) at a
                            # chosen WAL transition, keyed
                            # "{recordType}:{queryId}" so `match` picks
                            # the exact transition; only honored by the
                            # COORDINATOR-LEVEL injector of a subprocess
                            # coordinator (server/coordinator_main.py) —
                            # an in-process coordinator firing it would
                            # take the whole test runner down
    "objstore_latency",     # object-store op stalls (rule field
                            # `stall_s`) — the Tail-at-Scale storage
                            # analog; keyed "{op}:{path}" so `match`
                            # scopes it to e.g. metadata reads
    "objstore_error",       # transient object-store failure (S3 500/
                            # SlowDown analog); the fs layer retries with
                            # bounded backoff, so a rule with small
                            # `times` is invisible to callers while a
                            # persistent rule exhausts the retry budget
    "objstore_throttle",    # throttling rejection (S3 503) — retried
                            # like objstore_error but counted separately
                            # so dashboards can tell overload from faults
    "lake_commit_crash",    # hard writer exit (kill -9 analog) BETWEEN
                            # a lakehouse commit's data-file write and
                            # its metadata-pointer CAS, keyed
                            # "{table}:{snapshotId}"; only honored when
                            # TRINO_TPU_CRASH_FAULTS=1 marks the process
                            # as a sacrificial subprocess writer — an
                            # in-process session firing it would take
                            # the whole test runner down
)


class FaultInjector:
    """Named-site fault firing with deterministic seeded rules.

    One instance is shared by everything that should count calls together
    — the worker gives every task carrying the same spec the same
    injector, so "nth call" means the nth call on that worker across the
    whole query, not per task."""

    def __init__(self, rules: Optional[dict] = None, seed: int = 0):
        self.seed = int(seed)
        self.rules: Dict[str, dict] = {}
        for site, spec in (rules or {}).items():
            if site not in SITES:
                raise ValueError(
                    f"unknown fault site {site!r} (expected one of {SITES})"
                )
            self.rules[site] = dict(spec)
        self._lock = threading.RLock()
        self._calls = {s: 0 for s in self.rules}
        self._fired = {s: 0 for s in self.rules}
        self._rng = {
            s: random.Random(f"{self.seed}:{s}") for s in self.rules
        }
        # legacy taskId-addressed one-shot modes (the TaskResource
        # injectFailure endpoint folds into the same harness)
        self._task_modes: Dict[str, str] = {}

    # ------------------------------------------------------------------
    @classmethod
    def from_spec(cls, spec) -> "FaultInjector":
        """Build from a dict, its JSON text, or nothing (disabled)."""
        if not spec:
            return cls()
        if isinstance(spec, str):
            spec = json.loads(spec)
        spec = dict(spec)
        seed = spec.pop("seed", 0)
        return cls(spec, seed=seed)

    def enabled(self) -> bool:
        return bool(self.rules)

    # ------------------------------------------------------------------
    def fires(self, site: str, key: Optional[str] = None) -> bool:
        """Count one call at `site` and decide whether the fault fires."""
        rule = self.rules.get(site)
        if rule is None:
            return False
        with self._lock:
            match = rule.get("match")
            if match is not None and match not in str(key or ""):
                return False
            self._calls[site] += 1
            times = rule.get("times")
            if times is not None and self._fired[site] >= int(times):
                return False
            if "nth" in rule:
                fired = self._calls[site] == int(rule["nth"])
            elif "p" in rule:
                fired = self._rng[site].random() < float(rule["p"])
            else:
                fired = True
            if fired:
                self._fired[site] += 1
                from .metrics import counter

                counter("trino_tpu_fault_injected_total").inc(site=site)
                # journaled BEFORE the fault takes effect: even a
                # worker_death hard-exit leaves the firing on record
                # (the mmap'd page survives os._exit)
                from ..obs import journal

                journal.emit(
                    journal.FAULT_INJECTED, severity=journal.WARN,
                    site=site, key=str(key or "")[:200],
                )
            return fired

    def fired_count(self, site: str) -> int:
        with self._lock:
            return self._fired.get(site, 0)

    def stall(self, site: str = "task_stall", key: Optional[str] = None):
        """Sleep rule['stall_s'] when the site fires (straggler injection)."""
        rule = self.rules.get(site)
        if rule is not None and self.fires(site, key):
            time.sleep(float(rule.get("stall_s", 1.0)))

    def corrupt(
        self, site: str, payload: bytes, key: Optional[str] = None
    ) -> bytes:
        """Flip one deterministic bit of `payload` when the site fires."""
        if not payload or not self.fires(site, key):
            return payload
        rule = self.rules[site]
        pos = rule.get("flip_byte")
        if pos is None:
            pos = self._rng[site].randrange(len(payload))
        buf = bytearray(payload)
        buf[int(pos) % len(buf)] ^= 0x01
        return bytes(buf)

    # -- legacy taskId-addressed modes ---------------------------------
    def set_task_mode(self, task_id: str, mode: str):
        with self._lock:
            self._task_modes[task_id] = mode

    def take_task_mode(self, task_id: str) -> Optional[str]:
        with self._lock:
            return self._task_modes.pop(task_id, None)

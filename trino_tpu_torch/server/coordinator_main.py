"""Standalone coordinator entrypoint:
``python -m trino_tpu_torch.server.coordinator_main``.

Counterpart of trino_tpu/server/coordinator_main.py.  The crash-recovery
harness (testing/runner.SubprocessCoordinator) needs a coordinator the OS
can actually kill: an in-process CoordinatorServer shares its fate with
its parent, so kill -9 semantics (query state machine gone mid-flight,
clients' sockets refuse instantly, only the mmap'd WAL survives) are only
reachable with a real child process.  This entrypoint boots one
distributed CoordinatorServer on ``--device`` (cuda unless "cpu"),
prints a single JSON line ``{"nodeId": ..., "uri": ..., "port": ...}``
on stdout so the parent can target it, and sleeps until SIGTERM.
Workers (worker_main.py) announce to that URI.  Restarting it on the
SAME port with the same ``coordinator_recovery_dir`` exercises the full
recovery path: surviving workers re-announce within one heartbeat, the
WAL replays, and in-flight FTE queries resume from committed spools.

Coordinator-level fault injection (``--fault-injection``) arms the
seeded ``coordinator_death`` site — ``os._exit(137)`` immediately after
a chosen WAL transition lands in the mmap'd segment — which an
in-process coordinator must never fire.
"""
from __future__ import annotations

import argparse
import json
import signal
import sys
import time

DEFAULT_CATALOGS = [["tpch", "tpch", {"tpch.scale-factor": 0.01}]]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="run one trino_tpu_torch coordinator process"
    )
    p.add_argument(
        "--catalogs", default=None,
        help="JSON [[name, connector, config], ...]; default: tpch sf0.01",
    )
    p.add_argument(
        "--properties", default=None,
        help="JSON session properties (coordinator_recovery_dir, "
        "retry_policy, event_journal_dir, ...)",
    )
    p.add_argument(
        "--port", type=int, default=0,
        help="bind port; a restart MUST reuse the crashed coordinator's "
        "port so surviving workers and polling clients reconnect",
    )
    p.add_argument(
        "--fault-injection", default=None,
        help="coordinator-level FaultInjector spec (JSON) arming the "
        "coordinator_death site at a chosen WAL transition",
    )
    p.add_argument(
        "--device", default="cuda",
        help="cuda (the default; fails without a card) or cpu",
    )
    args = p.parse_args(argv)

    from ..session import Session
    from .coordinator import CoordinatorServer

    spec = json.loads(args.catalogs) if args.catalogs else DEFAULT_CATALOGS
    props = json.loads(args.properties) if args.properties else {}
    fault_injection = (
        json.loads(args.fault_injection) if args.fault_injection else None
    )
    session = Session(config=props, device=args.device)
    for name, connector, config in spec:
        session.create_catalog(name, connector, config)
    server = CoordinatorServer(
        session, port=args.port, distributed=True, device=args.device,
        fault_injection=fault_injection,
    ).start()
    print(json.dumps({
        "nodeId": server.coordinator.node_id,
        "uri": server.uri,
        "port": server.port,
    }), flush=True)

    stopping = {"flag": False}

    def _on_sigterm(_sig, _frame):
        stopping["flag"] = True

    # SIGTERM is the graceful stop; only SIGKILL is the crash under test
    signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        while not stopping["flag"]:
            time.sleep(0.2)
    except KeyboardInterrupt:
        pass
    server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())

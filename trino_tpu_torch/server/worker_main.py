"""Standalone worker entrypoint:
``python -m trino_tpu_torch.server.worker_main``.

Counterpart of trino_tpu/server/worker_main.py.  The in-process
DistributedQueryRunner is the default test topology, but a node-churn
harness needs a worker the OS can actually kill — an in-process
WorkerServer shares its fate with its parent, so kill -9 semantics (no
drain, no goodbye announcement, sockets refuse instantly) are only
reachable with a real child process.  This entrypoint boots one
WorkerServer against a running coordinator on ``--device`` (cuda unless
"cpu"), prints a single JSON line ``{"nodeId": ..., "uri": ...}`` on
stdout so the parent can target it, and then sleeps until killed.  On
the card it opens its own CUDA context and loads the kernel libraries
of the package's build directory.

Worker-level fault injection (``--fault-injection``) arms chaos sites the
in-process runner must never fire — ``worker_death`` hard-exits with
status 137 at task start, exactly like the OOM killer.
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
        description="run one trino_tpu_torch worker process"
    )
    p.add_argument(
        "--coordinator", required=True,
        help="coordinator base URI to announce to",
    )
    p.add_argument(
        "--catalogs", default=None,
        help="JSON [[name, connector, config], ...]; default: tpch sf0.01",
    )
    p.add_argument("--port", type=int, default=0)
    p.add_argument(
        "--device", default="cuda",
        help="cuda (the default; fails without a card) or cpu",
    )
    p.add_argument(
        "--device-memory-bytes", type=int, default=None,
        help="this worker's device pool (default: the card's memory)",
    )
    p.add_argument(
        "--fault-injection", default=None,
        help="worker-level FaultInjector spec (JSON {seed, site: rule})",
    )
    # cluster identity: a worker launched with these flags announces
    # itself as a host-sized capacity unit
    p.add_argument(
        "--host", default=None,
        help="host identity to announce (cluster topology)",
    )
    p.add_argument(
        "--process-index", type=int, default=None,
        help="process index within the cluster",
    )
    p.add_argument(
        "--local-devices", type=int, default=None,
        help="logical shards on this worker's device, announced as its "
             "localDevices (default: one a visible card, one on the CPU); "
             "under cross_host_mesh an eligible fragment runs over all of them",
    )
    args = p.parse_args(argv)

    from ..testing.runner import _build_catalogs
    from .worker import WorkerServer

    spec = json.loads(args.catalogs) if args.catalogs else DEFAULT_CATALOGS
    catalogs = _build_catalogs(
        [(name, conn, cfg) for name, conn, cfg in spec]
    )
    fault_injection = (
        json.loads(args.fault_injection) if args.fault_injection else None
    )
    w = WorkerServer(
        catalogs,
        coordinator_uri=args.coordinator,
        port=args.port,
        fault_injection=fault_injection,
        device_memory_bytes=args.device_memory_bytes,
        host=args.host,
        process_index=args.process_index,
        device=args.device,
        local_devices=args.local_devices,
    ).start()
    print(json.dumps({"nodeId": w.node_id, "uri": w.uri}), flush=True)

    # SIGTERM runs the drain walk (the operator's `kill` is a graceful
    # decommission; only SIGKILL is churn): refuse new tasks, finish
    # what's running, announce DRAINED, then exit
    draining = {"flag": False}

    def _on_sigterm(_sig, _frame):
        draining["flag"] = True
        w.start_drain()

    signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        while True:
            time.sleep(0.2)
            if draining["flag"] and w.state == "DRAINED":
                time.sleep(1.0)  # let the DRAINED announcement land
                w.stop()
                return 0
    except KeyboardInterrupt:
        w.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())

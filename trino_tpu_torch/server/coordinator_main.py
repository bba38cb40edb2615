"""Standalone coordinator entrypoint:
``python -m trino_tpu_torch.server.coordinator_main``.

Counterpart of trino_tpu/server/coordinator_main.py, without the
recovery WAL and its chaos site (they come with coordinator recovery).
Boots one distributed CoordinatorServer on ``--device`` (cuda unless
"cpu"), prints a single JSON line ``{"nodeId": ..., "uri": ...,
"port": ...}`` on stdout so the parent can target it, and sleeps until
SIGTERM.  Workers (worker_main.py) announce to that URI.
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
        help="JSON session properties (event_journal_dir, "
        "query_max_memory_bytes, ...)",
    )
    p.add_argument("--port", type=int, default=0, help="bind port")
    p.add_argument(
        "--device", default="cuda",
        help="cuda (the default; fails without a card) or cpu",
    )
    args = p.parse_args(argv)

    from ..session import Session
    from .coordinator import CoordinatorServer

    spec = json.loads(args.catalogs) if args.catalogs else DEFAULT_CATALOGS
    props = json.loads(args.properties) if args.properties else {}
    session = Session(config=props, device=args.device)
    for name, connector, config in spec:
        session.create_catalog(name, connector, config)
    server = CoordinatorServer(
        session, port=args.port, distributed=True, device=args.device,
    ).start()
    print(json.dumps({
        "nodeId": server.coordinator.node_id,
        "uri": server.uri,
        "port": server.port,
    }), flush=True)

    stopping = {"flag": False}

    def _on_sigterm(_sig, _frame):
        stopping["flag"] = True

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

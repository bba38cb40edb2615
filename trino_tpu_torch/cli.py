"""Interactive CLI (client/trino-cli Console + aligned output printer).

Counterpart of trino_tpu/cli.py.  Local mode runs an in-process Session
(StandaloneQueryRunner style) on ``--device`` (cuda unless "cpu"; there
is no --tpu); --server mode speaks the statement protocol to a
coordinator.

  python -m trino_tpu_torch.cli --catalog tpch --sf 0.01
  python -m trino_tpu_torch.cli --device cpu --execute "select 1"
  python -m trino_tpu_torch.cli --server http://127.0.0.1:8080 --execute "..."
"""
from __future__ import annotations

import argparse
import sys
import time


def _align(columns, rows) -> str:
    names = [c["name"] if isinstance(c, dict) else c for c in columns]
    cells = [[("NULL" if v is None else str(v)) for v in r] for r in rows]
    widths = [
        max([len(n)] + [len(r[i]) for r in cells]) for i, n in enumerate(names)
    ]
    sep = "-+-".join("-" * w for w in widths)
    out = [" | ".join(n.ljust(w) for n, w in zip(names, widths)), sep]
    for r in cells:
        out.append(" | ".join(v.ljust(w) for v, w in zip(r, widths)))
    return "\n".join(out)


def run_sql(args, sql: str) -> int:
    t0 = time.time()
    try:
        if args.server:
            from .client.client import StatementClient

            columns, rows = StatementClient(args.server).execute(sql)
        else:
            page = _local_session(args).execute(sql)
            columns = page.names
            rows = page.to_pylist()
    except Exception as e:
        print(f"Query failed: {e}", file=sys.stderr)
        return 1
    print(_align(columns, rows))
    print(f"({len(rows)} rows in {time.time() - t0:.2f}s)")
    return 0


_SESSION = None


def _local_session(args):
    global _SESSION
    key = (args.catalog, args.sf, args.device)
    if _SESSION is None or _SESSION[0] != key:
        from .session import Session, tpch_session, tpcds_session

        if args.catalog == "tpch":
            s = tpch_session(args.sf, device=args.device)
        elif args.catalog == "tpcds":
            s = tpcds_session(args.sf, device=args.device)
        else:
            s = Session(device=args.device)
            s.create_catalog(args.catalog, args.catalog, {})
        _SESSION = (key, s)
    return _SESSION[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="trino-tpu")
    p.add_argument("--server", help="coordinator URI (default: in-process)")
    p.add_argument("--catalog", default="tpch")
    p.add_argument("--sf", type=float, default=0.01, help="tpch scale factor")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; fails without a card) or cpu")
    p.add_argument("--execute", "-e", help="run one statement and exit")
    args = p.parse_args(argv)

    if args.execute:
        return run_sql(args, args.execute)

    print("trino-tpu CLI (end with ; — exit with 'quit')")
    buf = []
    while True:
        try:
            prompt = "trino> " if not buf else "    -> "
            line = input(prompt)
        except EOFError:
            break
        if line.strip().lower() in ("quit", "exit"):
            break
        buf.append(line)
        if line.rstrip().endswith(";"):
            sql = "\n".join(buf).rstrip().rstrip(";")
            buf = []
            if sql.strip():
                run_sql(args, sql)
    return 0


if __name__ == "__main__":
    sys.exit(main())

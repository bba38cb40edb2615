"""The closed loop: each client sends its next query once the last one
is answered, until the window closes; a query sent before the close is
waited for, up to LATE_S seconds, and one that has not come by then
counts as failed.  A request is timed from the client's send to its last row."""
from __future__ import annotations

import threading
import time
import traceback
from typing import Callable, Dict, Iterator, List, Tuple

from . import qgen
from .stats import Window

LATE_S = 60.0


def _client_loop(window: Window, client: int, run: Callable[[str], list],
                 stream: Iterator[Tuple[str, Dict[str, str]]],
                 templates: Dict[str, dict], out: List[dict]) -> None:
    while time.perf_counter() < window.end:
        name, params = next(stream)
        sql = qgen.render(templates[name], params)
        rec = {"client": client, "template": name, "params": params,
               "sent": time.perf_counter(), "done": None, "ok": False}
        out.append(rec)
        try:
            rec["rows"] = run(sql)
            rec["ok"] = True
        except Exception as e:  # a failed query is counted, never timed
            rec["ok"] = False
            rec["error"] = f"{type(e).__name__}: {e}"[:400]
            rec["trace"] = traceback.format_exc()[-2000:]
        rec["done"] = time.perf_counter()


def run_window(seconds: float, clients: List[Callable[[str], list]],
               values: qgen.Values, order: List[str],
               templates: Dict[str, dict]) -> Window:
    """Drive every client for `seconds`; one thread a client beyond the
    first, which runs on the calling thread."""
    window = Window(time.perf_counter(), seconds)
    outs: List[List[dict]] = [[] for _ in clients]
    args = [(window, i, c, qgen.stream(values, i, order, templates), templates,
             outs[i]) for i, c in enumerate(clients)]
    threads = [threading.Thread(target=_client_loop, args=a, daemon=True,
                                name=f"portbench-client-{a[1]}") for a in args[1:]]
    for t in threads:
        t.start()
    _client_loop(*args[0])
    for t in threads:
        t.join(max(0.0, window.end + LATE_S - time.perf_counter()))
    for o in outs:
        for r in o:
            if r["done"] is None:  # never came (its thread runs on, a daemon)
                r.update(ok=False, done=window.end + LATE_S,
                         error=f"no answer within {LATE_S:.0f} s of the close")
    window.requests = sorted((r for o in outs for r in o), key=lambda r: r["sent"])
    return window

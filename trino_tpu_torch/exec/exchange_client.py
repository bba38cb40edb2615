"""Direct exchange client: pull serialized pages from upstream tasks.

Counterpart of trino_tpu/exec/exchange_client.py.  A location is a live
task buffer (pipelined) or a committed spool file (fault-tolerant
execution); both count their frame bytes and decode seconds, and a spool
read also its wall.  A spool read never falls back to HTTP: a damaged
file raises SpoolCorruptionError and the FTE scheduler heals it.

Reference parity: operator/DirectExchangeClient.java:56 (addLocation:154,
pollPage:221) and HttpPageBufferClient.java:98 — async long-poll GET of
``/v1/task/{id}/results/{bufferId}/{token}``, token-acknowledged, with
upstream failure propagation.  Here the pull loop is synchronous per source
with concurrent sources fetched on a small thread pool (the sliding-window
prefetch collapses to "fetch all, fragments are monolithic XLA programs").

Transient-failure handling mirrors HttpPageBufferClient's backoff
(exchange.max-error-duration role): token-addressed result fetches are
idempotent — re-GETting the same /{token} re-reads the same frame — so a
dropped connection or refused socket retries with exponential backoff +
jitter inside a bounded budget before the upstream is declared dead.
410/deleted-task semantics are NOT retried: those are authoritative.
"""
from __future__ import annotations

import random
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

from ..page import Page
from ..serde import deserialize_page
from ..utils.metrics import REGISTRY
from ..utils.tracing import TRACER


class RemoteTaskError(RuntimeError):
    pass


class ExchangeTimeout(RemoteTaskError):
    """An upstream buffer did not complete within the exchange timeout."""


class RemoteHostGoneError(RemoteTaskError):
    """Connection REFUSED by an upstream worker: its process is gone
    (kill -9, OOM-kill, a DRAINED node terminated) — a refused socket is
    authoritative in a way a timeout or reset is not, because the task's
    host was reachable when the location was handed out.  Raised after
    one quick re-probe instead of the full transient backoff so FTE
    reassignment (or retry_policy=query's whole-query retry) starts
    immediately instead of spinning against a dead URI."""

    def __init__(self, uri: str, task: str, detail):
        super().__init__(
            f"REMOTE_HOST_GONE: worker {uri} refused connection while "
            f"fetching task {task}: {detail}"
        )
        self.uri = uri


def _connection_refused(exc: BaseException) -> bool:
    return isinstance(exc, ConnectionRefusedError) or isinstance(
        getattr(exc, "reason", None), ConnectionRefusedError
    )


CREATE_WAIT = 30.0  # max time to wait for an upstream task to appear
RETRY_ATTEMPTS = 3  # transient-error tries per contiguous failure streak
RETRY_BUDGET_S = 5.0  # wall-clock budget for one failure streak
RETRY_BASE_S = 0.1  # first backoff; doubles per consecutive failure
REFUSED_FAST_TRIES = 2  # refused connections before the host is GONE


def _fetch_buffer(
    uri: str,
    task: str,
    buffer: int,
    timeout: float,
    retries: int = RETRY_ATTEMPTS,
    retry_budget_s: float = RETRY_BUDGET_S,
    injector=None,
    cross_host: bool = False,
    stats: Optional[dict] = None,
) -> List[Page]:
    """Poll one upstream (task, buffer) until complete; returns its pages.
    ``stats`` accumulates the frame bytes pulled ("bytes") and the
    seconds spent decoding them ("deserializeS")."""
    pages: List[Page] = []
    token = 0
    seen_task = False
    deadline = time.time() + timeout
    create_deadline = time.time() + CREATE_WAIT
    transient = 0  # consecutive transient failures in the current streak
    refused = 0  # consecutive connection-refused (dead-host fast path)
    streak_deadline = 0.0
    fetch_total = REGISTRY.counter(
        "trino_tpu_exchange_fetch_total", "Exchange buffer-fetch HTTP requests"
    )
    retry_total = REGISTRY.counter(
        "trino_tpu_exchange_retry_total", "Exchange fetch backoff retries"
    )
    fetch_bytes = REGISTRY.counter(
        "trino_tpu_exchange_fetch_bytes", "Serialized page bytes pulled over exchange"
    )
    # genuinely-cross-host series: only fetches whose target is another
    # process's URI — the multi-host acceptance tests assert network
    # exchange on these, never inferring it from totals that local
    # (same-process) fetches also bump
    x_total = x_bytes = None
    if cross_host:
        x_total = REGISTRY.counter(
            "trino_tpu_exchange_cross_host_fetch_total",
            "Exchange fetches targeting a different host process",
        )
        x_bytes = REGISTRY.counter(
            "trino_tpu_exchange_cross_host_fetch_bytes",
            "Serialized page bytes pulled from other host processes",
        )
    while True:
        url = f"{uri}/v1/task/{task}/results/{buffer}/{token}"
        try:
            if injector is not None and injector.fires(
                "exchange_fetch", key=url
            ):
                raise urllib.error.URLError(
                    "injected transient exchange failure"
                )
            fetch_total.inc()
            if x_total is not None:
                x_total.inc()
            with urllib.request.urlopen(url, timeout=10.0) as resp:
                seen_task = True
                transient = 0
                refused = 0
                state = resp.headers.get("X-Task-State", "RUNNING")
                if resp.status == 200:
                    body = resp.read()
                    if body:
                        fetch_bytes.inc(len(body))
                        if x_bytes is not None:
                            x_bytes.inc(len(body))
                        t_de = time.perf_counter()
                        pages.append(deserialize_page(body))
                        if stats is not None:
                            stats["bytes"] += len(body)
                            stats["deserializeS"] += time.perf_counter() - t_de
                    if resp.headers.get("X-Buffer-Complete") == "true":
                        return pages
                    token = int(resp.headers.get("X-Next-Token", token + 1))
                    continue
                # 204: not ready yet
        except urllib.error.HTTPError as e:
            if e.code == 410:
                raise RemoteTaskError(
                    f"upstream task {task} failed: "
                    f"{e.read().decode(errors='replace')}"
                )
            if e.code != 404:
                raise
            if seen_task:
                # the task existed and is now gone: the query was aborted
                # and the task deleted — stop polling immediately
                raise RemoteTaskError(f"upstream task {task} was deleted")
            if time.time() > create_deadline:
                raise RemoteTaskError(
                    f"upstream task {task} never appeared on {uri}"
                )
            # 404 before first contact: task not created yet — keep polling
        except (urllib.error.URLError, ConnectionError, OSError) as e:
            if _connection_refused(e):
                # dead-host fast path: one immediate re-probe absorbs an
                # accept-queue blip, then the host is declared gone —
                # the exponential backoff is reserved for errors a live
                # host can produce (timeout, reset, half-open close)
                refused += 1
                if refused >= REFUSED_FAST_TRIES:
                    REGISTRY.counter(
                        "trino_tpu_exchange_host_gone_total",
                        "Exchange fetches failed fast on a refused "
                        "(dead-host) connection",
                    ).inc()
                    raise RemoteHostGoneError(uri, task, e)
                time.sleep(RETRY_BASE_S)
                continue
            refused = 0
            transient += 1
            if transient == 1:
                streak_deadline = time.time() + retry_budget_s
            if transient > retries or time.time() > min(
                deadline, streak_deadline
            ):
                raise RemoteTaskError(
                    f"upstream worker {uri} unreachable after "
                    f"{transient} tries: {e}"
                )
            retry_total.inc()
            backoff = RETRY_BASE_S * (2 ** (transient - 1))
            time.sleep(min(backoff * (1.0 + random.random()), 2.0))
            continue
        if time.time() > deadline:
            raise ExchangeTimeout(f"exchange timeout on {url}")
        time.sleep(0.02)


class ExchangeClient:
    """Fetches all pages for a task's remote sources."""

    def __init__(
        self,
        timeout: float = 300.0,
        concurrency: int = 8,
        retries: Optional[int] = None,
        retry_budget_s: Optional[float] = None,
        fault_injector=None,
        traceparent: Optional[str] = None,
        own_uri: Optional[str] = None,
    ):
        self.timeout = timeout
        self.concurrency = concurrency
        self.retries = RETRY_ATTEMPTS if retries is None else int(retries)
        self.retry_budget_s = (
            RETRY_BUDGET_S if retry_budget_s is None else float(retry_budget_s)
        )
        self.fault_injector = fault_injector
        # this worker's own base URI: fetches targeting any OTHER uri are
        # cross-host network exchanges and get their own metric series
        self.own_uri = (own_uri or "").rstrip("/")
        # W3C trace context of the hosting task: fetch spans run on pool
        # threads with empty span stacks, so the link must be explicit
        self.traceparent = traceparent
        # OperatorStats blocked-on-exchange: wall of the last
        # fetch_sources call (the worker attributes it to the task's
        # RemoteSource frames), with its frame bytes and decode seconds
        self.last_fetch_wall_s = 0.0
        self.last_fetch_bytes = 0
        self.last_deserialize_s = 0.0
        # fault-tolerant mode: the committed spool files' frame bytes and
        # the wall of reading and decoding them
        self.last_spool_bytes = 0
        self.last_spool_read_s = 0.0

    def fetch_sources(
        self, sources: Dict[int, List[dict]]
    ) -> Dict[int, List[Page]]:
        """sources: fragment_id -> list of locations, each either a live
        task buffer {uri, task, buffer} (pipelined mode) or a committed
        spool file {path} (fault-tolerant mode).  Spool corruption
        propagates as SpoolCorruptionError so the hosting task FAILS and
        the FTE retry loop owns the recovery."""
        out: Dict[int, List[Page]] = {}
        self.last_fetch_wall_s = 0.0
        self.last_fetch_bytes = 0
        self.last_deserialize_s = 0.0
        self.last_spool_bytes = 0
        self.last_spool_read_s = 0.0
        flat = [
            (fid, loc) for fid, locs in sources.items() for loc in locs
        ]
        if not flat:
            return out
        fetch_t0 = time.time()

        fetch_seconds = REGISTRY.histogram(
            "trino_tpu_exchange_fetch_seconds", "Wall time of one exchange source fetch"
        )

        stats = []

        def fetch(loc: dict) -> List[Page]:
            st = {"bytes": 0, "deserializeS": 0.0, "spoolReadS": 0.0}
            stats.append(st)
            if "path" in loc:
                from ..exchange.filesystem import (
                    SpoolCorruptionError,
                    read_spool_pages,
                )

                t_read = time.perf_counter()
                with TRACER.span(
                    "spool_read", traceparent=self.traceparent, path=loc["path"]
                ):
                    if self.fault_injector is not None and (
                        self.fault_injector.fires("spool_read", key=loc["path"])
                    ):
                        raise SpoolCorruptionError(
                            loc["path"], "injected spool read fault"
                        )
                    pages = read_spool_pages(loc["path"], stats=st)
                st["spoolReadS"] = time.perf_counter() - t_read
                st["spoolBytes"] = st["bytes"]
                return pages
            start = time.time()
            with TRACER.span(
                "exchange_fetch",
                traceparent=self.traceparent,
                uri=loc["uri"],
                task=loc["task"],
            ):
                pages = _fetch_buffer(
                    loc["uri"], loc["task"], int(loc["buffer"]), self.timeout,
                    self.retries, self.retry_budget_s, self.fault_injector,
                    cross_host=bool(
                        self.own_uri
                        and loc["uri"].rstrip("/") != self.own_uri
                    ),
                    stats=st,
                )
            fetch_seconds.observe(time.time() - start)
            return pages

        with ThreadPoolExecutor(max_workers=self.concurrency) as pool:
            futures = [(fid, pool.submit(fetch, loc)) for fid, loc in flat]
            for fid, fut in futures:
                out.setdefault(fid, []).extend(fut.result())
        self.last_fetch_wall_s = time.time() - fetch_t0
        self.last_fetch_bytes = sum(st["bytes"] for st in stats)
        self.last_deserialize_s = sum(st["deserializeS"] for st in stats)
        self.last_spool_bytes = sum(st.get("spoolBytes", 0) for st in stats)
        self.last_spool_read_s = sum(st["spoolReadS"] for st in stats)
        return out

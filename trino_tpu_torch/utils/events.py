"""Query event listener SPI.

Counterpart of trino_tpu/utils/events.py.  Reference parity:
spi/eventlistener/ (EventListener, QueryCreatedEvent, QueryCompletedEvent)
dispatched by eventlistener/EventListenerManager + event/QueryMonitor.
Listeners are plugged into the session and the coordinator; payloads
carry the reference's core fields (query id, sql, state, timing, row
counts, error), and cache operations arrive as CacheEvents.
HttpEventListener posts query events to a remote collector
(plugin/trino-http-event-listener analog).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class QueryCreatedEvent:
    query_id: str
    sql: str
    create_time: float


@dataclasses.dataclass(frozen=True)
class QueryCompletedEvent:
    query_id: str
    sql: str
    state: str  # FINISHED | FAILED
    create_time: float
    end_time: float
    output_rows: int = 0
    error: Optional[str] = None

    @property
    def wall_ms(self) -> float:
        return (self.end_time - self.create_time) * 1000


@dataclasses.dataclass(frozen=True)
class CacheEvent:
    """One cache-tier operation (hit/miss/put/evict/spill/heal/...): the
    observability feed behind system.runtime.caches aggregate counters."""

    tier: str  # result | compile | scan
    op: str
    nbytes: int
    time: float


class EventListener:
    """SPI: subclass and register (spi/eventlistener/EventListener)."""

    def query_created(self, event: QueryCreatedEvent):
        pass

    def query_completed(self, event: QueryCompletedEvent):
        pass

    def cache_event(self, event: CacheEvent):
        pass


class EventListenerManager:
    def __init__(self):
        self.listeners: List[EventListener] = []

    def add(self, listener: EventListener):
        self.listeners.append(listener)

    def query_created(self, query_id: str, sql: str) -> float:
        t = time.time()
        ev = QueryCreatedEvent(query_id, sql, t)
        for l in self.listeners:
            l.query_created(ev)
        return t

    def query_completed(self, query_id: str, sql: str, state: str,
                        create_time: float, output_rows: int = 0,
                        error: Optional[str] = None):
        ev = QueryCompletedEvent(
            query_id, sql, state, create_time, time.time(), output_rows, error
        )
        for l in self.listeners:
            l.query_completed(ev)

    def cache_event(self, tier: str, op: str, nbytes: int = 0):
        if not self.listeners:  # hot path: hits/misses fire per query
            return
        ev = CacheEvent(tier, op, int(nbytes), time.time())
        for l in self.listeners:
            l.cache_event(ev)


class HttpEventListener(EventListener):
    """POSTs query events as JSON to a remote collector
    (plugin/trino-http-event-listener analog).  Failures are swallowed:
    eventing must never fail queries.

    Posts flow through one background queue + worker thread, so a slow or
    dead collector backs up into a bounded queue (events then drop) instead
    of spawning an unbounded thread per event."""

    QUEUE_MAX = 1024

    def __init__(self, uri: str, timeout: float = 2.0):
        import queue

        self.uri = uri.rstrip("/")
        self.timeout = timeout
        self._queue: "queue.Queue[dict]" = queue.Queue(maxsize=self.QUEUE_MAX)
        self._worker = None
        self._worker_lock = __import__("threading").Lock()

    def _ensure_worker(self):
        import threading

        with self._worker_lock:
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(
                    target=self._drain, name="http-event-listener", daemon=True
                )
                self._worker.start()

    def _drain(self):
        while True:
            doc = self._queue.get()
            try:
                self._send(doc)
            finally:
                self._queue.task_done()

    def _send(self, doc: dict):
        import json as _json
        import urllib.request

        from .metrics import REGISTRY

        try:
            req = urllib.request.Request(
                self.uri,
                data=_json.dumps(doc).encode(),
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                r.read()
            REGISTRY.counter(
                "trino_tpu_event_posted_total", "Query events delivered to HTTP collectors"
            ).inc()
        except Exception:
            REGISTRY.counter(
                "trino_tpu_event_post_failed_total", "Query event deliveries that errored"
            ).inc()

    def _post(self, doc: dict):
        import queue

        from .metrics import REGISTRY

        # fire-and-forget: eventing must not add latency to the query path
        self._ensure_worker()
        try:
            self._queue.put_nowait(doc)
        except queue.Full:
            REGISTRY.counter(
                "trino_tpu_event_dropped_total",
                "Query events dropped because the listener queue was full",
            ).inc()

    def query_created(self, event: QueryCreatedEvent):
        self._post({
            "event": "QueryCreated",
            "queryId": event.query_id,
            "sql": event.sql,
            "createTime": event.create_time,
        })

    def query_completed(self, event: QueryCompletedEvent):
        self._post({
            "event": "QueryCompleted",
            "queryId": event.query_id,
            "sql": event.sql,
            "state": event.state,
            "wallMillis": event.wall_ms,
            "outputRows": event.output_rows,
            "error": event.error,
        })

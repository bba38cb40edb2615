"""Query event listener SPI.

Counterpart of trino_tpu/utils/events.py, the in-process part (the HTTP
listener waits for the server).  Reference parity: spi/eventlistener/
(EventListener, QueryCreatedEvent, QueryCompletedEvent) dispatched by
eventlistener/EventListenerManager + event/QueryMonitor.  Listeners are
plugged into the session; payloads carry the reference's core fields
(query id, sql, state, timing, row counts, error), and cache operations
arrive as CacheEvents.
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

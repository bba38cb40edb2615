"""Tracing: span recording through the engine's layers.

Counterpart of trino_tpu/utils/tracing.py, its in-process parts: an
OTel-compatible span model (name, trace/span ids, parent, start/end,
attributes) with an in-memory recorder (reference parity: the
OpenTelemetry spans of tracing/TracingMetadata.java, query spans created
in DispatchManager.java:155).  The session opens "query", "parse",
"analyze_plan", "optimize" and "execute" spans (TRACER).  The W3C
`traceparent` propagation across processes and the OTLP file exporter
wait for the server slice.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
import uuid
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    start: float
    end: Optional[float] = None
    attributes: Dict[str, Any] = dataclasses.field(default_factory=dict)


class Tracer:
    """Per-process tracer with thread-local span stacks.

    Completed spans land in a bounded ring buffer (oldest dropped first)
    so a long-lived process holds at most `max_spans` spans in memory.
    """

    DEFAULT_MAX_SPANS = 4096

    def __init__(self, max_spans: int = DEFAULT_MAX_SPANS):
        self.max_spans = max_spans
        self.spans: "collections.deque[Span]" = collections.deque(maxlen=max_spans)
        self._local = threading.local()
        self._lock = threading.Lock()

    def _stack(self) -> List[Span]:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    @contextlib.contextmanager
    def span(self, name: str, **attributes):
        """Open a span, a child of the calling thread's open span."""
        stack = self._stack()
        parent = stack[-1] if stack else None
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            trace_id, parent_id = uuid.uuid4().hex, None
        s = Span(
            name=name,
            trace_id=trace_id,
            span_id=uuid.uuid4().hex[:16],
            parent_id=parent_id,
            start=time.time(),
            attributes=dict(attributes),
        )
        stack.append(s)
        try:
            yield s
        finally:
            s.end = time.time()
            stack.pop()
            with self._lock:
                self.spans.append(s)

    def clear(self):
        with self._lock:
            self.spans.clear()


TRACER = Tracer()

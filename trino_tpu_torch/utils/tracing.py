"""Tracing: span recording through the engine's layers.

Counterpart of trino_tpu/utils/tracing.py: an OTel-compatible span model
(name, trace/span ids, parent, start/end, attributes) with an in-memory
recorder, the W3C `traceparent` propagation across processes
(coordinator -> worker task dispatch, exchange fetch threads) and an
OTLP/JSON file exporter.  Reference parity: the OpenTelemetry spans of
tracing/TracingMetadata.java, query/task spans created in
DispatchManager.java:155 and SqlTaskManager.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import random
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

    @property
    def traceparent(self) -> str:
        return format_traceparent(self.trace_id, self.span_id)


def format_traceparent(trace_id: str, span_id: str) -> str:
    """W3C Trace Context `traceparent`: version-traceid-spanid-flags."""
    return "00-%s-%s-01" % (trace_id, span_id)


def parse_traceparent(header: Optional[str]) -> Optional[Dict[str, str]]:
    """Parse a W3C `traceparent` header into trace/parent span ids.

    Returns None for absent or malformed headers (per spec, an invalid
    header means "start a fresh trace", never an error).
    """
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) < 4:
        return None
    _version, trace_id, span_id = parts[0], parts[1], parts[2]
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16)
        int(span_id, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return {"trace_id": trace_id, "parent_id": span_id}


# span ids: W3C ids need only be unique, so a private generator seeded
# from the OS spares each span a uuid4's read of os.urandom (reseeded in
# a forked child, which would otherwise repeat its parent's ids)
_IDS = random.Random()
os.register_at_fork(after_in_child=_IDS.seed)


class Tracer:
    """Per-process tracer with thread-local span stacks.

    Completed spans land in a bounded ring buffer (oldest dropped first)
    so a long-lived process with no exporter attached holds at most
    `max_spans` spans in memory.
    """

    DEFAULT_MAX_SPANS = 4096

    def __init__(self, max_spans: int = DEFAULT_MAX_SPANS):
        self.max_spans = max_spans
        self.spans: "collections.deque[Span]" = collections.deque(maxlen=max_spans)
        self.exporter: Optional["OtlpFileExporter"] = None
        self._local = threading.local()
        self._lock = threading.Lock()

    def _stack(self) -> List[Span]:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    @contextlib.contextmanager
    def span(self, name: str, traceparent: Optional[str] = None, **attributes):
        """Open a span.  A remote `traceparent` joins that trace when the
        calling thread has no local parent (the Dapper cross-process link:
        coordinator->worker dispatch, exchange fetch threads).

        Start and end are epoch seconds read from ``time.time_ns()``, the
        clock torch.profiler's events are on, so a device trace's idle
        gaps can be put down to the span open at the time.  The yielded
        span's ``attributes`` may be added to before it closes."""
        stack = self._stack()
        parent = stack[-1] if stack else None
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            remote = parse_traceparent(traceparent)
            if remote is not None:
                trace_id, parent_id = remote["trace_id"], remote["parent_id"]
            else:
                trace_id, parent_id = uuid.uuid4().hex, None
        s = Span(
            name=name,
            trace_id=trace_id,
            span_id="%016x" % _IDS.getrandbits(64),
            parent_id=parent_id,
            start=time.time_ns() / 1e9,
            attributes=attributes,
        )
        stack.append(s)
        try:
            yield s
        finally:
            s.end = time.time_ns() / 1e9
            stack.pop()
            with self._lock:
                self.spans.append(s)

    def current_span(self) -> Optional[Span]:
        stack = self._stack()
        return stack[-1] if stack else None

    def current_traceparent(self) -> Optional[str]:
        s = self.current_span()
        return s.traceparent if s is not None else None

    def clear(self):
        with self._lock:
            self.spans.clear()

    # -- export ---------------------------------------------------------
    def attach_exporter(self, exporter: "OtlpFileExporter"):
        self.exporter = exporter

    def flush(self):
        """Export + drop all recorded spans (called at query completion —
        the airlift OTel exporter's batch-flush role).  Without an exporter
        spans stay in memory for tests/system tables."""
        exporter = self.exporter
        if exporter is None:
            return
        with self._lock:
            spans = list(self.spans)
            self.spans.clear()
        if spans:
            exporter.export(spans)


class OtlpFileExporter:
    """OTLP/JSON span exporter writing one `resourceSpans` document per
    flush to a local file (newline-delimited) — the OpenTelemetry wire
    schema (trace service ExportTraceServiceRequest JSON mapping), minus
    the network: an OTel collector can tail the file, and air-gapped
    environments (like the bench TPU) still get durable traces.

    Reference parity: airlift's OpenTelemetry exporter wired through
    tracing/TracingMetadata.java + TrinoAttributes span schema.
    """

    def __init__(self, path: str, service_name: str = "trino-tpu"):
        self.path = path
        self.service_name = service_name
        self._lock = threading.Lock()

    def export(self, spans: List[Span]):
        import json

        doc = {
            "resourceSpans": [{
                "resource": {"attributes": [{
                    "key": "service.name",
                    "value": {"stringValue": self.service_name},
                }]},
                "scopeSpans": [{
                    "scope": {"name": "trino_tpu"},
                    "spans": [
                        {
                            "traceId": s.trace_id,
                            "spanId": s.span_id,
                            "parentSpanId": s.parent_id or "",
                            "name": s.name,
                            "startTimeUnixNano": int(s.start * 1e9),
                            "endTimeUnixNano": int(
                                (s.end or s.start) * 1e9
                            ),
                            "attributes": [
                                {"key": k,
                                 "value": {"stringValue": str(v)}}
                                for k, v in s.attributes.items()
                            ],
                        }
                        for s in spans
                    ],
                }],
            }]
        }
        with self._lock:
            with open(self.path, "a") as f:
                f.write(json.dumps(doc) + "\n")


TRACER = Tracer()

# TRINO_TPU_OTLP_FILE wires the process tracer to a file exporter at
# import (the etc/config.properties tracing.* binding analog)
_otlp = os.environ.get("TRINO_TPU_OTLP_FILE")
if _otlp:
    TRACER.attach_exporter(OtlpFileExporter(_otlp))

"""Client protocol types: query results JSON model.

Counterpart of trino_tpu/server/protocol.py (copied).

Reference parity: client/trino-client (QueryResults/QueryData JSON model,
StatementClientV1.java:69) and server/protocol/
(QueuedStatementResource.java:105, ExecutingStatementResource.java:71).

The wire format is a compatible subset of the reference's /v1/statement
protocol: POST returns a QueryResults document; paging via nextUri; column
type names use the reference's spelling (bigint, decimal(p,s), varchar,
date, double).
"""
from __future__ import annotations

from typing import List, Optional

from .. import types as T
from ..page import Page


def type_name(t: T.Type) -> str:
    return str(t)


def columns_json(page: Page, types: List[T.Type]) -> list:
    return [
        {
            "name": name,
            "type": type_name(t),
            "typeSignature": {"rawType": t.name, "arguments": []},
        }
        for name, t in zip(page.names, types)
    ]


def data_json(page: Page) -> list:
    from decimal import Decimal

    # wide decimals decode to decimal.Decimal; the wire sends them as
    # strings (StatementClientV1 decimal representation)
    return [
        [str(v) if isinstance(v, Decimal) else v for v in row]
        for row in page.to_pylist()
    ]


def query_results(
    query_id: str,
    state: str,
    page: Optional[Page] = None,
    types: Optional[List[T.Type]] = None,
    next_uri: Optional[str] = None,
    error: Optional[str] = None,
    stats: Optional[dict] = None,
) -> dict:
    doc = {
        "id": query_id,
        "infoUri": f"/ui/query/{query_id}",
        "stats": {
            "state": state,
            "queued": state == "QUEUED",
            "scheduled": state not in ("QUEUED",),
            **(stats or {}),
        },
    }
    if next_uri:
        doc["nextUri"] = next_uri
    if page is not None:
        doc["columns"] = columns_json(page, types)
        doc["data"] = data_json(page)
    if error:
        doc["error"] = error_json(error)
    return doc


# error strings carrying one of these structured prefixes ("CODE: ...")
# render as named retryable errors (EXTERNAL, like the reference's
# REMOTE_HOST_GONE retry class) instead of GENERIC_INTERNAL_ERROR —
# clients re-submit instead of surfacing a failure
RETRYABLE_ERROR_CODES = {
    "COORDINATOR_RESTART": 65544,
}


def error_json(error: str) -> dict:
    code, sep, _rest = str(error).partition(":")
    code = code.strip()
    if sep and code in RETRYABLE_ERROR_CODES:
        return {
            "message": error,
            "errorCode": RETRYABLE_ERROR_CODES[code],
            "errorName": code,
            "errorType": "EXTERNAL",
            "retriable": True,
        }
    return {
        "message": error,
        "errorCode": 1,
        "errorName": "GENERIC_INTERNAL_ERROR",
        "errorType": "INTERNAL_ERROR",
    }

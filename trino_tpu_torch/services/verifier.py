"""Verifier: A/B correctness comparison of two engines.

Counterpart of trino_tpu/services/verifier.py (copied; a server endpoint
is driven through this package's StatementClient).

Reference parity: service/trino-verifier (Validator, VerifierDao): replays
each query against a *control* and a *test* endpoint and compares
normalized results — the harness used to validate new engine versions
against known-good ones.  Endpoints are either server URIs (driven through
the statement protocol) or in-process Sessions.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class VerificationResult:
    query: str
    status: str  # MATCH | MISMATCH | CONTROL_FAILED | TEST_FAILED
    control_ms: float = 0.0
    test_ms: float = 0.0
    detail: Optional[str] = None


def _normalize(rows, tol=1e-6):
    out = []
    for r in rows:
        norm = []
        for v in r:
            if isinstance(v, float):
                norm.append(round(v, 6))
            else:
                norm.append(v)
        out.append(tuple(norm))
    return sorted(out, key=repr)


class _SessionRunner:
    def __init__(self, session):
        self.session = session

    def run(self, sql: str):
        return self.session.execute(sql).to_pylist()


class _ServerRunner:
    def __init__(self, uri: str):
        from ..client.client import StatementClient

        self.client = StatementClient(uri)

    def run(self, sql: str):
        _, rows = self.client.execute(sql)
        return [tuple(r) for r in rows]


def _runner(endpoint):
    if isinstance(endpoint, str):
        return _ServerRunner(endpoint)
    return _SessionRunner(endpoint)


class Verifier:
    """Replays queries control-vs-test and diffs results (Validator)."""

    def __init__(self, control, test):
        self.control = _runner(control)
        self.test = _runner(test)

    def verify_one(self, sql: str) -> VerificationResult:
        t0 = time.perf_counter()
        try:
            expected = self.control.run(sql)
        except Exception as e:
            return VerificationResult(
                sql, "CONTROL_FAILED", detail=f"{type(e).__name__}: {e}"
            )
        control_ms = (time.perf_counter() - t0) * 1000
        t1 = time.perf_counter()
        try:
            actual = self.test.run(sql)
        except Exception as e:
            return VerificationResult(
                sql, "TEST_FAILED", control_ms=control_ms,
                detail=f"{type(e).__name__}: {e}",
            )
        test_ms = (time.perf_counter() - t1) * 1000
        a, b = _normalize(expected), _normalize(actual)
        if a == b:
            return VerificationResult(sql, "MATCH", control_ms, test_ms)
        detail = (
            f"control {len(a)} rows vs test {len(b)} rows; "
            f"first control row: {a[0] if a else None!r}; "
            f"first test row: {b[0] if b else None!r}"
        )
        return VerificationResult(sql, "MISMATCH", control_ms, test_ms, detail)

    def verify(self, queries: Sequence[str]) -> List[VerificationResult]:
        return [self.verify_one(q) for q in queries]

    @staticmethod
    def summarize(results: Sequence[VerificationResult]) -> dict:
        out = {"MATCH": 0, "MISMATCH": 0, "CONTROL_FAILED": 0,
               "TEST_FAILED": 0}
        for r in results:
            out[r.status] += 1
        out["total"] = len(results)
        return out

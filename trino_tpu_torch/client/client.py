"""Statement client: the nextUri pull loop.

Counterpart of trino_tpu/client/client.py (copied).

Reference parity: client/trino-client StatementClientV1.java:69 —
POST /v1/statement (:141), advance() loop (:349) following nextUri until
FINISHED/FAILED, accumulating data pages.

Coordinator-restart transparency (server/recovery.py): nextUri tokens
encode the query id (never an in-memory handle), so the poll loop rides
out a coordinator kill -9 + restart:

  - connection refused / reset while the process is down: bounded
    backoff up to ``restart_grace_s`` (the same-port restart re-binds
    within that window) instead of three fast attempts and death;
  - HTTP 503 + Retry-After during the recovery window (the restarted
    coordinator is still replaying its WAL): wait as told and re-poll;
  - a structured retryable error document (errorName
    COORDINATOR_RESTART, retriable=true — the orphaned-pipelined-query
    verdict): re-submit the original SQL once per allowance, exactly the
    reference client's retry class for EXTERNAL failures.
"""
from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import List, Optional, Tuple

# transient transport blips (a loaded ThreadingHTTPServer resets the odd
# connection) get this many fast retries before the restart grace kicks in
FAST_POLL_ATTEMPTS = 3


class ClientError(RuntimeError):
    pass


class StatementClient:
    def __init__(self, server: str, user: str = "trino-tpu",
                 password: Optional[str] = None, source: str = "",
                 restart_grace_s: float = 10.0,
                 max_resubmits: int = 1):
        self.server = server.rstrip("/")
        self.user = user
        self.password = password
        self.source = source
        # how long polls survive a dead/restarting coordinator before
        # the failure is surfaced (0 restores fail-fast behavior)
        self.restart_grace_s = float(restart_grace_s)
        # how many times a structured retryable error (COORDINATOR_
        # RESTART) re-submits the original SQL before surfacing
        self.max_resubmits = int(max_resubmits)

    def _headers(self) -> dict:
        headers = {"X-Trino-User": self.user}
        if self.source:
            headers["X-Trino-Source"] = self.source
        if self.password is not None:
            import base64

            cred = base64.b64encode(
                f"{self.user}:{self.password}".encode()
            ).decode()
            headers["Authorization"] = f"Basic {cred}"
        return headers

    def execute(self, sql: str) -> Tuple[List[dict], List[list]]:
        """Returns (columns, rows)."""
        resubmits = 0
        while True:
            try:
                return self._execute_once(sql)
            except ClientError as e:
                if (
                    getattr(e, "retryable", False)
                    and resubmits < self.max_resubmits
                ):
                    # the server said this failure is the SERVER'S fault
                    # and safe to retry (coordinator restart orphaned a
                    # pipelined query): re-submit, don't surface
                    resubmits += 1
                    continue
                raise

    def _execute_once(self, sql: str) -> Tuple[List[dict], List[list]]:
        headers = self._headers()
        req = urllib.request.Request(
            f"{self.server}/v1/statement",
            data=sql.encode(),
            method="POST",
            headers=headers,
        )
        with urllib.request.urlopen(req) as resp:
            doc = json.load(resp)
        columns: List[dict] = []
        rows: List[list] = []
        while True:
            if "columns" in doc:
                columns = doc["columns"]
            if "data" in doc:
                rows.extend(doc["data"])
            err = doc.get("error")
            if err:
                e = ClientError(err.get("message", "query failed"))
                e.retryable = bool(err.get("retriable"))
                e.error_name = err.get("errorName")
                raise e
            nxt = doc.get("nextUri")
            if not nxt:
                break
            doc = self._poll(nxt, headers)
        return columns, rows

    def _poll(self, nxt: str, headers: dict) -> dict:
        """One idempotent status GET, retried through transport blips,
        coordinator downtime (restart grace), and 503 recovery waits."""
        grace_deadline = time.time() + self.restart_grace_s
        attempt = 0
        while True:
            poll = urllib.request.Request(
                self.server + nxt, headers=headers
            )
            try:
                with urllib.request.urlopen(poll) as resp:
                    return json.load(resp)
            except urllib.error.HTTPError as e:
                if e.code == 503 and time.time() < grace_deadline:
                    # recovery window: the restarted coordinator is
                    # still replaying its WAL — wait as told, re-poll
                    try:
                        retry_after = float(
                            e.headers.get("Retry-After") or 1.0
                        )
                    except (TypeError, ValueError):
                        retry_after = 1.0
                    time.sleep(min(retry_after, 2.0))
                    continue
                raise
            except (ConnectionResetError, urllib.error.URLError):
                attempt += 1
                if attempt < FAST_POLL_ATTEMPTS:
                    time.sleep(0.05 * attempt)
                    continue
                if time.time() >= grace_deadline:
                    raise
                # the coordinator itself is down (refused/reset beyond
                # transient): a same-port restart re-binds within the
                # grace window, and the query-id-addressed nextUri stays
                # valid across it
                time.sleep(0.25)

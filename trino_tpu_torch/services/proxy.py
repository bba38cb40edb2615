"""Statement-protocol proxy.

Counterpart of trino_tpu/services/proxy.py (copied).

Reference parity: service/trino-proxy — an HTTP proxy in front of a
coordinator that forwards the statement protocol (POST /v1/statement +
nextUri GETs + DELETE cancels), preserving identity/authorization headers
so the backend performs the real authentication.
"""
from __future__ import annotations

import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_FORWARD_HEADERS = (
    "X-Trino-User", "X-Trino-Source", "Authorization", "Content-Type",
)


class _ProxyHandler(BaseHTTPRequestHandler):
    backend: str = ""

    def log_message(self, fmt, *args):  # quiet
        pass

    def _forward(self, method: str):
        body = None
        n = int(self.headers.get("Content-Length", 0) or 0)
        if n:
            body = self.rfile.read(n)
        req = urllib.request.Request(
            self.backend + self.path, data=body, method=method
        )
        for h in _FORWARD_HEADERS:
            v = self.headers.get(h)
            if v:
                req.add_header(h, v)
        try:
            with urllib.request.urlopen(req) as resp:
                payload = resp.read()
                self.send_response(resp.status)
                for k, v in resp.headers.items():
                    if k.lower() in ("content-type",):
                        self.send_header(k, v)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
        except urllib.error.HTTPError as e:
            payload = e.read()
            self.send_response(e.code)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

    def do_POST(self):
        self._forward("POST")

    def do_GET(self):
        self._forward("GET")

    def do_DELETE(self):
        self._forward("DELETE")


class ProxyServer:
    """Forwarding proxy handle (TestingTrinoProxy analog)."""

    def __init__(self, backend_uri: str, port: int = 0):
        handler = type(
            "Handler", (_ProxyHandler,), {"backend": backend_uri.rstrip("/")}
        )
        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), handler)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )

    def start(self) -> "ProxyServer":
        self.thread.start()
        return self

    def stop(self):
        self.httpd.shutdown()

    @property
    def uri(self) -> str:
        return f"http://127.0.0.1:{self.port}"

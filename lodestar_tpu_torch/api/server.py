"""REST server over the route table (stdlib http.server).

Reference: `api/src/utils/server/genericJsonServer.ts` + fastify
registration in `beacon-node/src/api/rest/` — here a ThreadingHTTPServer
binds `routes.API_ROUTES` to a `BeaconApiImpl` by operation id.

The port's copy of the JAX package's `api/server.py`.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qsl, urlparse

from .impl import ApiError
from .routes import match_route


class BeaconApiServer:
    def __init__(
        self, impl, host: str = "127.0.0.1", port: int = 0, matcher=None,
        metrics=None, bearer_token: str | None = None,
        cors_origin: str | None = None,
    ):
        """`matcher(method, path) -> (route, params)`: defaults to the
        beacon route table; the keymanager server passes its own.

        `bearer_token`: when set, every request must carry
        `Authorization: Bearer <token>` or is refused with 401 — the
        reference's fastify bearer-auth plugin (`api/rest/index.ts:52-58`,
        keymanager server requires it; beacon server opt-in).
        `cors_origin`: when set, responses carry CORS headers for that
        origin (`*` allowed) and OPTIONS preflights are answered —
        the reference's fastify-cors registration (`api/rest/index.ts:47-50`).
        """
        self.impl = impl
        impl_ref = impl
        match = matcher if matcher is not None else match_route
        metrics_ref = metrics
        token_ref = bearer_token
        cors_ref = cors_origin

        def _observe(path: str, status: int, seconds: float) -> None:
            if metrics_ref is None:
                return
            # bounded cardinality: the namespace segment, not the full path
            parts = path.split("/")
            ns = parts[2] if len(parts) > 2 else "root"
            metrics_ref.api_requests_total.inc(
                namespace=ns, status=f"{status // 100}xx"
            )
            metrics_ref.api_request_seconds.observe(seconds, namespace=ns)

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def _authorized(self) -> bool:
                if token_ref is None:
                    return True
                import hmac

                header = self.headers.get("Authorization", "")
                # constant-time compare (the reference's fastify
                # bearer-auth does the same) — no timing oracle on the
                # token; bytes (not str) because compare_digest raises on
                # non-ASCII str and headers arrive latin-1-decoded
                return hmac.compare_digest(
                    header.encode("latin-1", "replace"),
                    f"Bearer {token_ref}".encode(),
                )

            def _handle(self, method: str):
                if not self._authorized():
                    return self._send(
                        401, {"message": "missing or invalid bearer token"}
                    )
                parsed = urlparse(self.path)
                if method == "GET" and parsed.path == "/eth/v1/events":
                    return self._handle_events(parsed)
                route, params = match(method, parsed.path)
                if route is None:
                    return self._send(404, {"message": "route not found"})
                query = dict(parse_qsl(parsed.query))
                body = None
                length = int(self.headers.get("Content-Length") or 0)
                if length:
                    try:
                        body = json.loads(self.rfile.read(length))
                    except json.JSONDecodeError:
                        return self._send(400, {"message": "invalid JSON body"})
                handler = getattr(impl_ref, route.operation_id, None)
                if handler is None:
                    return self._send(501, {"message": "not implemented"})
                try:
                    result = handler(params, query, body)
                except ApiError as e:
                    return self._send(e.status, {"message": e.message})
                except Exception as e:
                    return self._send(500, {"message": f"internal error: {e}"})
                if result is None:
                    return self._send(200, {})
                return self._send(200, {"data": result})

            def _handle_events(self, parsed):
                """SSE event stream (reference `beacon/server/events.ts:25`):
                `event: <topic>\\ndata: <json>\\n\\n` frames until the client
                disconnects. Topics filtered by the ?topics= query."""
                import queue as _queue

                chain = getattr(impl_ref, "chain", None)
                emitter = getattr(chain, "emitter", None)
                if emitter is None:
                    return self._send(501, {"message": "no event source"})
                from ..chain.emitter import ChainEvent

                # both array forms: topics=a&topics=b and topics=a,b
                wanted = {
                    t
                    for key, value in parse_qsl(parsed.query)
                    if key == "topics"
                    for t in value.split(",")
                    if t
                } or {e.value for e in ChainEvent}
                q: _queue.Queue = _queue.Queue(maxsize=256)

                def on_event(event, payload):
                    if event.value in wanted:
                        try:
                            q.put_nowait((event.value, payload))
                        except _queue.Full:
                            pass  # slow consumer: drop rather than block import

                for e in ChainEvent:
                    emitter.on(e, on_event)
                if metrics_ref is not None:
                    metrics_ref.api_sse_subscribers.inc(1)
                try:
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self._cors_headers()
                    self.end_headers()
                    while True:
                        try:
                            name, payload = q.get(timeout=1.0)
                        except _queue.Empty:
                            self.wfile.write(b": keep-alive\n\n")
                            self.wfile.flush()
                            continue
                        frame = f"event: {name}\ndata: {json.dumps(payload)}\n\n"
                        self.wfile.write(frame.encode())
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass  # client went away
                finally:
                    if metrics_ref is not None:
                        metrics_ref.api_sse_subscribers.inc(-1)
                    for e in ChainEvent:
                        emitter.off(e, on_event)

            def _cors_headers(self):
                if cors_ref is not None:
                    self.send_header("Access-Control-Allow-Origin", cors_ref)
                    if cors_ref != "*":
                        self.send_header("Vary", "Origin")

            def _send(self, status: int, obj):
                import time as _t

                _observe(
                    urlparse(self.path).path, status,
                    _t.monotonic() - getattr(self, "_t0", _t.monotonic()),
                )
                payload = json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self._cors_headers()
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                import time as _t

                self._t0 = _t.monotonic()
                self._handle("GET")

            def do_POST(self):
                import time as _t

                self._t0 = _t.monotonic()
                self._handle("POST")

            def do_DELETE(self):
                import time as _t

                self._t0 = _t.monotonic()
                self._handle("DELETE")

            def do_OPTIONS(self):
                # CORS preflight: no auth (browsers send it tokenless)
                self.send_response(204)
                self._cors_headers()
                self.send_header(
                    "Access-Control-Allow-Methods", "GET, POST, DELETE, OPTIONS"
                )
                self.send_header(
                    "Access-Control-Allow-Headers", "Content-Type, Authorization"
                )
                self.send_header("Access-Control-Max-Age", "86400")
                self.end_headers()

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()

"""A recording HTTP server on 127.0.0.1 for the port's client tests: each
request's method, path, Authorization header and JSON body is kept, and
`respond(method, path, body)` gives the (status, JSON) reply. Nothing
leaves the machine."""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class LoopbackServer:
    def __init__(self, respond):
        self.requests: list[dict] = []
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _handle(self, method):
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length)) if length else None
                server.requests.append({"method": method, "path": self.path, "body": body,
                                        "auth": self.headers.get("Authorization")})
                status, obj = respond(method, self.path, body)
                raw = json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

            def do_GET(self):
                self._handle("GET")

            def do_POST(self):
                self._handle("POST")

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def take(self) -> list[dict]:
        out, self.requests = self.requests, []
        return out

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._server.shutdown()
        self._server.server_close()
        return False


def jsonrpc(results):
    """A `respond` for JSON-RPC: `results[method](params)` is the result,
    or raises for an error reply."""
    def respond(method, path, body):
        try:
            return 200, {"jsonrpc": "2.0", "id": body["id"],
                         "result": results[body["method"]](body["params"])}
        except Exception as e:  # noqa: BLE001 - the error reply
            return 200, {"jsonrpc": "2.0", "id": body["id"],
                         "error": {"code": -32000, "message": str(e)}}

    return respond

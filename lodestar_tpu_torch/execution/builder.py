"""MEV builder API client and an in-process mock relay.

The port's copy of `lodestar_tpu/execution/builder.py`. Reference:
`beacon-node/src/execution/builder/http.ts` + `api/src/builder` routes —
the builder flow: registerValidator → getHeader (bid with payload
header) → submitBlindedBlock (reveal full payload). The mock relay plays
the role the reference's builder test doubles play.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class BuilderApiError(Exception):
    pass


class BuilderApiClient:
    """Blocking client to a builder-spec relay endpoint."""

    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self.host = host
        self.port = port
        self.timeout = timeout

    def _request(self, method: str, path: str, body=None):
        from ..utils.http import json_http_request

        return json_http_request(
            self.host, self.port, method, path, body,
            timeout=self.timeout, error_cls=BuilderApiError,
        )

    def check_status(self) -> bool:
        try:
            self._request("GET", "/eth/v1/builder/status")
            return True
        except Exception:
            return False

    def register_validators(self, registrations: list[dict]) -> None:
        self._request("POST", "/eth/v1/builder/validators", registrations)

    def get_header(self, slot: int, parent_hash: bytes, pubkey: bytes) -> dict | None:
        """The builder's bid: {header, value, pubkey} or None when it has
        nothing for this slot."""
        try:
            out = self._request(
                "GET",
                f"/eth/v1/builder/header/{slot}/0x{parent_hash.hex()}/0x{pubkey.hex()}",
            )
        except BuilderApiError:
            return None
        return (out or {}).get("data")

    def submit_blinded_block(self, signed_blinded_block: dict) -> dict:
        out = self._request(
            "POST", "/eth/v1/builder/blinded_blocks", signed_blinded_block
        )
        return (out or {}).get("data")


class MockBuilderRelay:
    """In-process relay: bids a header for any parent it has a payload for;
    reveals the payload on blinded-block submission."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.registrations: list[dict] = []
        # parent_hash hex → payload json offered for the next slot
        self.payloads: dict[str, dict] = {}
        relay = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _send(self, status: int, obj) -> None:
                raw = json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

            def do_GET(self):
                if self.path == "/eth/v1/builder/status":
                    return self._send(200, {})
                if self.path.startswith("/eth/v1/builder/header/"):
                    parts = self.path.split("/")
                    parent_hash = parts[-2].removeprefix("0x")
                    payload = relay.payloads.get(parent_hash)
                    if payload is None:
                        return self._send(204, {})
                    return self._send(
                        200,
                        {
                            "data": {
                                "header": payload["header"],
                                "value": payload.get("value", "1"),
                            }
                        },
                    )
                self._send(404, {"message": "not found"})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length)) if length else None
                if self.path == "/eth/v1/builder/validators":
                    relay.registrations.extend(body or [])
                    return self._send(200, {})
                if self.path == "/eth/v1/builder/blinded_blocks":
                    # reveal: match by parent hash in the blinded header
                    parent = (
                        body["message"]["body"]["execution_payload_header"][
                            "parent_hash"
                        ].removeprefix("0x")
                        if body
                        else ""
                    )
                    payload = relay.payloads.get(parent)
                    if payload is None:
                        return self._send(400, {"message": "unknown payload"})
                    return self._send(200, {"data": payload["payload"]})
                self._send(404, {"message": "not found"})

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def offer_payload(self, parent_hash: bytes, header: dict, payload: dict, value: str = "1"):
        self.payloads[parent_hash.hex()] = {
            "header": header,
            "payload": payload,
            "value": value,
        }

    def start(self) -> None:
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()

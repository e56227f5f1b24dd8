"""External (remote) signer client + a minimal in-process signer server
(the port's copy of the JAX package's `validator/external_signer.py`).

Reference: `validator/src/util/externalSignerClient.ts` — the web3signer
HTTP API: `GET /api/v1/eth2/publicKeys`, `POST /api/v1/eth2/sign/{pubkey}`
with a signing-root payload, returning `{"signature": "0x..."}`.
The bundled `ExternalSignerServer` plays the web3signer role for e2e tests
(reference e2e runs a real web3signer container).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..bls import api as bls


class ExternalSignerError(Exception):
    pass


class ExternalSignerClient:
    """Blocking HTTP client to a web3signer-compatible endpoint."""

    def __init__(self, host: str, port: int, timeout: float = 10.0,
                 retries: int = 2):
        self.host = host
        self.port = port
        self.timeout = timeout
        # transport blips to the signer retry through utils/retry (signing
        # is idempotent: same root -> same signature); HTTP error replies
        # (unknown pubkey, slashing-protection refusal) never do
        self.retries = retries

    def _request(self, method: str, path: str, body=None):
        from ..utils.http import json_http_request

        return json_http_request(
            self.host, self.port, method, path, body,
            timeout=self.timeout, error_cls=ExternalSignerError,
            retries=self.retries,
        )

    def list_pubkeys(self) -> list[bytes]:
        keys = self._request("GET", "/api/v1/eth2/publicKeys") or []
        return [bytes.fromhex(k.removeprefix("0x")) for k in keys]

    def sign(self, pubkey: bytes, signing_root: bytes) -> bytes:
        result = self._request(
            "POST",
            f"/api/v1/eth2/sign/0x{pubkey.hex()}",
            {"signingRoot": "0x" + signing_root.hex()},
        )
        return bytes.fromhex(result["signature"].removeprefix("0x"))

    def upcheck(self) -> bool:
        try:
            return self._request("GET", "/upcheck") is not None
        except Exception:
            return False


class ExternalSignerServer:
    """In-process web3signer-compatible server over a set of secret keys."""

    def __init__(self, secret_keys: list[bls.SecretKey], host: str = "127.0.0.1", port: int = 0):
        self._keys = {sk.to_public_key().to_bytes(): sk for sk in secret_keys}
        keys = self._keys

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
                if self.path == "/upcheck":
                    self._send(200, {"status": "OK"})
                elif self.path == "/api/v1/eth2/publicKeys":
                    self._send(200, ["0x" + pk.hex() for pk in keys])
                else:
                    self._send(404, {"message": "not found"})

            def do_POST(self):
                if not self.path.startswith("/api/v1/eth2/sign/"):
                    return self._send(404, {"message": "not found"})
                pk_hex = self.path.rsplit("/", 1)[-1].removeprefix("0x")
                sk = keys.get(bytes.fromhex(pk_hex))
                if sk is None:
                    return self._send(404, {"message": "unknown pubkey"})
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length))
                root = bytes.fromhex(body["signingRoot"].removeprefix("0x"))
                self._send(200, {"signature": "0x" + sk.sign(root).to_bytes().hex()})

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()

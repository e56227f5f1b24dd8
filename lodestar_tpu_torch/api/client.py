"""REST client generated from the route table.

Reference: `api/src/.../client/httpClient.ts` (cross-fetch based typed
client). Methods are generated per route: positional args fill path
params, `query=`/`body=` keywords pass through.

The port's copy of the JAX package's `api/client.py`.
"""

from __future__ import annotations

import http.client
import json
import re
from urllib.parse import urlencode

from .routes import API_ROUTES


class ApiClientError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(f"{status}: {message}")
        self.status = status


class BeaconApiClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 5052, timeout: float = 30.0):
        self.host = host
        self.port = port
        self.timeout = timeout
        for route in API_ROUTES:
            setattr(self, route.operation_id, self._make_method(route))

    def _make_method(self, route):
        path_params = re.findall(r"\{(\w+)\}", route.path)

        def call(*args, query: dict | None = None, body=None):
            if len(args) != len(path_params):
                raise TypeError(
                    f"{route.operation_id} takes {len(path_params)} path args"
                    f" ({path_params}), got {len(args)}"
                )
            path = route.path
            for name, value in zip(path_params, args):
                path = path.replace("{" + name + "}", str(value))
            if query:
                path += "?" + urlencode(query)
            conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout
            )
            try:
                payload = json.dumps(body).encode() if body is not None else None
                headers = {"Content-Type": "application/json"} if payload else {}
                conn.request(route.method, path, body=payload, headers=headers)
                resp = conn.getresponse()
                raw = resp.read()
                obj = json.loads(raw) if raw else {}
                if resp.status >= 400:
                    raise ApiClientError(resp.status, obj.get("message", ""))
                return obj.get("data")
            finally:
                conn.close()

        call.__name__ = route.operation_id
        return call


def stream_events(host: str, port: int, topics=None, timeout: float = 30.0):
    """SSE client generator (reference `eventSource.ts`): yields
    (event_name, payload_dict) until the server closes or `timeout`
    passes without a frame."""
    import http.client as _http
    import json as _json

    path = "/eth/v1/events"
    if topics:
        path += "?topics=" + ",".join(topics)
    conn = _http.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("GET", path, headers={"Accept": "text/event-stream"})
        resp = conn.getresponse()
        if resp.status != 200:
            raise RuntimeError(f"event stream refused: {resp.status}")
        event_name = None
        while True:
            line = resp.fp.readline()
            if not line:
                return
            line = line.decode().rstrip("\n")
            if line.startswith("event: "):
                event_name = line[len("event: "):]
            elif line.startswith("data: ") and event_name is not None:
                yield event_name, _json.loads(line[len("data: "):])
                event_name = None
    finally:
        conn.close()

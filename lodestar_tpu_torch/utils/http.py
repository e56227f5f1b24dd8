"""Blocking JSON-over-HTTP requests on the standard library (the port's
copy of `lodestar_tpu/utils/http.py`): one transport helper for the
REST-ish clients (the builder relay's), so timeout and error-shape fixes
land in one place.
"""

from __future__ import annotations

import http.client
import json


def json_http_request(
    host: str,
    port: int,
    method: str,
    path: str,
    body=None,
    timeout: float = 10.0,
    error_cls: type[Exception] = RuntimeError,
    retries: int = 0,
    retry_policy=None,
):
    """Issue one request, decode the JSON reply, raise `error_cls` on >=400.

    `retries` > 0 (or an explicit `retry_policy`) re-issues the request
    through `utils.retry` on TRANSPORT failures only (socket/protocol
    errors) — never on an HTTP error status: the server answered, and
    re-sending a non-idempotent request it already processed is the
    caller's decision, not the transport helper's."""

    def _once():
        conn = http.client.HTTPConnection(host, port, timeout=timeout)
        try:
            payload = json.dumps(body).encode() if body is not None else None
            headers = {"Content-Type": "application/json"} if payload else {}
            conn.request(method, path, body=payload, headers=headers)
            resp = conn.getresponse()
            raw = resp.read()
            if resp.status >= 400:
                raise error_cls(f"{resp.status}: {raw[:200]!r}")
            return json.loads(raw) if raw else None
        finally:
            conn.close()

    if retries <= 0 and retry_policy is None:
        return _once()
    from .retry import RetryPolicy, retry_call, transient_http

    policy = retry_policy or RetryPolicy(
        max_attempts=1 + retries, base_delay_s=0.2, retryable=transient_http
    )
    return retry_call(_once, policy=policy)

"""/metrics HTTP endpoint plus the profiler and debug control surface (the
JAX package's `metrics/server.py`), a `ThreadingHTTPServer` over the
registry the caller passes:

    GET /metrics          Prometheus text exposition
    POST /profiler/start  start a torch.profiler trace (?dir=<path>)
    POST /profiler/stop   stop it; returns the trace directory
    GET /debug/breaker    the supervisor's breaker state and failure-policy
                          counters (chain/supervisor.py)
    GET /debug/mesh       the serving mesh's census (parallel/mesh.py);
                          unmeshed nodes report wired: false
    GET /debug/fleet      the two-level fleet's census and subnet router
                          (parallel/fleet.py); single-host nodes report
                          wired: false
    GET /debug/lanes      the lane dispatcher's per-lane depth, caps, sheds,
                          coalesced batches and overlap fraction
                          (chain/dispatcher.py)
    GET /debug/slo        every objective's burn-rate windows, budget and
                          ok/burning verdict (observability/slo.py)
    GET /debug/device     device-seconds by lane × kernel × chip and the
                          sampled memory watermarks
                          (observability/device_ledger.py)
    GET /debug/epoch_table  the epoch pubkey table's census
                          (parallel/epoch_table.py)
    GET /debug/compiles   the compile ledger (library builds, first calls),
                          the startup timeline and the flight recorder
                          (?limit=K recent events)
    GET /debug/faults     the injected fault plan's snapshot; ?set=<spec>
                          arms it, ?clear=1 disarms it (404 when the stack
                          has no faults object)
    GET /debug/traces     lifecycle traces of the injected tracer (404
                          while none is injected: the port has no span
                          layer yet)

GET is also accepted on the profiler routes. The profiler hooks default
to `observability.trace`, the process-wide switch the facade uses.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class MetricsServer:
    def __init__(
        self,
        registry,
        host: str = "127.0.0.1",
        port: int = 0,
        profiler_start=None,
        profiler_stop=None,
        tracer=None,
        breaker=None,
        mesh=None,
        fleet=None,
        lanes=None,
        slo=None,
        device=None,
        epoch_table=None,
        faults=None,
    ):
        reg = registry
        if profiler_start is None or profiler_stop is None:
            from ..observability import trace

            profiler_start = profiler_start or trace.start_profiling
            profiler_stop = profiler_stop or trace.stop_profiling

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _send_json(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _handle(self):
                parsed = urllib.parse.urlsplit(self.path)
                route = parsed.path.rstrip("/")
                if route == "/profiler/start":
                    q = urllib.parse.parse_qs(parsed.query)
                    trace_dir = (q.get("dir") or [None])[0]
                    started = profiler_start(trace_dir)
                    if started is None:
                        self._send_json(
                            409,
                            {"status": "error",
                             "reason": "trace already running or profiler unavailable"},
                        )
                    else:
                        self._send_json(200, {"status": "started", "dir": started})
                    return
                if route == "/profiler/stop":
                    stopped = profiler_stop()
                    if stopped is None:
                        self._send_json(
                            409, {"status": "error", "reason": "no trace running"}
                        )
                    else:
                        self._send_json(200, {"status": "stopped", "dir": stopped})
                    return
                if route == "/debug/traces" and tracer is not None:
                    q = urllib.parse.parse_qs(parsed.query)

                    def _one(key):
                        return (q.get(key) or [None])[0]

                    slot = _one("slot")
                    try:
                        slot = int(slot) if slot is not None else None
                        limit = min(int(_one("limit") or 64), 256)
                    except ValueError:
                        self._send_json(400, {"error": "bad slot/limit"})
                        return
                    docs = tracer.traces(
                        slot=slot, root=_one("root"), limit=limit
                    )
                    self._send_json(
                        200,
                        {
                            "count": len(docs),
                            "completed_total": tracer.completed_total,
                            "enabled": tracer.enabled,
                            "traces": docs,
                        },
                    )
                    return
                if route == "/debug/breaker":
                    # breaker = zero-arg callable returning the
                    # supervisor's breaker_snapshot(); unwired nodes
                    # (host tier only) report wired: false
                    if breaker is None:
                        self._send_json(200, {"wired": False})
                        return
                    try:
                        doc = {"wired": True, **breaker()}
                    except Exception as e:
                        self._send_json(500, {"error": str(e)})
                        return
                    self._send_json(200, doc)
                    return
                if route == "/debug/mesh":
                    # mesh = zero-arg callable returning the verifier's
                    # mesh_snapshot(); single-device or CPU-only nodes
                    # report wired: false (no mesh, kernels unsharded)
                    snap = None
                    if mesh is not None:
                        try:
                            snap = mesh()
                        except Exception as e:
                            self._send_json(500, {"error": str(e)})
                            return
                    if snap is None:
                        self._send_json(200, {"wired": False})
                        return
                    self._send_json(200, {"wired": True, **snap})
                    return
                if route == "/debug/fleet":
                    # fleet = zero-arg callable returning the dispatcher's
                    # fleet_snapshot(); single-host or unmeshed nodes
                    # report wired: false (no DCN axis, no subnet router)
                    snap = None
                    if fleet is not None:
                        try:
                            snap = fleet()
                        except Exception as e:
                            self._send_json(500, {"error": str(e)})
                            return
                    if snap is None:
                        self._send_json(200, {"wired": False})
                        return
                    self._send_json(200, {"wired": True, **snap})
                    return
                if route == "/debug/lanes":
                    # lanes = zero-arg callable returning the pipeline's
                    # lanes_snapshot(); None (no lane dispatcher bound)
                    # reports wired: false
                    snap = None
                    if lanes is not None:
                        try:
                            snap = lanes()
                        except Exception as e:
                            self._send_json(500, {"error": str(e)})
                            return
                    if snap is None:
                        self._send_json(200, {"wired": False})
                        return
                    self._send_json(200, {"wired": True, **snap})
                    return
                if route == "/debug/slo":
                    # slo = zero-arg callable returning the engine's
                    # snapshot(), None while no engine is installed
                    # (defaults to the process-wide singleton)
                    snap = None
                    provider = slo
                    if provider is None:
                        from ..observability import slo as slo_mod

                        provider = slo_mod.snapshot_or_none
                    try:
                        snap = provider()
                    except Exception as e:
                        self._send_json(500, {"error": str(e)})
                        return
                    if snap is None:
                        self._send_json(200, {"wired": False})
                        return
                    self._send_json(200, {"wired": True, **snap})
                    return
                if route == "/debug/device":
                    # device = zero-arg callable returning the device
                    # ledger's snapshot() (defaults to the process-wide
                    # singleton — always wired, attribution may be empty)
                    provider = device
                    if provider is None:
                        from ..observability import device_ledger

                        provider = device_ledger.ledger().snapshot
                    try:
                        snap = provider()
                    except Exception as e:
                        self._send_json(500, {"error": str(e)})
                        return
                    if snap is None:
                        self._send_json(200, {"wired": False})
                        return
                    self._send_json(200, {"wired": True, **snap})
                    return
                if route == "/debug/epoch_table":
                    # epoch_table = zero-arg callable returning the
                    # verifier's epoch_table_snapshot(); unwired nodes
                    # (host tier only) report wired: false
                    snap = None
                    if epoch_table is not None:
                        try:
                            snap = epoch_table()
                        except Exception as e:
                            self._send_json(500, {"error": str(e)})
                            return
                    if snap is None or not snap.get("enabled", True):
                        self._send_json(200, {"wired": False})
                        return
                    self._send_json(200, {"wired": True, **snap})
                    return
                if route == "/debug/faults" and faults is not None:
                    q = urllib.parse.parse_qs(parsed.query)
                    try:
                        if "set" in q:
                            doc = faults.configure(q["set"][0])
                        elif "clear" in q:
                            # ?clear=1&reset_counters=1 also zeroes the
                            # injection counters; a bare clear keeps them
                            reset = q.get("reset_counters", ["0"])[0]
                            faults.clear(
                                reset_counters=reset.lower()
                                not in ("", "0", "false")
                            )
                            doc = faults.snapshot()
                        else:
                            doc = faults.snapshot()
                    except ValueError as e:
                        self._send_json(400, {"error": str(e)})
                        return
                    self._send_json(200, doc)
                    return
                if route == "/debug/compiles":
                    from ..observability import compile_ledger, flight_recorder

                    q = urllib.parse.parse_qs(parsed.query)
                    try:
                        limit = min(int((q.get("limit") or [64])[0]), 256)
                    except ValueError:
                        self._send_json(400, {"error": "bad limit"})
                        return
                    led_snap = compile_ledger.ledger().snapshot()
                    self._send_json(
                        200,
                        {
                            "ledger": led_snap,
                            "aot": led_snap.get("aot"),
                            "startup": compile_ledger.timeline().snapshot(),
                            "flight_recorder":
                                flight_recorder.recorder().dump(limit=limit),
                        },
                    )
                    return
                if route not in ("", "/metrics"):
                    self.send_response(404)
                    self.end_headers()
                    return
                payload = reg.expose().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
                )
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                self._handle()

            def do_POST(self):
                self._handle()

        self._server = ThreadingHTTPServer((host, port), Handler)

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> None:
        threading.Thread(target=self._server.serve_forever, daemon=True).start()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()

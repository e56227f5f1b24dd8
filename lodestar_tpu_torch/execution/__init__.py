"""Execution-layer client (the port's copy of `lodestar_tpu/execution`).

Reference: `execution/engine/` — `IExecutionEngine` (interface.ts),
JSON-RPC HTTP client with JWT auth (http.ts: engine_newPayloadV1/V2,
engine_forkchoiceUpdatedV1/V2, engine_getPayloadV1/V2), the in-memory
mock EL (mock.ts:31) used by tests and dev chains, and the builder
relay client (`builder.py`). HTTP goes through the standard library only.
"""

from .engine import (  # noqa: F401
    ExecutePayloadStatus,
    ExecutionEngineHttp,
    ExecutionEngineMock,
    IExecutionEngine,
    PayloadAttributes,
)

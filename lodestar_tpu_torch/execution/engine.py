"""Engine API: interface, in-memory mock EL, JSON-RPC client.

The port's copy of `lodestar_tpu/execution/engine.py`. Reference:
`execution/engine/interface.ts` (IExecutionEngine), `engine/mock.ts:31`
(ExecutionEngineMock — a fake EL keeping a payload tree and building
sessions), `engine/http.ts` (JSON-RPC with jwt-simple HS256 auth). The
engine's host, port and JWT secret are constructor arguments.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Protocol

from ..ssz.hashing import sha256


class ExecutePayloadStatus(str, Enum):
    VALID = "VALID"
    INVALID = "INVALID"
    SYNCING = "SYNCING"
    ACCEPTED = "ACCEPTED"
    INVALID_BLOCK_HASH = "INVALID_BLOCK_HASH"
    ELERROR = "ELERROR"
    UNAVAILABLE = "UNAVAILABLE"


@dataclass
class PayloadAttributes:
    timestamp: int
    prev_randao: bytes
    suggested_fee_recipient: bytes
    # capella (engine API v2): expected withdrawals for the built payload
    withdrawals: list = field(default_factory=list)


class IExecutionEngine(Protocol):
    def notify_new_payload(self, payload) -> ExecutePayloadStatus: ...

    def notify_forkchoice_update(
        self,
        head_block_hash: bytes,
        safe_block_hash: bytes,
        finalized_block_hash: bytes,
        attributes: PayloadAttributes | None = None,
    ) -> str | None: ...

    def get_payload(self, payload_id: str, fork: str = "bellatrix"): ...


@dataclass
class _MockPayload:
    block_hash: bytes
    parent_hash: bytes
    block_number: int
    timestamp: int
    prev_randao: bytes
    fee_recipient: bytes
    transactions: list = field(default_factory=list)
    withdrawals: list = field(default_factory=list)


class ExecutionEngineMock:
    """In-memory EL: payload tree + building sessions (reference mock.ts).

    Used by the dev chain and sim tests exactly like the reference uses
    ExecutionEngineMock — valid unless told otherwise."""

    def __init__(self, genesis_block_hash: bytes = b"\x00" * 32):
        self.head: bytes = genesis_block_hash
        self.finalized: bytes = genesis_block_hash
        self.payloads: dict[bytes, _MockPayload] = {
            genesis_block_hash: _MockPayload(
                block_hash=genesis_block_hash,
                parent_hash=b"\x00" * 32,
                block_number=0,
                timestamp=0,
                prev_randao=b"\x00" * 32,
                fee_recipient=b"\x00" * 20,
            )
        }
        self._building: dict[str, _MockPayload] = {}
        self._payload_id = 0
        # test hook: mark hashes invalid (reference mock supports error
        # injection for invalid-payload paths)
        self.invalid_hashes: set[bytes] = set()

    def notify_new_payload(self, payload) -> ExecutePayloadStatus:
        if payload.block_hash in self.invalid_hashes:
            return ExecutePayloadStatus.INVALID
        if payload.parent_hash not in self.payloads:
            return ExecutePayloadStatus.SYNCING
        parent = self.payloads[payload.parent_hash]
        if payload.block_number != parent.block_number + 1:
            return ExecutePayloadStatus.INVALID
        self.payloads[payload.block_hash] = payload
        return ExecutePayloadStatus.VALID

    def notify_forkchoice_update(
        self,
        head_block_hash: bytes,
        safe_block_hash: bytes,
        finalized_block_hash: bytes,
        attributes: PayloadAttributes | None = None,
    ) -> str | None:
        if head_block_hash not in self.payloads:
            return None
        self.head = head_block_hash
        self.finalized = finalized_block_hash
        if attributes is None:
            return None
        parent = self.payloads[head_block_hash]
        self._payload_id += 1
        payload_id = f"0x{self._payload_id:016x}"
        block_hash = sha256(
            head_block_hash + attributes.timestamp.to_bytes(8, "little")
        )
        self._building[payload_id] = _MockPayload(
            block_hash=block_hash,
            parent_hash=head_block_hash,
            block_number=parent.block_number + 1,
            timestamp=attributes.timestamp,
            prev_randao=attributes.prev_randao,
            fee_recipient=attributes.suggested_fee_recipient,
            withdrawals=list(attributes.withdrawals),
        )
        return payload_id

    def get_payload(self, payload_id: str, fork: str = "bellatrix") -> _MockPayload:
        payload = self._building.pop(payload_id, None)
        if payload is None:
            raise ValueError(f"unknown payload id {payload_id}")
        return payload


def payload_to_engine_json(payload) -> dict:
    """SSZ ExecutionPayload container → engine-API JSON (camelCase, 0x-hex,
    hex-quantity numbers) — reference serializeExecutionPayload."""
    out = {
        "parentHash": "0x" + bytes(payload.parent_hash).hex(),
        "feeRecipient": "0x" + bytes(payload.fee_recipient).hex(),
        "stateRoot": "0x" + bytes(payload.state_root).hex(),
        "receiptsRoot": "0x" + bytes(payload.receipts_root).hex(),
        "logsBloom": "0x" + bytes(payload.logs_bloom).hex(),
        "prevRandao": "0x" + bytes(payload.prev_randao).hex(),
        "blockNumber": hex(payload.block_number),
        "gasLimit": hex(payload.gas_limit),
        "gasUsed": hex(payload.gas_used),
        "timestamp": hex(payload.timestamp),
        "extraData": "0x" + bytes(payload.extra_data).hex(),
        "baseFeePerGas": hex(payload.base_fee_per_gas),
        "blockHash": "0x" + bytes(payload.block_hash).hex(),
        "transactions": ["0x" + bytes(tx).hex() for tx in payload.transactions],
    }
    if hasattr(payload, "withdrawals"):
        out["withdrawals"] = [
            {
                "index": hex(w.index),
                "validatorIndex": hex(w.validator_index),
                "address": "0x" + bytes(w.address).hex(),
                "amount": hex(w.amount),
            }
            for w in payload.withdrawals
        ]
    return out


_ENGINE_KEY_MAP = {
    "parent_hash": "parentHash",
    "fee_recipient": "feeRecipient",
    "state_root": "stateRoot",
    "receipts_root": "receiptsRoot",
    "logs_bloom": "logsBloom",
    "prev_randao": "prevRandao",
    "block_number": "blockNumber",
    "gas_limit": "gasLimit",
    "gas_used": "gasUsed",
    "timestamp": "timestamp",
    "extra_data": "extraData",
    "base_fee_per_gas": "baseFeePerGas",
    "block_hash": "blockHash",
    "transactions": "transactions",
    "withdrawals": "withdrawals",
}


def engine_json_field(built, snake_name: str, default=None):
    """Field from an engine get_payload result: mock payload objects use
    snake_case attributes, engine JSON uses camelCase keys."""
    if isinstance(built, dict):
        camel = _ENGINE_KEY_MAP.get(snake_name, snake_name)
        if camel in built:
            return built[camel]
        return built.get(snake_name, default)
    return getattr(built, snake_name, default)


def _jwt_hs256(secret: bytes) -> str:
    """Engine-API JWT: HS256, iat claim (reference uses jwt-simple)."""
    b64 = lambda b: base64.urlsafe_b64encode(b).rstrip(b"=")
    header = b64(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    claims = b64(json.dumps({"iat": int(time.time())}).encode())
    signing_input = header + b"." + claims
    sig = b64(hmac.new(secret, signing_input, hashlib.sha256).digest())
    return (signing_input + b"." + sig).decode()


class ExecutionEngineHttp:
    """JSON-RPC engine client (engine_newPayloadV1 / forkchoiceUpdatedV1 /
    getPayloadV1) with fresh JWT per request (reference http.ts)."""

    def __init__(
        self, host: str, port: int, jwt_secret: bytes, timeout: float = 8.0,
        metrics=None, retries: int = 2,
    ):
        from ..utils.retry import RetryPolicy, transient_http

        self.host = host
        self.port = port
        self.jwt_secret = jwt_secret
        self.timeout = timeout
        self.metrics = metrics
        self._id = 0
        # transport-level retry (shared utils/retry helper): a dropped
        # connection to the EL must not surface as SYNCING/ELERROR on a
        # proposal path. JSON-RPC error REPLIES are never retried — the
        # EL answered; engine semantics decide what an error means.
        self._retry_policy = RetryPolicy(
            max_attempts=1 + max(0, retries),
            base_delay_s=0.25,
            max_delay_s=2.0,
            retryable=transient_http,
        )

    def _call(self, method: str, params: list):
        import http.client
        import time as _time

        from ..utils.retry import retry_call

        t0 = _time.monotonic()
        self._id += 1
        body = json.dumps(
            {"jsonrpc": "2.0", "id": self._id, "method": method, "params": params}
        ).encode()

        def _transport():
            conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout
            )
            try:
                conn.request(
                    "POST",
                    "/",
                    body=body,
                    headers={
                        "Content-Type": "application/json",
                        "Authorization": f"Bearer {_jwt_hs256(self.jwt_secret)}",
                    },
                )
                return json.loads(conn.getresponse().read())
            finally:
                conn.close()

        resp = retry_call(_transport, policy=self._retry_policy)
        if self.metrics is not None:
            self.metrics.engine_request_seconds.observe(
                _time.monotonic() - t0, method=method
            )
            self.metrics.engine_requests_total.inc(
                method=method,
                outcome="error" if "error" in resp else "ok",
            )
        if "error" in resp:
            raise RuntimeError(f"{method}: {resp['error']}")
        return resp["result"]

    def notify_new_payload(self, payload) -> ExecutePayloadStatus:
        """Accepts an SSZ ExecutionPayload container or a pre-built engine
        JSON dict. The engine's latestValidHash (when present and nonzero)
        is kept on `last_latest_valid_hash` for the caller's
        optimistic-sync invalidation — the return shape stays a bare
        status so every IExecutionEngine implementation agrees."""
        payload_json = (
            payload if isinstance(payload, dict) else payload_to_engine_json(payload)
        )
        version = "V2" if "withdrawals" in payload_json else "V1"
        result = self._call(f"engine_newPayload{version}", [payload_json])
        if self.metrics is not None:
            self.metrics.engine_payload_status_total.inc(
                status=str(result.get("status"))
            )
        lvh_hex = result.get("latestValidHash")
        lvh = (
            bytes.fromhex(lvh_hex.removeprefix("0x"))
            if isinstance(lvh_hex, str)
            else None
        )
        # the zero hash means "no valid ancestor known" (engine API): no LVH
        self.last_latest_valid_hash = (
            lvh if lvh and lvh != b"\x00" * 32 else None
        )
        return ExecutePayloadStatus(result["status"])

    def notify_forkchoice_update(
        self, head: bytes, safe: bytes, finalized: bytes, attributes=None
    ):
        fc_state = {
            "headBlockHash": "0x" + head.hex(),
            "safeBlockHash": "0x" + safe.hex(),
            "finalizedBlockHash": "0x" + finalized.hex(),
        }
        attrs = None
        version = "V1"
        if attributes is not None:
            attrs = {
                "timestamp": hex(attributes.timestamp),
                "prevRandao": "0x" + attributes.prev_randao.hex(),
                "suggestedFeeRecipient": "0x" + attributes.suggested_fee_recipient.hex(),
            }
            if attributes.withdrawals:
                # capella: engine API V2 carries the expected withdrawals
                version = "V2"
                attrs["withdrawals"] = [
                    {
                        "index": hex(w.index),
                        "validatorIndex": hex(w.validator_index),
                        "address": "0x" + bytes(w.address).hex(),
                        "amount": hex(w.amount),
                    }
                    for w in attributes.withdrawals
                ]
        result = self._call(f"engine_forkchoiceUpdated{version}", [fc_state, attrs])
        payload_id = result.get("payloadId")
        return payload_id

    def get_payload(self, payload_id: str, fork: str = "bellatrix") -> dict:
        """engine_getPayloadV1 pre-capella; V2 (which wraps the payload as
        {executionPayload, blockValue} and carries withdrawals) after."""
        if fork in ("phase0", "altair", "bellatrix"):
            return self._call("engine_getPayloadV1", [payload_id])
        result = self._call("engine_getPayloadV2", [payload_id])
        if isinstance(result, dict) and "executionPayload" in result:
            return result["executionPayload"]
        return result

    def exchange_transition_configuration(self, ttd: int, terminal_block_hash: bytes) -> bool:
        """engine_exchangeTransitionConfigurationV1 (`engine/http.ts:308`):
        CL and EL cross-check their merge configuration; mismatch means a
        mis-configured pair that would fork at the transition."""
        result = self._call(
            "engine_exchangeTransitionConfigurationV1",
            [
                {
                    "terminalTotalDifficulty": hex(ttd),
                    "terminalBlockHash": "0x" + terminal_block_hash.hex(),
                    "terminalBlockNumber": "0x0",
                }
            ],
        )
        if not isinstance(result, dict):
            return False
        got_ttd = int(str(result.get("terminalTotalDifficulty", "0x0")), 16)
        got_hash = str(result.get("terminalBlockHash", "0x")).removeprefix("0x")
        return got_ttd == ttd and bytes.fromhex(got_hash or "00" * 32) == terminal_block_hash

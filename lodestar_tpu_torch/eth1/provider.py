"""Live eth1 JSON-RPC provider: the deposit-contract follower.

The port's copy of `lodestar_tpu/eth1/provider.py`. Reference:
`eth1/provider/eth1Provider.ts` — batched `eth_getLogs` over bounded
block ranges with range-halving on truncated responses and retries,
`eth_getBlockByNumber`, head tracking behind ETH1_FOLLOW_DISTANCE.
Deposit logs are decoded from the deposit contract's
`DepositEvent(bytes,bytes,bytes,bytes,bytes)` ABI encoding (reference
`eth1/utils/depositContract.ts:parseDepositLog`). It serves the same
`IEth1Provider` seam as `Eth1ProviderMock`, over `http.client`.
"""

from __future__ import annotations

import json
import time

from .deposit_tracker import DepositLog, Eth1Block

# keccak256("DepositEvent(bytes,bytes,bytes,bytes,bytes)") — the single
# topic the deposit contract emits (depositContract.ts:13)
DEPOSIT_EVENT_TOPIC = (
    "0x649bbc62d0e31342afea4e5cd82d4049e7e1ee912fc0889aa790803be39038c5"
)
# deposit contract view selectors (IDepositContract)
_SEL_GET_DEPOSIT_ROOT = "0xc5f2892f"   # get_deposit_root()
_SEL_GET_DEPOSIT_COUNT = "0x621fd130"  # get_deposit_count()


def _q(n: int) -> str:
    """int → JSON-RPC QUANTITY."""
    return hex(n)


def _num(q: str) -> int:
    return int(q, 16)


def _abi_bytes_fields(data: bytes, n_fields: int) -> list[bytes]:
    """Decode n dynamic `bytes` fields from ABI-encoded log data
    (head: n offsets; tail: 32B length + padded payload each)."""
    out = []
    for i in range(n_fields):
        off = int.from_bytes(data[i * 32 : i * 32 + 32], "big")
        length = int.from_bytes(data[off : off + 32], "big")
        out.append(data[off + 32 : off + 32 + length])
    return out


def parse_deposit_log(types, log: dict) -> DepositLog:
    """One eth_getLogs entry → DepositLog (depositContract.ts semantics:
    amount and index are little-endian byte arrays)."""
    data = bytes.fromhex(log["data"].removeprefix("0x"))
    pubkey, wc, amount, signature, index = _abi_bytes_fields(data, 5)
    dd = types.DepositData(
        pubkey=pubkey,
        withdrawal_credentials=wc,
        amount=int.from_bytes(amount, "little"),
        signature=signature,
    )
    return DepositLog(
        index=int.from_bytes(index, "little"),
        deposit_data=dd,
        block_number=_num(log["blockNumber"]),
    )


class Eth1ProviderHttp:
    """IEth1Provider over plain JSON-RPC (no external deps).

    `latest_block_number` already applies ETH1_FOLLOW_DISTANCE so the
    tracker only ever sees the stable window (the reference applies the
    distance in the data tracker; keeping it here keeps the mock and the
    live provider interchangeable behind the same seam).
    """

    def __init__(
        self,
        config,
        types,
        host: str,
        port: int,
        *,
        deploy_block: int = 0,
        logs_batch_size: int = 1000,
        retries: int = 3,
        retry_delay: float = 0.5,
        timeout: float = 12.0,
        follow_distance: int | None = None,
        metrics=None,
    ):
        self.metrics = metrics
        self.config = config
        self.types = types
        self.host = host
        self.port = port
        self.deploy_block = deploy_block
        self.logs_batch_size = logs_batch_size
        self.retries = retries
        self.retry_delay = retry_delay
        self.timeout = timeout
        self.follow_distance = (
            follow_distance
            if follow_distance is not None
            else config.ETH1_FOLLOW_DISTANCE
        )
        self.contract = "0x" + config.DEPOSIT_CONTRACT_ADDRESS.hex()
        self._id = 0

    # -- transport ----------------------------------------------------------

    def _call_once(self, method: str, params: list):
        import http.client

        self._id += 1
        body = json.dumps(
            {"jsonrpc": "2.0", "id": self._id, "method": method, "params": params}
        ).encode()
        conn = http.client.HTTPConnection(self.host, self.port, timeout=self.timeout)
        try:
            conn.request(
                "POST", "/", body=body,
                headers={"Content-Type": "application/json"},
            )
            resp = json.loads(conn.getresponse().read())
        finally:
            conn.close()
        if "error" in resp:
            raise RuntimeError(f"{method}: {resp['error']}")
        return resp["result"]

    def _call(self, method: str, params: list):
        """JSON-RPC call through the shared retry helper (`utils/retry`):
        jittered exponential backoff replaces the round-1 ad-hoc loop
        whose synchronized sleeps stampeded a recovering endpoint."""
        from ..utils.retry import RetryPolicy, retry_call

        def _once():
            t0 = time.monotonic()
            out = self._call_once(method, params)
            if self.metrics is not None:
                self.metrics.eth1_request_seconds.observe(
                    time.monotonic() - t0, method=method
                )
            return out

        def _on_error(exc, attempt, will_retry):
            if self.metrics is not None:
                self.metrics.eth1_request_errors_total.inc()

        policy = RetryPolicy(
            max_attempts=self.retries,
            base_delay_s=self.retry_delay,
            retryable=lambda e: isinstance(e, (OSError, RuntimeError, ValueError)),
        )
        try:
            return retry_call(_once, policy=policy, on_error=_on_error)
        except (OSError, RuntimeError, ValueError) as e:
            raise RuntimeError(f"eth1 rpc {method} failed after retries: {e}")

    # -- IEth1Provider -------------------------------------------------------

    def latest_block_number(self) -> int:
        head = _num(self._call("eth_blockNumber", []))
        if self.metrics is not None:
            self.metrics.eth1_follow_distance.set(self.follow_distance)
            self.metrics.eth1_synced_block.set(max(self.deploy_block, head - self.follow_distance))
        return max(self.deploy_block, head - self.follow_distance)

    def get_deposit_logs(self, from_block: int, to_block: int) -> list[DepositLog]:
        """Chunked eth_getLogs; a failing/truncated chunk is halved and
        retried (eth1Provider.ts getDepositEvents + truncation fallback)."""
        out: list[DepositLog] = []
        frm = max(from_block, self.deploy_block)
        chunk = self.logs_batch_size
        while frm <= to_block:
            to = min(frm + chunk - 1, to_block)
            try:
                logs = self._call(
                    "eth_getLogs",
                    [
                        {
                            "fromBlock": _q(frm),
                            "toBlock": _q(to),
                            "address": self.contract,
                            "topics": [DEPOSIT_EVENT_TOPIC],
                        }
                    ],
                )
            except RuntimeError:
                if chunk == 1:
                    raise
                chunk = max(1, chunk // 2)  # halve and retry the range
                continue
            if self.metrics is not None:
                self.metrics.eth1_logs_batch_size.observe(len(logs))
                self.metrics.eth1_deposits_total.inc(len(logs))
            out.extend(parse_deposit_log(self.types, lg) for lg in logs)
            frm = to + 1
        out.sort(key=lambda l: l.index)
        return out

    def get_block_by_number(self, number: int) -> Eth1Block | None:
        raw = self._call("eth_getBlockByNumber", [_q(number), False])
        if raw is None:
            return None
        root = self._call(
            "eth_call",
            [{"to": self.contract, "data": _SEL_GET_DEPOSIT_ROOT}, _q(number)],
        )
        count_raw = self._call(
            "eth_call",
            [{"to": self.contract, "data": _SEL_GET_DEPOSIT_COUNT}, _q(number)],
        )
        # get_deposit_count returns ABI-encoded dynamic bytes8 (LE count)
        count_bytes = bytes.fromhex(count_raw.removeprefix("0x"))
        if len(count_bytes) > 8:
            count_bytes = _abi_bytes_fields(count_bytes, 1)[0]
        count = int.from_bytes(count_bytes[:8], "little")
        return Eth1Block(
            block_number=_num(raw["number"]),
            block_hash=bytes.fromhex(raw["hash"].removeprefix("0x")),
            timestamp=_num(raw["timestamp"]),
            deposit_root=bytes.fromhex(root.removeprefix("0x"))[:32],
            deposit_count=count,
        )

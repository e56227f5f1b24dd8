"""Req/Resp protocol registry.

Reference: `network/reqresp/types.ts:7-67` — Status, Goodbye, Ping,
Metadata, BeaconBlocksByRange/Root (V1+V2), LightClient*. Protocol ids:
/eth2/beacon_chain/req/<name>/<version>/ssz_snappy.

(The port's copy of the JAX package's `network/reqresp/protocols.py`.)
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum


class Protocol(str, Enum):
    Status = "status"
    Goodbye = "goodbye"
    Ping = "ping"
    Metadata = "metadata"
    BeaconBlocksByRange = "beacon_blocks_by_range"
    BeaconBlocksByRoot = "beacon_blocks_by_root"
    LightClientBootstrap = "light_client_bootstrap"
    LightClientUpdatesByRange = "light_client_updates_by_range"
    LightClientFinalityUpdate = "light_client_finality_update"
    LightClientOptimisticUpdate = "light_client_optimistic_update"


@dataclass(frozen=True)
class ProtocolSpec:
    protocol: Protocol
    version: int
    has_request: bool
    multiple_responses: bool


PROTOCOLS: list[ProtocolSpec] = [
    ProtocolSpec(Protocol.Status, 1, True, False),
    ProtocolSpec(Protocol.Goodbye, 1, True, False),
    ProtocolSpec(Protocol.Ping, 1, True, False),
    ProtocolSpec(Protocol.Metadata, 2, False, False),
    ProtocolSpec(Protocol.BeaconBlocksByRange, 2, True, True),
    ProtocolSpec(Protocol.BeaconBlocksByRoot, 2, True, True),
    ProtocolSpec(Protocol.LightClientBootstrap, 1, True, False),
    ProtocolSpec(Protocol.LightClientUpdatesByRange, 1, True, True),
    ProtocolSpec(Protocol.LightClientFinalityUpdate, 1, False, False),
    ProtocolSpec(Protocol.LightClientOptimisticUpdate, 1, False, False),
]


def protocol_id(protocol: Protocol, version: int = 1) -> str:
    return f"/eth2/beacon_chain/req/{protocol.value}/{version}/ssz_snappy"


def parse_protocol_id(pid: str) -> tuple[Protocol, int]:
    parts = pid.split("/")
    if (
        len(parts) != 7
        or parts[1] != "eth2"
        or parts[2] != "beacon_chain"
        or parts[3] != "req"
        or parts[6] != "ssz_snappy"
    ):
        raise ValueError(f"malformed protocol id: {pid}")
    return Protocol(parts[4]), int(parts[5])

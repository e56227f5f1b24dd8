"""Gossip topic naming: `/eth2/<forkDigest>/<name>/ssz_snappy`.

Reference: `network/gossip/topic.ts` + `interface.ts:14-27` (the 10 gossip
types). Subnet topics carry their index in the name.

(The port's copy of the JAX package's `network/gossip/topic.py`.)
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum


class GossipType(str, Enum):
    beacon_block = "beacon_block"
    beacon_aggregate_and_proof = "beacon_aggregate_and_proof"
    beacon_attestation = "beacon_attestation"
    voluntary_exit = "voluntary_exit"
    proposer_slashing = "proposer_slashing"
    attester_slashing = "attester_slashing"
    sync_committee_contribution_and_proof = "sync_committee_contribution_and_proof"
    sync_committee = "sync_committee"
    light_client_finality_update = "light_client_finality_update"
    light_client_optimistic_update = "light_client_optimistic_update"


SUBNET_TYPES = {GossipType.beacon_attestation, GossipType.sync_committee}


@dataclass(frozen=True)
class GossipTopic:
    type: GossipType
    fork_digest: bytes
    subnet: int | None = None


def stringify_topic(topic: GossipTopic) -> str:
    name = topic.type.value
    if topic.type in SUBNET_TYPES:
        if topic.subnet is None:
            raise ValueError(f"{name} topic requires a subnet index")
        name = f"{name}_{topic.subnet}"
    return f"/eth2/{topic.fork_digest.hex()}/{name}/ssz_snappy"


def parse_topic(s: str) -> GossipTopic:
    parts = s.split("/")
    if len(parts) != 5 or parts[1] != "eth2" or parts[4] != "ssz_snappy":
        raise ValueError(f"malformed gossip topic: {s}")
    fork_digest = bytes.fromhex(parts[2])
    name = parts[3]
    # exact names FIRST: "sync_committee_contribution_and_proof" starts
    # with the "sync_committee_" subnet prefix and must not be parsed as
    # a subnet topic
    try:
        return GossipTopic(GossipType(name), fork_digest, None)
    except ValueError:
        pass
    for t in SUBNET_TYPES:
        prefix = t.value + "_"
        if name.startswith(prefix):
            return GossipTopic(t, fork_digest, int(name[len(prefix):]))
    raise ValueError(f"unknown gossip topic name: {name}")

"""Subnet subscription services.

Reference: `network/subnets/attnetsService.ts` / `syncnetsService.ts` —
long-lived random subnet subscriptions (rotated every
EPOCHS_PER_RANDOM_SUBNET_SUBSCRIPTION epochs, seeded per node) plus
short-lived committee-duty subscriptions; exposes the ENR attnets
bitfield and the subscription set the gossip router joins.

(The port's copy of the JAX package's `network/subnets.py`.)
"""

from __future__ import annotations

from dataclasses import dataclass

from ..params import ATTESTATION_SUBNET_COUNT
from ..ssz.hashing import sha256

RANDOM_SUBNETS_PER_VALIDATOR = 1
EPOCHS_PER_RANDOM_SUBNET_SUBSCRIPTION = 256


@dataclass
class Subscription:
    subnet: int
    until_epoch: int


class AttnetsService:
    def __init__(self, node_id: bytes, slots_per_epoch: int):
        self.node_id = node_id
        self.spe = slots_per_epoch
        self.long_lived: list[Subscription] = []
        self.short_lived: list[Subscription] = []

    # -- long-lived random subscriptions -------------------------------------

    def _random_subnet(self, epoch: int, i: int) -> int:
        period = epoch // EPOCHS_PER_RANDOM_SUBNET_SUBSCRIPTION
        seed = sha256(
            self.node_id + period.to_bytes(8, "little") + i.to_bytes(4, "little")
        )
        return int.from_bytes(seed[:8], "little") % ATTESTATION_SUBNET_COUNT

    def rotate(self, epoch: int, validator_count: int) -> None:
        """Refresh long-lived subscriptions for the current period and
        drop expired short-lived ones."""
        n_subs = max(1, min(validator_count, 4)) * RANDOM_SUBNETS_PER_VALIDATOR
        period_end = (
            (epoch // EPOCHS_PER_RANDOM_SUBNET_SUBSCRIPTION + 1)
            * EPOCHS_PER_RANDOM_SUBNET_SUBSCRIPTION
        )
        self.long_lived = [
            Subscription(self._random_subnet(epoch, i), period_end)
            for i in range(n_subs)
        ]
        self.short_lived = [s for s in self.short_lived if s.until_epoch > epoch]

    # -- committee-duty subscriptions ----------------------------------------

    def subscribe_committee(self, subnet: int, until_epoch: int) -> None:
        self.short_lived.append(Subscription(subnet, until_epoch))

    # -- views ----------------------------------------------------------------

    def active_subnets(self, epoch: int) -> set[int]:
        return {
            s.subnet
            for s in self.long_lived + self.short_lived
            if s.until_epoch > epoch
        }

    def enr_attnets(self, epoch: int) -> list[bool]:
        """ENR attnets bitfield advertises only LONG-LIVED subscriptions
        (p2p spec: short-lived duties are not advertised)."""
        bits = [False] * ATTESTATION_SUBNET_COUNT
        for s in self.long_lived:
            if s.until_epoch > epoch:
                bits[s.subnet] = True
        return bits


class SyncnetsService:
    """Sync-committee subnet subscriptions (reference
    `network/subnets/syncnetsService.ts`): subscriptions follow the
    validator's sync-committee membership for whole sync-committee
    periods — no random rotation, unlike attnets."""

    SYNC_COMMITTEE_SUBNET_COUNT = 4

    def __init__(self, slots_per_epoch: int, epochs_per_period: int = 256):
        self.spe = slots_per_epoch
        self.epochs_per_period = epochs_per_period
        self.subscriptions: list[Subscription] = []

    def subscribe_committee_member(self, subnet: int, until_epoch: int) -> None:
        """Called when a local validator joins a sync subcommittee."""
        self.subscriptions.append(Subscription(subnet, until_epoch))

    def prune(self, epoch: int) -> None:
        self.subscriptions = [s for s in self.subscriptions if s.until_epoch > epoch]

    def active_subnets(self, epoch: int) -> set[int]:
        return {s.subnet for s in self.subscriptions if s.until_epoch > epoch}

    def enr_syncnets(self, epoch: int) -> list[bool]:
        bits = [False] * self.SYNC_COMMITTEE_SUBNET_COUNT
        for s in self.subscriptions:
            if s.until_epoch > epoch:
                bits[s.subnet] = True
        return bits

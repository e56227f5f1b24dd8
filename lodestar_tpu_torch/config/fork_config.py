"""Fork schedule derived from a ChainConfig.

Equivalent of packages/config/src/forkConfig/index.ts
(`IForkConfig`): orders forks by activation epoch, answers "which fork is
active at slot/epoch N", and exposes per-fork version/prev-version info.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..params import FAR_FUTURE_EPOCH, ForkName, ForkSeq
from .chain_config import ChainConfig


@dataclass(frozen=True)
class ForkInfo:
    name: str
    seq: ForkSeq
    epoch: int
    version: bytes
    prev_version: bytes
    prev_fork_name: str


class ForkConfig:
    def __init__(self, chain_config: ChainConfig, slots_per_epoch: int):
        cc = chain_config
        self.slots_per_epoch = slots_per_epoch
        entries = [
            (ForkName.phase0, 0, cc.GENESIS_FORK_VERSION),
            (ForkName.altair, cc.ALTAIR_FORK_EPOCH, cc.ALTAIR_FORK_VERSION),
            (ForkName.bellatrix, cc.BELLATRIX_FORK_EPOCH, cc.BELLATRIX_FORK_VERSION),
            (ForkName.capella, cc.CAPELLA_FORK_EPOCH, cc.CAPELLA_FORK_VERSION),
        ]
        forks: dict[str, ForkInfo] = {}
        prev_name, prev_version = ForkName.phase0, cc.GENESIS_FORK_VERSION
        for name, epoch, version in entries:
            forks[name] = ForkInfo(
                name=name,
                seq=ForkSeq[name],
                epoch=epoch,
                version=version,
                prev_version=prev_version,
                prev_fork_name=prev_name,
            )
            if epoch != FAR_FUTURE_EPOCH:
                prev_name, prev_version = name, version
        self.forks = forks
        # Forks ascending by (activation epoch, seq); only scheduled ones.
        self.forks_ascending = sorted(forks.values(), key=lambda f: (f.epoch, f.seq))
        self.forks_descending = list(reversed(self.forks_ascending))

    def get_fork_info(self, name: str) -> ForkInfo:
        return self.forks[name]

    def get_fork_name_at_epoch(self, epoch: int) -> str:
        for fork in self.forks_descending:
            if epoch >= fork.epoch and fork.epoch != FAR_FUTURE_EPOCH:
                return fork.name
        return ForkName.phase0

    def get_fork_name_at_slot(self, slot: int) -> str:
        return self.get_fork_name_at_epoch(slot // self.slots_per_epoch)

    def get_fork_version_at_epoch(self, epoch: int) -> bytes:
        return self.forks[self.get_fork_name_at_epoch(epoch)].version

    def get_scheduled_forks(self) -> list[ForkInfo]:
        return [f for f in self.forks_ascending if f.epoch != FAR_FUTURE_EPOCH]

    def get_active_forks_around_epoch(self, epoch: int, tolerance_epochs: int = 2) -> list[str]:
        """Forks active within ±tolerance of `epoch` — used by the network
        layer to subscribe to both forks' gossip topics around a transition
        (reference: network.ts fork subscription logic)."""
        active: list[str] = []
        for fork in self.get_scheduled_forks():
            if fork.epoch == 0 or fork.epoch <= epoch + tolerance_epochs:
                active.append(fork.name)
        # Keep only the latest fork plus any fork whose transition is nearby.
        result = []
        for i, name in enumerate(active):
            fork = self.forks[name]
            is_last = i == len(active) - 1
            next_fork = self.forks[active[i + 1]] if not is_last else None
            if is_last or (next_fork is not None and epoch < next_fork.epoch + tolerance_epochs):
                result.append(name)
        return result

"""Fee-recipient registrations per proposer.

Reference: `chain/beaconProposerCache.ts` — validators announce their
fee recipient via prepareBeaconProposer; block production looks the
proposer up here; entries expire after a retention window so stale
registrations don't linger.
"""

from __future__ import annotations

PROPOSER_PRESERVE_EPOCHS = 2


class BeaconProposerCache:
    def __init__(self, default_fee_recipient: bytes = b"\x00" * 20):
        self.default_fee_recipient = default_fee_recipient
        # validator index → (epoch registered, fee recipient)
        self._entries: dict[int, tuple[int, bytes]] = {}

    def add(self, epoch: int, validator_index: int, fee_recipient: bytes) -> None:
        self._entries[int(validator_index)] = (int(epoch), bytes(fee_recipient))

    def get(self, validator_index: int) -> bytes:
        entry = self._entries.get(int(validator_index))
        return entry[1] if entry is not None else self.default_fee_recipient

    def prune(self, current_epoch: int) -> None:
        cutoff = current_epoch - PROPOSER_PRESERVE_EPOCHS
        self._entries = {
            idx: (epoch, fr)
            for idx, (epoch, fr) in self._entries.items()
            if epoch >= cutoff
        }

    def __len__(self) -> int:
        return len(self._entries)

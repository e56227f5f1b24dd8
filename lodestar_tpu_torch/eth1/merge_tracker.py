"""Terminal PoW block tracker for the merge transition.

The port's copy of `lodestar_tpu/eth1/merge_tracker.py`. Reference:
`eth1/eth1MergeBlockTracker.ts` — while bellatrix is scheduled but the
chain has not merged, poll the eth1 endpoint for the first block whose
total difficulty crosses TERMINAL_TOTAL_DIFFICULTY with a parent still
below it; that block's hash becomes the first execution payload's parent
(`prepareExecutionPayload`).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Protocol

log = logging.getLogger("eth1-merge")


@dataclass
class PowBlock:
    block_hash: bytes
    parent_hash: bytes
    total_difficulty: int
    number: int = 0


class IPowProvider(Protocol):
    def get_pow_block(self, block_hash: bytes) -> PowBlock | None: ...
    def latest_pow_block(self) -> PowBlock | None: ...


class PowProviderMock:
    """In-memory PoW chain for tests (role of the mocked eth1 provider)."""

    def __init__(self):
        self.blocks: dict[bytes, PowBlock] = {}
        self.head: bytes | None = None

    def add_block(self, block_hash: bytes, parent_hash: bytes, total_difficulty: int):
        number = 0
        parent = self.blocks.get(parent_hash)
        if parent is not None:
            number = parent.number + 1
        self.blocks[block_hash] = PowBlock(
            block_hash, parent_hash, total_difficulty, number
        )
        self.head = block_hash

    def get_pow_block(self, block_hash: bytes) -> PowBlock | None:
        return self.blocks.get(block_hash)

    def latest_pow_block(self) -> PowBlock | None:
        return self.blocks.get(self.head) if self.head else None


class Eth1MergeBlockTracker:
    """Finds and caches the terminal PoW block (status: PRE_MERGE →
    SEARCHING → FOUND, reference StatusCode)."""

    def __init__(self, config, provider: IPowProvider):
        self.ttd = config.TERMINAL_TOTAL_DIFFICULTY
        self.terminal_block_hash = config.TERMINAL_BLOCK_HASH
        self.provider = provider
        self.terminal_block: PowBlock | None = None

    def is_valid_terminal_pow_block(self, block: PowBlock) -> bool:
        """Spec is_valid_terminal_pow_block: block crossed TTD, parent did
        not (genesis parent counts as below)."""
        if block.total_difficulty < self.ttd:
            return False
        parent = self.provider.get_pow_block(block.parent_hash)
        return parent is None or parent.total_difficulty < self.ttd

    def get_terminal_pow_block(self) -> PowBlock | None:
        """Poll step: walk back from the head to the first TTD-crossing
        block. Cached once found (the terminal block never changes)."""
        if self.terminal_block is not None:
            return self.terminal_block
        # explicit override (TERMINAL_BLOCK_HASH configured non-zero)
        if self.terminal_block_hash != b"\x00" * 32:
            block = self.provider.get_pow_block(self.terminal_block_hash)
            if block is not None:
                self.terminal_block = block
            return self.terminal_block
        block = self.provider.latest_pow_block()
        while block is not None and block.total_difficulty >= self.ttd:
            parent = self.provider.get_pow_block(block.parent_hash)
            if parent is None or parent.total_difficulty < self.ttd:
                log.info(
                    "terminal PoW block found: %s (TD %d)",
                    block.block_hash.hex()[:12],
                    block.total_difficulty,
                )
                self.terminal_block = block
                return block
            block = parent
        return None

"""Deposit tracker: follow deposit logs, serve deposits for block
production, pick the eth1-data vote.

The port's copy of `lodestar_tpu/eth1/deposit_tracker.py`. Reference:
`eth1/eth1DepositDataTracker.ts` (log batching into the cache, deposit
proofs for produceBlock), `eth1DataCache.ts`, and the majority eth1-vote
rule of the spec's `get_eth1_vote`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol

from ..state_transition.genesis import DepositTree


@dataclass
class DepositLog:
    index: int
    deposit_data: object  # types.DepositData
    block_number: int


@dataclass
class Eth1Block:
    block_number: int
    block_hash: bytes
    timestamp: int
    deposit_root: bytes
    deposit_count: int


class IEth1Provider(Protocol):
    def get_deposit_logs(self, from_block: int, to_block: int) -> list[DepositLog]: ...
    def get_block_by_number(self, number: int) -> Eth1Block | None: ...
    def latest_block_number(self) -> int: ...


class Eth1ProviderMock:
    """In-memory eth1 chain for dev/sim (reference dev path injects
    deposits without a real RPC)."""

    def __init__(self):
        self.logs: list[DepositLog] = []
        self.blocks: list[Eth1Block] = []

    def add_block(self, block_hash: bytes, timestamp: int, deposits: list) -> None:
        start = len(self.logs)
        number = len(self.blocks)
        for i, dd in enumerate(deposits):
            self.logs.append(DepositLog(start + i, dd, number))
        tree = DepositTree()
        for log in self.logs:
            tree.append(log.deposit_data.hash_tree_root())
        self.blocks.append(
            Eth1Block(
                block_number=number,
                block_hash=block_hash,
                timestamp=timestamp,
                deposit_root=tree.root(),
                deposit_count=len(self.logs),
            )
        )

    def get_deposit_logs(self, from_block: int, to_block: int):
        return [l for l in self.logs if from_block <= l.block_number <= to_block]

    def get_block_by_number(self, number: int):
        return self.blocks[number] if number < len(self.blocks) else None

    def latest_block_number(self) -> int:
        return len(self.blocks) - 1


class Eth1DepositTracker:
    def __init__(self, config, types, provider: IEth1Provider):
        self.config = config
        self.types = types
        self.provider = provider
        self.tree = DepositTree()
        self.deposit_datas: list = []
        self._synced_to = -1

    def follow(self) -> None:
        """Pull new logs into the local deposit tree (reference:
        eth1DepositDataTracker's periodic update)."""
        latest = self.provider.latest_block_number()
        if latest <= self._synced_to:
            return
        for log in self.provider.get_deposit_logs(self._synced_to + 1, latest):
            assert log.index == len(self.deposit_datas), "deposit log gap"
            self.deposit_datas.append(log.deposit_data)
            self.tree.append(log.deposit_data.hash_tree_root())
        self._synced_to = latest

    def get_deposits_for_block(self, state) -> list:
        """Deposits to include: state.eth1_deposit_index onward, bounded by
        the state's eth1_data.deposit_count and MAX_DEPOSITS, with proofs
        against the state's deposit root (spec expectations enforced by
        process_operations)."""
        p = self.config.preset
        start = state.eth1_deposit_index
        available = min(state.eth1_data.deposit_count, len(self.deposit_datas))
        count = min(p.MAX_DEPOSITS, max(0, available - start))
        out = []
        # proofs must verify against the tree at deposit_count leaves
        partial = DepositTree()
        for dd in self.deposit_datas[: state.eth1_data.deposit_count]:
            partial.append(dd.hash_tree_root())
        for i in range(start, start + count):
            out.append(
                self.types.Deposit(
                    proof=partial.proof(i), data=self.deposit_datas[i].copy()
                )
            )
        return out

    def get_eth1_vote(self, state, current_time: int):
        """Majority vote among in-range votes, else keep current
        (spec get_eth1_vote simplified to the follow-distance window)."""
        votes = list(state.eth1_data_votes)
        if votes:
            counts: dict[bytes, int] = {}
            by_root = {}
            for v in votes:
                root = v.hash_tree_root()
                counts[root] = counts.get(root, 0) + 1
                by_root[root] = v
            best_root, best_count = max(counts.items(), key=lambda kv: kv[1])
            if best_count * 2 > len(votes):
                return by_root[best_root].copy()
        latest = self.provider.get_block_by_number(self.provider.latest_block_number())
        if latest is not None and latest.deposit_count >= state.eth1_data.deposit_count:
            return self.types.Eth1Data(
                deposit_root=latest.deposit_root,
                deposit_count=latest.deposit_count,
                block_hash=latest.block_hash,
            )
        return state.eth1_data.copy()

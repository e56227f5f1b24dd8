"""Hot state caches.

Reference: `chain/stateCache/` — `StateContextCache` (LRU of
CachedBeaconState by state root, max 96, `stateContextCache.ts:9`) and
`CheckpointStateCache` ((epoch, root)-keyed epoch-boundary states)."""

from __future__ import annotations

from collections import OrderedDict

MAX_STATES = 96


class StateContextCache:
    def __init__(self, max_states: int = MAX_STATES):
        self.max_states = max_states
        self._cache: "OrderedDict[bytes, object]" = OrderedDict()
        # block root → state root (for lookups by block)
        self._head_state_root_by_block: dict[bytes, bytes] = {}

    def get(self, state_root: bytes):
        cached = self._cache.get(state_root)
        if cached is not None:
            self._cache.move_to_end(state_root)
        return cached

    def add(self, state_root: bytes, cached_state, block_root: bytes | None = None):
        self._cache[state_root] = cached_state
        self._cache.move_to_end(state_root)
        if block_root is not None:
            self._head_state_root_by_block[block_root] = state_root
        while len(self._cache) > self.max_states:
            evicted, _ = self._cache.popitem(last=False)
            self._head_state_root_by_block = {
                b: s for b, s in self._head_state_root_by_block.items() if s != evicted
            }

    def get_by_block_root(self, block_root: bytes):
        state_root = self._head_state_root_by_block.get(block_root)
        return self.get(state_root) if state_root is not None else None

    def prune(self, keep_state_roots: set[bytes]) -> None:
        for root in [r for r in self._cache if r not in keep_state_roots]:
            del self._cache[root]

    def __len__(self) -> int:
        return len(self._cache)


class CheckpointStateCache:
    """(epoch, block root) → epoch-boundary state; serves attestation-target
    state lookups and epoch-cache warm starts."""

    def __init__(self, max_states: int = MAX_STATES):
        self.max_states = max_states
        self._cache: "OrderedDict[tuple[int, bytes], object]" = OrderedDict()

    def get(self, epoch: int, root: bytes):
        key = (epoch, root)
        cached = self._cache.get(key)
        if cached is not None:
            self._cache.move_to_end(key)
        return cached

    def add(self, epoch: int, root: bytes, cached_state) -> None:
        self._cache[(epoch, root)] = cached_state
        self._cache.move_to_end((epoch, root))
        while len(self._cache) > self.max_states:
            self._cache.popitem(last=False)

    def get_latest(self, root: bytes, max_epoch: int):
        best = None
        best_epoch = -1
        for (epoch, r), state in self._cache.items():
            if r == root and best_epoch < epoch <= max_epoch:
                best, best_epoch = state, epoch
        return best

    def prune_finalized(self, finalized_epoch: int) -> None:
        for key in [k for k in self._cache if k[0] < finalized_epoch]:
            del self._cache[key]

"""State regeneration: produce any hot state by replaying blocks from the
nearest cached ancestor state.

Reference: `chain/regen/` — `QueuedStateRegenerator` (queued.ts:27) /
`StateRegenerator` (regen.ts:35-115): getPreState / getCheckpointState /
getState with checkpoint- and state-cache fast paths, block replay with
signature verification OFF (blocks were verified on first import).
"""

from __future__ import annotations

from ..state_transition import process_slots
from ..state_transition.stf import state_transition
from ..state_transition import util as st_util


class RegenError(ValueError):
    pass


class StateRegenerator:
    # reference QueuedStateRegenerator: JobItemQueue maxLength 256 — a
    # deep-replay storm must reject, not pile up unboundedly
    MAX_PENDING = 256

    def __init__(self, chain):
        self.chain = chain
        # (parent_root, slot) → advanced pre-state; see get_pre_state
        self._block_slot_cache: dict[tuple[bytes, int], object] = {}
        import threading

        # serialize expensive replays (the reference queues them for the
        # same reason: concurrent deep replays multiply the work) and
        # bound how many callers may wait
        self._replay_lock = threading.Lock()
        self._pending = 0
        self._pending_lock = threading.Lock()
        # guards _block_slot_cache: gossip validation and the import path
        # mutate it from different threads, and the pop(next(iter()))
        # eviction can KeyError under a race
        self._slot_cache_lock = threading.Lock()

    def _admit(self):
        m = getattr(self.chain, "metrics", None)
        with self._pending_lock:
            if self._pending >= self.MAX_PENDING:
                if m is not None:
                    m.regen_rejections_total.inc()
                raise RegenError(
                    f"regen queue full ({self.MAX_PENDING} pending replays)"
                )
            self._pending += 1
            if m is not None:
                m.regen_queue_pending.set(self._pending)

    def _done(self):
        m = getattr(self.chain, "metrics", None)
        with self._pending_lock:
            self._pending -= 1
            if m is not None:
                m.regen_queue_pending.set(self._pending)

    def get_state_by_root(self, state_root: bytes):
        cached = self.chain.state_cache.get(state_root)
        if cached is not None:
            return cached
        raise RegenError("state root not in hot cache; replay requires block root")

    def get_state_for_block(self, block_root: bytes):
        """State after applying the block with `block_root` (replaying
        ancestors from the nearest cached state if needed). Replays are
        serialized and bounded (MAX_PENDING) like the reference's queued
        regenerator."""
        cached = self.chain.state_cache.get_by_block_root(block_root)
        if cached is not None:
            return cached
        self._admit()
        try:
            with self._replay_lock:
                return self._replay_for_block(block_root)
        finally:
            self._done()

    def _replay_for_block(self, block_root: bytes):
        # re-check under the lock: a concurrent replay may have cached it
        cached = self.chain.state_cache.get_by_block_root(block_root)
        if cached is not None:
            return cached
        m = getattr(self.chain, "metrics", None)
        if m is not None:
            m.regen_replays_total.inc()
        # walk back through fork choice ancestry to a cached state
        chain_path = []
        root = block_root
        base = None
        while True:
            node = self.chain.fork_choice.proto.get_node(root)
            if node is None:
                raise RegenError(f"unknown block {root.hex()}")
            cached = self.chain.state_cache.get_by_block_root(root)
            if cached is not None:
                base = cached
                break
            chain_path.append(root)
            if node.parent is None:
                raise RegenError("no cached ancestor state to replay from")
            root = self.chain.fork_choice.proto.nodes[node.parent].root
        # replay forward
        state = base.copy()
        for r in reversed(chain_path):
            signed = self.chain.blocks.get(r)
            if signed is None:
                raise RegenError(f"missing block body for {r.hex()}")
            state_transition(
                state, self.chain.types, signed,
                verify_state_root=False, verify_signatures=False,
            )
            self.chain.state_cache.add(
                state.state.hash_tree_root(), state.copy(), block_root=r
            )
        return state

    def get_pre_state(self, block) -> object:
        """Pre-state for a block: parent state advanced to the block's slot
        (reference getPreState — the BlockProcessor entry point).

        A tiny (parent_root, slot) cache dedupes the advance between
        gossip validation (proposer/signature checks) and the import that
        follows moments later — the reference's getBlockSlotState role.
        Callers must NOT mutate the returned state (import copies it)."""
        key = (bytes(block.parent_root), int(block.slot))
        with self._slot_cache_lock:
            cached = self._block_slot_cache.get(key)
        if cached is not None:
            return cached
        pre = self.get_state_for_block(bytes(block.parent_root))
        pre = pre.copy()
        if block.slot > pre.state.slot:
            process_slots(pre, self.chain.types, block.slot)
        # safe to share across reader threads: EpochContext builds its
        # shufflings/proposer tables eagerly in load_state (cache.py), so
        # the cached state is immutable for readers — the lock only has to
        # make the get/evict/insert sequence atomic
        with self._slot_cache_lock:
            while len(self._block_slot_cache) >= 4:
                k = next(iter(self._block_slot_cache), None)
                if k is None:
                    break
                self._block_slot_cache.pop(k, None)
            self._block_slot_cache[key] = pre
        return pre

    def get_checkpoint_state(self, epoch: int, root: bytes):
        """Epoch-boundary state for (epoch, root) — the attestation-target
        state (reference getCheckpointState)."""
        hit = self.chain.checkpoint_state_cache.get(epoch, root)
        if hit is not None:
            return hit
        state = self.get_state_for_block(root).copy()
        boundary = st_util.compute_start_slot_at_epoch(
            epoch, self.chain.preset.SLOTS_PER_EPOCH
        )
        if state.state.slot < boundary:
            process_slots(state, self.chain.types, boundary)
        self.chain.checkpoint_state_cache.add(epoch, root, state)
        return state

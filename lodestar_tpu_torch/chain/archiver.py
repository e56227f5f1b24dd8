"""Archiver: migrate finalized data hot→cold on finalization.

Reference: `chain/archiver/` — `archiveBlocks.ts:27` (move finalized-chain
blocks into the slot-indexed archive, drop non-canonical hot blocks),
`archiveStates.ts:24,43` (full state snapshot every
`archive_state_epoch_frequency` epochs), checkpoint-state pruning.
"""

from __future__ import annotations

from ..state_transition import util as st_util


class Archiver:
    def __init__(self, chain, db, archive_state_epoch_frequency: int = 1024):
        self.chain = chain
        self.db = db
        self.frequency = archive_state_epoch_frequency
        self.last_archived_epoch = -1

    def process_finalized(self) -> None:
        """Called after finalization advances (reference: Archiver's
        checkpoint listener)."""
        fin_epoch, fin_root = self.chain.finalized_checkpoint
        if fin_epoch <= self.last_archived_epoch:
            return
        fin_slot = st_util.compute_start_slot_at_epoch(
            fin_epoch, self.chain.preset.SLOTS_PER_EPOCH
        )
        proto = self.chain.fork_choice.proto

        # canonical finalized chain = ancestors of the finalized block
        canonical: list[bytes] = []
        if fin_root in proto.indices:
            canonical = [n.root for n in proto.iter_ancestors(fin_root)]
        canonical_set = set(canonical)

        # blocks below the finalized slot leave the hot set: canonical →
        # archive; non-canonical siblings are dropped (reference
        # archiveBlocks "migrate hot→cold")
        for root, signed in list(self.chain.blocks.items()):
            if signed is None or signed.message.slot >= fin_slot:
                continue
            if root in canonical_set:
                self.db.archive_block(signed)
                self.chain.finalized_blocks[root] = signed
                m = getattr(self.chain, "metrics", None)
                if m is not None:
                    m.archiver_blocks_total.inc()
            del self.chain.blocks[root]
            if self.db.block.has(root):
                self.db.block.delete(root)

        # periodic full state snapshot
        if fin_epoch % self.frequency == 0 or self.last_archived_epoch < 0:
            state = self.chain.state_cache.get_by_block_root(fin_root)
            if state is not None:
                self.db.state_archive.put(
                    self.db.state_archive.slot_key(state.state.slot), state.state
                )
                m = getattr(self.chain, "metrics", None)
                if m is not None:
                    m.archiver_states_total.inc()
        self.last_archived_epoch = fin_epoch
        self.chain.fork_choice.prune()

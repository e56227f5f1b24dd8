"""Light-client server: produce bootstrap + updates at block import.

Reference: `beacon-node/src/chain/lightClient/index.ts` — on block import
the server stores the attested header's committee proofs and keeps the
best (most-participated) update per sync-committee period; bootstrap is
served for finalized checkpoints.
"""

from __future__ import annotations

from collections import OrderedDict

MAX_BOOTSTRAP_ENTRIES = 4096


def block_to_header(types, signed_block, state_root: bytes | None = None):
    msg = signed_block.message
    return types.BeaconBlockHeader(
        slot=msg.slot,
        proposer_index=msg.proposer_index,
        parent_root=bytes(msg.parent_root),
        state_root=state_root if state_root is not None else bytes(msg.state_root),
        body_root=msg.body.hash_tree_root(),
    )


class LightClientServer:
    def __init__(self, config, types, preset):
        self.config = config
        self.types = types
        self.preset = preset
        # period → best LightClientUpdate
        self.best_update_by_period: dict[int, object] = {}
        self.latest_finality_update = None
        self.latest_optimistic_update = None
        # block root → bootstrap data, LRU-bounded (the reference prunes
        # non-checkpoint data; unbounded growth would track chain length)
        self._bootstrap_by_root: "OrderedDict[bytes, object]" = OrderedDict()

    def _period(self, slot: int) -> int:
        return slot // (
            self.preset.SLOTS_PER_EPOCH * self.preset.EPOCHS_PER_SYNC_COMMITTEE_PERIOD
        )

    # -- import hook ---------------------------------------------------------

    def on_import_block(self, signed_block, attested_block, attested_state_cached) -> None:
        """Called after importing `signed_block` (whose sync_aggregate signs
        `attested_block`). The attested (parent) state provides the
        committees and finality proof."""
        types = self.types
        body = signed_block.message.body
        if not hasattr(body, "sync_aggregate"):
            return
        aggregate = body.sync_aggregate
        participation = sum(1 for b in aggregate.sync_committee_bits if b)
        att_state = attested_state_cached.state
        # ONE pass over the state's field roots yields the root and every
        # branch we need — no per-field re-merkleization on the import path
        state_type = type(att_state).ssz_type
        state_root, branches = state_type.get_field_branches(
            att_state,
            ["current_sync_committee", "next_sync_committee", "finalized_checkpoint"],
        )
        att_header = block_to_header(types, attested_block, state_root)

        # record bootstrap data for the attested block (LRU-bounded)
        boot_root = att_header.hash_tree_root()
        self._bootstrap_by_root[boot_root] = types.LightClientBootstrap(
            header=att_header.copy(),
            current_sync_committee=att_state.current_sync_committee.copy(),
            current_sync_committee_branch=branches["current_sync_committee"],
        )
        self._bootstrap_by_root.move_to_end(boot_root)
        while len(self._bootstrap_by_root) > MAX_BOOTSTRAP_ENTRIES:
            self._bootstrap_by_root.popitem(last=False)

        # finality proof from the attested state. Zero checkpoint root
        # (pre-finality) → empty header + real branch (spec zero-leaf
        # case); nonzero root with no known header → drop the finality
        # claim entirely (zeroed branch) rather than emit an unprovable one.
        fin_cp = att_state.finalized_checkpoint
        cp_type = type(fin_cp).ssz_type
        finality_branch = (
            cp_type.get_field_branch(fin_cp, "root") + branches["finalized_checkpoint"]
        )
        finalized_header = self._header_for_finalized(fin_cp)
        if (
            bytes(fin_cp.root) != b"\x00" * 32
            and finalized_header == types.BeaconBlockHeader()
        ):
            finality_branch = [b"\x00" * 32] * len(finality_branch)

        update = types.LightClientUpdate(
            attested_header=att_header.copy(),
            next_sync_committee=att_state.next_sync_committee.copy(),
            next_sync_committee_branch=branches["next_sync_committee"],
            finalized_header=finalized_header,
            finality_branch=finality_branch,
            sync_aggregate=aggregate.copy(),
            signature_slot=signed_block.message.slot,
        )
        period = self._period(att_header.slot)
        best = self.best_update_by_period.get(period)

        def score(u):
            # participation first, then finality-carrying, then freshness
            # (reference isBetterUpdate ordering)
            return (
                sum(1 for b in u.sync_aggregate.sync_committee_bits if b),
                any(bytes(b) != b"\x00" * 32 for b in u.finality_branch),
                u.attested_header.slot,
            )

        if best is None or score(update) > score(best):
            self.best_update_by_period[period] = update

        self.latest_optimistic_update = types.LightClientOptimisticUpdate(
            attested_header=att_header.copy(),
            sync_aggregate=aggregate.copy(),
            signature_slot=signed_block.message.slot,
        )
        if finalized_header.slot > 0:
            self.latest_finality_update = types.LightClientFinalityUpdate(
                attested_header=att_header.copy(),
                finalized_header=finalized_header.copy(),
                finality_branch=finality_branch,
                sync_aggregate=aggregate.copy(),
                signature_slot=signed_block.message.slot,
            )

    def _header_for_finalized(self, checkpoint):
        """Header of the finalized checkpoint block; empty header when
        nothing is finalized yet (genesis semantics)."""
        boot = self._bootstrap_by_root.get(bytes(checkpoint.root))
        if boot is not None:
            return boot.header.copy()
        return self.types.BeaconBlockHeader()

    # -- queries (reqresp/REST surface) --------------------------------------

    def get_bootstrap(self, block_root: bytes):
        return self._bootstrap_by_root.get(block_root)

    def get_updates(self, start_period: int, count: int) -> list:
        return [
            self.best_update_by_period[p]
            for p in range(start_period, start_period + count)
            if p in self.best_update_by_period
        ]

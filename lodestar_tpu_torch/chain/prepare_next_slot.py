"""Prepare-next-slot scheduler.

Reference: `chain/prepareNextSlot.ts:31` — at a fraction of the way through
each slot, pre-compute the next slot's state on the head (so epoch
transitions are paid off the critical path) and, when an execution payload
will be needed, issue an early forkchoiceUpdated with payload attributes so
the EL starts building.
"""

from __future__ import annotations

import logging

from ..state_transition import process_slots
from ..state_transition.stf import fork_types

log = logging.getLogger("prepare-next-slot")


class PrepareNextSlotScheduler:
    """Call `on_slot(slot)` near the end of each slot (the dev loop and the
    clock service drive it; reference wires it to clock ticks)."""

    def __init__(self, chain):
        self.chain = chain
        self.prepared: dict[int, object] = {}

    def on_slot(self, clock_slot: int) -> None:
        chain = self.chain
        next_slot = clock_slot + 1
        head = chain.head_state
        if head.state.slot >= next_slot:
            return
        # far behind the clock (pre-sync): preparing the next slot would
        # replay the whole gap through process_slots — skip until caught up
        if next_slot - head.state.slot > 2 * chain.preset.SLOTS_PER_EPOCH:
            return
        try:
            pre = head.copy()
            process_slots(pre, chain.types, next_slot)
        except Exception:
            return
        # produce_block at next_slot consumes this instead of re-running
        # process_slots (the epoch transition is the expensive part)
        self.prepared = {next_slot: (chain.head_root, pre)}
        self._prepare_execution(pre)

    def get_prepared(self, slot: int, head_root: bytes | None = None):
        """The precomputed state for `slot`, if it was derived from
        `head_root` (a reorg between prepare and produce invalidates it)."""
        entry = self.prepared.get(slot)
        if entry is None:
            return None
        prepared_head, pre = entry
        if head_root is not None and prepared_head != head_root:
            return None
        return pre

    def _prepare_execution(self, pre) -> None:
        """Early payload-building kick (reference: prepareNextSlot's
        forkchoiceUpdated with attributes)."""
        chain = self.chain
        if chain.execution_engine is None or not pre.is_execution:
            return
        from .chain import build_payload_attributes

        prepared = build_payload_attributes(
            chain.config, pre, fork_types(pre)
        )
        if prepared is None:
            return
        parent_hash, attributes = prepared
        try:
            chain.execution_engine.notify_forkchoice_update(
                parent_hash, parent_hash, parent_hash, attributes
            )
        except Exception as e:
            # early payload-building is advisory; block production falls
            # back to a late forkchoiceUpdated
            log.debug("early forkchoiceUpdated failed: %s", e)

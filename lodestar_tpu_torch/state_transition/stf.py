"""state_transition / process_slots — the pure transition driver.

The port's copy of `lodestar_tpu/state_transition/stf.py`, with its
process-wide metrics hook (`set_metrics`, which the node sets).
Reference: `state-transition/src/stateTransition.ts:30,91` — same
decomposition: per-slot root caching, epoch processing at boundaries,
fork upgrades at their activation epochs (`slot/upgradeStateTo*`), block
processing, optional post-state root verification.
"""

from __future__ import annotations

from ..params import ForkName
from .block import BlockProcessingError, process_block
from .epoch import process_epoch


_METRICS = None


def set_metrics(m) -> None:
    """Install the process-wide metric sink for STF timings (epoch
    transitions + incremental state hashing — reference lodestar.ts
    stfn.* epochTransition/hashTreeRoot timers)."""
    global _METRICS
    _METRICS = m


def fork_types(cached):
    """The SSZ namespace matching the state's current fork (the state may
    upgrade mid-process_slots, so types are resolved per use, not once)."""
    from ..types import get_types

    return get_types(cached.preset).by_fork[cached.fork]


def _process_epoch_for_fork(cached, types) -> None:
    if cached.is_altair:
        from .altair import process_epoch_altair

        process_epoch_altair(cached, types)
    else:
        process_epoch(cached, types)


def _upgrade_at_epoch_boundary(cached) -> None:
    """Apply the scheduled fork upgrade when the state has just entered a
    fork's activation epoch (reference: stateTransition.ts processSlots
    upgrade hooks)."""
    from ..types import get_types

    cfg, preset = cached.config, cached.preset
    epoch = cached.current_epoch
    all_types = get_types(preset)
    if cached.fork == ForkName.phase0 and epoch == cfg.ALTAIR_FORK_EPOCH:
        from .altair import upgrade_state_to_altair

        cached.sync_flat()
        cached.reload_state(
            upgrade_state_to_altair(cfg, preset, cached.state, all_types.altair)
        )
    if cached.fork == ForkName.altair and epoch == cfg.BELLATRIX_FORK_EPOCH:
        from .bellatrix import upgrade_state_to_bellatrix

        cached.sync_flat()
        cached.reload_state(
            upgrade_state_to_bellatrix(cfg, preset, cached.state, all_types.bellatrix)
        )
    if cached.fork == ForkName.bellatrix and epoch == cfg.CAPELLA_FORK_EPOCH:
        from .capella import upgrade_state_to_capella

        cached.sync_flat()
        cached.reload_state(
            upgrade_state_to_capella(cfg, preset, cached.state, all_types.capella)
        )


def process_slot(cached, types) -> None:
    import time as _t

    state, p = cached.state, cached.preset
    _t0 = _t.monotonic()
    prev_state_root = cached.hash_tree_root()  # incremental (hasher.py)
    if _METRICS is not None:
        _METRICS.state_hash_seconds.observe(_t.monotonic() - _t0)
        vh = getattr(cached, "_hasher", None)
        vh = getattr(vh, "_validators", None)
        if vh is not None:
            _METRICS.state_hash_dirty_validators.observe(vh.last_dirty)
    state.state_roots[state.slot % p.SLOTS_PER_HISTORICAL_ROOT] = prev_state_root
    if state.latest_block_header.state_root == b"\x00" * 32:
        state.latest_block_header.state_root = prev_state_root
    state.block_roots[state.slot % p.SLOTS_PER_HISTORICAL_ROOT] = (
        state.latest_block_header.hash_tree_root()
    )


def process_slots(cached, types, slot: int) -> None:
    state, p = cached.state, cached.preset
    if slot <= state.slot:
        raise BlockProcessingError(
            f"process_slots target {slot} <= current {state.slot}"
        )
    while state.slot < slot:
        process_slot(cached, fork_types(cached))
        if (state.slot + 1) % p.SLOTS_PER_EPOCH == 0:
            import time as _t

            _t0 = _t.monotonic()
            _process_epoch_for_fork(cached, fork_types(cached))
            if _METRICS is not None:
                _METRICS.epoch_transition_seconds.observe(_t.monotonic() - _t0)
            cached.sync_flat()
            state.slot += 1
            cached.epoch_ctx.rotate_epoch(state, cached.flat)
            _upgrade_at_epoch_boundary(cached)
            state = cached.state  # upgrades swap the container
        else:
            state.slot += 1


def state_transition(
    cached,
    types,
    signed_block,
    verify_state_root: bool = True,
    verify_signatures: bool = True,
    execution_engine=None,
):
    """Apply a signed block. The block-signature (proposer) check itself is
    part of the caller's signature-set batch (reference keeps it out of
    stateTransition too — `verifySignatures` option)."""
    block = signed_block.message
    if block.slot > cached.state.slot:
        process_slots(cached, types, block.slot)
    process_block(
        cached, fork_types(cached), block, verify_signatures, execution_engine
    )
    cached.sync_flat()
    if verify_state_root:
        got = cached.hash_tree_root()
        if got != bytes(block.state_root):
            raise BlockProcessingError(
                f"state root mismatch: {got.hex()} != {bytes(block.state_root).hex()}"
            )
    return cached

"""Anchor-state decision tree.

Reference: `cli/src/cmds/beacon/initBeaconState.ts` — in priority order:
1. checkpoint sync: fetch a finalized state from a trusted Beacon API and
   anchor from it (weak-subjectivity check applies);
2. db resume: the persisted latest state;
3. genesis: build from deposits (dev: interop genesis).

States persist with their fork name so resume decodes with the right
container across fork boundaries.

The port's copy of the JAX package's `node/init_state.py`.
"""

from __future__ import annotations

import logging
import time

from ..params import ForkName

log = logging.getLogger("init-state")


class StateInitError(Exception):
    pass


def _wall_clock_epoch(config, state) -> int:
    spe = config.preset.SLOTS_PER_EPOCH
    return max(
        0, int(time.time() - state.genesis_time) // (config.SECONDS_PER_SLOT * spe)
    )


def init_beacon_state(
    config,
    types_all,
    db,
    checkpoint_state_bytes: bytes | None = None,
    checkpoint_fork: str = ForkName.phase0,
    genesis_state=None,
    current_epoch: int | None = None,
):
    """Returns (state, origin) where origin ∈ {"checkpoint", "db", "genesis"}.

    `types_all`: the full per-fork namespace (get_types(preset)).
    `checkpoint_state_bytes`: SSZ-serialized finalized BeaconState from a
    trusted source (the CLI fetches it + its fork via getStateV2 —
    reference fetchWeakSubjectivityState). `current_epoch`: clock epoch for
    the weak-subjectivity check; None derives it from the wall clock.
    """
    ns = types_all.by_fork if hasattr(types_all, "by_fork") else None
    if checkpoint_state_bytes is not None:
        container = (
            ns[checkpoint_fork].BeaconState if ns else types_all.BeaconState
        )
        state = container.deserialize(checkpoint_state_bytes)
        epoch = current_epoch if current_epoch is not None else _wall_clock_epoch(config, state)
        from ..state_transition import CachedBeaconState
        from ..state_transition.weak_subjectivity import (
            compute_weak_subjectivity_period,
        )

        cached = CachedBeaconState(config, state.copy(), config.preset)
        ws_period = compute_weak_subjectivity_period(cached)
        if epoch > cached.current_epoch + ws_period:
            raise StateInitError(
                f"checkpoint state (epoch {cached.current_epoch}) is outside "
                f"the weak-subjectivity period ({ws_period} epochs) at clock "
                f"epoch {epoch}"
            )
        log.info(
            "anchor from checkpoint state: fork %s slot %d root %s",
            checkpoint_fork,
            state.slot,
            state.hash_tree_root().hex()[:12],
        )
        return state, "checkpoint"

    resumed = load_persisted_state(types_all, db)
    if resumed is not None:
        log.info("resuming from db: slot %d", resumed.slot)
        return resumed, "db"

    if genesis_state is not None:
        log.info("starting from genesis: time %d", genesis_state.genesis_time)
        return genesis_state, "genesis"

    raise StateInitError(
        "no anchor state: provide a checkpoint state, a populated datadir, "
        "or genesis parameters"
    )


# -- persistence (reference chain.persistToDisk/loadFromDisk) ----------------

# raw controller keys outside the Bucket range (0xfe prefix) so the state
# round-trips fork-agnostically
_STATE_KEY = bytes([0xFE]) + b"latest_state"
_FORK_KEY = bytes([0xFE]) + b"latest_state_fork"


def persist_state(db, state, fork: str | None = None) -> None:
    """Write the latest state snapshot (+ its fork name) for db-resume."""
    if fork is None:
        fork = _fork_of_state(state)
    controller = db.db
    controller.put(_STATE_KEY, type(state).ssz_type.serialize(state))
    controller.put(_FORK_KEY, str(fork).encode())


def load_persisted_state(types_all, db):
    controller = db.db
    raw = controller.get(_STATE_KEY)
    if raw is None:
        return None
    fork = (controller.get(_FORK_KEY) or b"phase0").decode()
    ns = types_all.by_fork if hasattr(types_all, "by_fork") else None
    container = ns[fork].BeaconState if ns else types_all.BeaconState
    return container.deserialize(raw)


def _fork_of_state(state) -> str:
    if hasattr(state, "next_withdrawal_index"):
        return ForkName.capella
    if hasattr(state, "latest_execution_payload_header"):
        return ForkName.bellatrix
    if hasattr(state, "previous_epoch_participation"):
        return ForkName.altair
    return ForkName.phase0

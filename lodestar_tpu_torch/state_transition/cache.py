"""Epoch-scoped caches + flat validator arrays.

The reference's speed comes from `EpochContext` / `EpochProcess`
(`state-transition/src/cache/epochContext.ts:80`, `epochProcess.ts:43`):
shufflings, proposers and flat effective-balance arrays computed once per
epoch. Here the same role is played by numpy struct-of-arrays — every
per-validator column is one contiguous uint64 array, so epoch processing
and committee math are SIMD passes rather than object-graph walks (and
can be lifted to device arrays wholesale).

The port's copy of `lodestar_tpu/state_transition/cache.py`: host code on
numpy, as there.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..params import (
    DOMAIN_BEACON_ATTESTER,
    DOMAIN_BEACON_PROPOSER,
    GENESIS_EPOCH,
)
from . import util

U64 = np.uint64


class FlatValidators:
    """Struct-of-arrays mirror of state.validators (+ balances).

    Columns are plain numpy arrays; `sync_to_state` writes mutated columns
    back into the SSZ containers before any hash_tree_root. Mutations during
    block/epoch processing go through BOTH (SSZ object is source of truth
    for roots; arrays are the compute representation)."""

    __slots__ = (
        "pubkeys", "effective_balance", "slashed",
        "activation_eligibility_epoch", "activation_epoch",
        "exit_epoch", "withdrawable_epoch", "balances",
        "withdrawal_credentials", "_sync_snap",
    )

    _SYNC_COLS = (
        "effective_balance", "slashed", "activation_eligibility_epoch",
        "activation_epoch", "exit_epoch", "withdrawable_epoch",
    )

    def __init__(self, state):
        vs = state.validators
        n = len(vs)
        self.pubkeys = [v.pubkey for v in vs]
        self.effective_balance = np.array([v.effective_balance for v in vs], U64)
        self.slashed = np.array([v.slashed for v in vs], bool)
        self.activation_eligibility_epoch = np.array(
            [v.activation_eligibility_epoch for v in vs], U64
        )
        self.activation_epoch = np.array([v.activation_epoch for v in vs], U64)
        self.exit_epoch = np.array([v.exit_epoch for v in vs], U64)
        self.withdrawable_epoch = np.array([v.withdrawable_epoch for v in vs], U64)
        self.balances = np.array(state.balances, U64)
        self.withdrawal_credentials = (
            np.frombuffer(
                b"".join(bytes(v.withdrawal_credentials) for v in vs), np.uint8
            ).reshape(n, 32).copy()
            if n
            else np.zeros((0, 32), np.uint8)
        )
        self._sync_snap = None

    def __len__(self):
        return len(self.effective_balance)

    def append(self, validator, balance: int):
        self.pubkeys.append(validator.pubkey)
        self.effective_balance = np.append(
            self.effective_balance, U64(validator.effective_balance)
        )
        self.slashed = np.append(self.slashed, bool(validator.slashed))
        self.activation_eligibility_epoch = np.append(
            self.activation_eligibility_epoch, U64(validator.activation_eligibility_epoch)
        )
        self.activation_epoch = np.append(
            self.activation_epoch, U64(validator.activation_epoch)
        )
        self.exit_epoch = np.append(self.exit_epoch, U64(validator.exit_epoch))
        self.withdrawable_epoch = np.append(
            self.withdrawable_epoch, U64(validator.withdrawable_epoch)
        )
        self.balances = np.append(self.balances, U64(balance))
        self.withdrawal_credentials = np.concatenate(
            [
                self.withdrawal_credentials,
                np.frombuffer(
                    bytes(validator.withdrawal_credentials), np.uint8
                ).reshape(1, 32),
            ]
        )

    def active_indices(self, epoch: int) -> np.ndarray:
        mask = util.active_mask(self.activation_epoch, self.exit_epoch, epoch)
        return np.nonzero(mask)[0].astype(np.int64)

    def total_active_balance(self, epoch: int, increment: int) -> int:
        mask = util.active_mask(self.activation_epoch, self.exit_epoch, epoch)
        total = int(self.effective_balance[mask].sum())
        return max(increment, total)

    def sync_to_state(self, state) -> None:
        """Write mutated columns back into the SSZ containers.

        Dirty-row write-back: columns are diffed against the last-synced
        snapshot (vectorized), so a per-slot sync where nothing changed is
        O(compare) instead of an O(n) Python object walk — the per-slot
        state-root path (`CachedBeaconState.hash_tree_root`) calls this
        every slot and the incremental hasher already made the hashing
        itself O(dirty·log n) (round-3 review finding)."""
        vs = state.validators
        n = len(self.effective_balance)
        snap = getattr(self, "_sync_snap", None)
        if (
            snap is None
            or len(snap["effective_balance"]) != n
            or len(vs) != n
            or len(state.balances) != n
        ):
            dirty = np.arange(n)
            bal_dirty = np.arange(n)
        else:
            changed = np.zeros(n, bool)
            for name in self._SYNC_COLS:
                changed |= snap[name] != getattr(self, name)
            from ..ssz.tree_cache import rows_ne

            changed |= rows_ne(snap["wc"], self.withdrawal_credentials)
            dirty = np.nonzero(changed)[0]
            bal_dirty = np.nonzero(snap["balances"] != self.balances)[0]
        if len(dirty):
            wc_bytes = self.withdrawal_credentials.tobytes()
            for i in dirty:
                i = int(i)
                v = vs[i]
                v.effective_balance = int(self.effective_balance[i])
                v.slashed = bool(self.slashed[i])
                v.activation_eligibility_epoch = int(
                    self.activation_eligibility_epoch[i]
                )
                v.activation_epoch = int(self.activation_epoch[i])
                v.exit_epoch = int(self.exit_epoch[i])
                v.withdrawable_epoch = int(self.withdrawable_epoch[i])
                v.withdrawal_credentials = wc_bytes[32 * i : 32 * i + 32]
        if len(bal_dirty) == n:
            state.balances = [int(b) for b in self.balances]
        else:
            for i in bal_dirty:
                state.balances[int(i)] = int(self.balances[i])
        # snapshot maintenance is O(dirty) when shapes are stable
        if snap is not None and len(snap["effective_balance"]) == n:
            for name in self._SYNC_COLS:
                snap[name][dirty] = getattr(self, name)[dirty]
            snap["wc"][dirty] = self.withdrawal_credentials[dirty]
            snap["balances"][bal_dirty] = self.balances[bal_dirty]
        else:
            self._sync_snap = {
                name: getattr(self, name).copy() for name in self._SYNC_COLS
            }
            self._sync_snap["wc"] = self.withdrawal_credentials.copy()
            self._sync_snap["balances"] = self.balances.copy()


@dataclass
class EpochShuffling:
    """Active-set shuffling for one epoch (reference: IEpochShuffling in
    epochContext — activeIndices + committees derived by slicing)."""

    epoch: int
    active_indices: np.ndarray  # (n_active,) validator indices
    shuffled: np.ndarray        # permuted active_indices
    committees_per_slot: int


class EpochContext:
    """Per-epoch derived data: shufflings for prev/current/next, proposer
    schedule for the current epoch, pubkey→index map
    (reference: `cache/epochContext.ts`, `pubkeyCache.ts`)."""

    def __init__(self, config, preset):
        self.config = config
        self.preset = preset
        self.pubkey_to_index: dict[bytes, int] = {}
        self.previous: EpochShuffling | None = None
        self.current: EpochShuffling | None = None
        self.next: EpochShuffling | None = None
        self.proposers: list[int] = []
        self.current_epoch = -1

    # -- construction --------------------------------------------------------

    def load_state(self, state, flat: FlatValidators):
        epoch = util.compute_epoch_at_slot(state.slot, self.preset.SLOTS_PER_EPOCH)
        self.sync_pubkeys(flat)
        self.current = self._build_shuffling(state, flat, epoch)
        prev_epoch = max(GENESIS_EPOCH, epoch - 1)
        self.previous = (
            self.current if prev_epoch == epoch
            else self._build_shuffling(state, flat, prev_epoch)
        )
        self.next = self._build_shuffling(state, flat, epoch + 1)
        self.current_epoch = epoch
        self._compute_proposers(state, flat, epoch)

    def sync_pubkeys(self, flat: FlatValidators):
        for i in range(len(self.pubkey_to_index), len(flat.pubkeys)):
            self.pubkey_to_index[bytes(flat.pubkeys[i])] = i

    def _build_shuffling(self, state, flat: FlatValidators, epoch: int):
        from . import stf as _stf

        if _stf._METRICS is not None:
            _stf._METRICS.shuffling_cache_misses_total.inc()
        active = flat.active_indices(epoch)
        seed = util.get_seed(state, epoch, DOMAIN_BEACON_ATTESTER, self.preset)
        shuffled = util.shuffle_list(active, seed, self.preset.SHUFFLE_ROUND_COUNT)
        cps = util.get_committee_count_per_slot(len(active), self.preset)
        return EpochShuffling(epoch, active, shuffled, cps)

    def _compute_proposers(self, state, flat: FlatValidators, epoch: int):
        seed_base = util.get_seed(state, epoch, DOMAIN_BEACON_PROPOSER, self.preset)
        from ..ssz.hashing import sha256

        start = util.compute_start_slot_at_epoch(epoch, self.preset.SLOTS_PER_EPOCH)
        self.proposers = [
            util.compute_proposer_index(
                flat.effective_balance,
                self.current.active_indices,
                sha256(seed_base + slot.to_bytes(8, "little")),
                self.preset,
            )
            for slot in range(start, start + self.preset.SLOTS_PER_EPOCH)
        ]

    # -- epoch rotation -------------------------------------------------------

    def rotate_epoch(self, state, flat: FlatValidators):
        """After `process_epoch`: prev←current, current←next, next rebuilt
        (reference: `epochContext.afterProcessEpoch` :454)."""
        epoch = self.current_epoch + 1
        self.previous = self.current
        self.current = self.next
        # current shuffling's committees_per_slot may change if the active
        # set changed during registry updates — rebuild honestly.
        self.next = self._build_shuffling(state, flat, epoch + 1)
        self.current_epoch = epoch
        self._compute_proposers(state, flat, epoch)

    # -- queries --------------------------------------------------------------

    def _shuffling_at(self, epoch: int) -> EpochShuffling:
        for sh in (self.previous, self.current, self.next):
            if sh is not None and sh.epoch == epoch:
                from . import stf as _stf

                if _stf._METRICS is not None:
                    _stf._METRICS.shuffling_cache_hits_total.inc()
                return sh
        raise ValueError(f"no shuffling cached for epoch {epoch}")

    def get_committee_count_per_slot(self, epoch: int) -> int:
        return self._shuffling_at(epoch).committees_per_slot

    def get_beacon_committee(self, slot: int, index: int) -> np.ndarray:
        epoch = util.compute_epoch_at_slot(slot, self.preset.SLOTS_PER_EPOCH)
        sh = self._shuffling_at(epoch)
        return util.compute_committee_slice(
            sh.shuffled,
            slot % self.preset.SLOTS_PER_EPOCH,
            index,
            sh.committees_per_slot,
            self.preset.SLOTS_PER_EPOCH,
        )

    def get_beacon_proposer(self, slot: int) -> int:
        epoch = util.compute_epoch_at_slot(slot, self.preset.SLOTS_PER_EPOCH)
        if epoch != self.current_epoch:
            raise ValueError("proposer requested outside current epoch")
        return self.proposers[slot % self.preset.SLOTS_PER_EPOCH]


class CachedBeaconState:
    """SSZ state + flat arrays + epoch context, travelling together
    (reference: `CachedBeaconState*`, `cache/stateCache.ts:112`)."""

    def __init__(self, config, state, preset=None):
        self.config = config
        self.preset = preset if preset is not None else config.preset
        self.state = state
        self.flat = FlatValidators(state)
        # Fork detection by state shape (each fork adds fields); drives the
        # per-fork branches in block/epoch processing (reference: ForkSeq
        # comparisons throughout state-transition/src).
        from ..params import ForkName, ForkSeq

        if hasattr(state, "next_withdrawal_index"):
            self.fork = ForkName.capella
        elif hasattr(state, "latest_execution_payload_header"):
            self.fork = ForkName.bellatrix
        elif hasattr(state, "previous_epoch_participation"):
            self.fork = ForkName.altair
        else:
            self.fork = ForkName.phase0
        self.fork_seq = ForkSeq[self.fork]
        # altair+: participation flags + inactivity scores mirror into flat
        # arrays (same pattern as FlatValidators)
        self.is_altair = self.fork_seq >= ForkSeq.altair
        self.is_execution = self.fork_seq >= ForkSeq.bellatrix
        self.is_capella = self.fork_seq >= ForkSeq.capella
        if self.is_altair:
            self.previous_participation = np.array(
                state.previous_epoch_participation, np.uint8
            )
            self.current_participation = np.array(
                state.current_epoch_participation, np.uint8
            )
            self.inactivity_scores = np.array(state.inactivity_scores, U64)
        self.epoch_ctx = EpochContext(config, self.preset)
        self.epoch_ctx.load_state(state, self.flat)
        self._hasher = None

    def hash_tree_root(self) -> bytes:
        """State root via the incremental columnar hasher (bit-identical to
        `state.hash_tree_root()`; re-hashes only dirty paths — the
        reference's ViewDU commit+hashTreeRoot analog,
        `stateTransition.ts:69-74`). Syncs flat columns first."""
        self.sync_flat()
        if self._hasher is None or self._hasher.state_class is not type(self.state):
            from .hasher import StateHasher

            self._hasher = StateHasher(self.state)
        return self._hasher.root(self)

    def sync_flat(self) -> None:
        """Write every flat-array column back into the SSZ state (called
        before any hash_tree_root)."""
        self.flat.sync_to_state(self.state)
        if self.is_altair:
            n = len(self.flat)
            # new validators since load: extend participation columns
            for name in ("previous_participation", "current_participation"):
                arr = getattr(self, name)
                if len(arr) < n:
                    setattr(
                        self,
                        name,
                        np.concatenate([arr, np.zeros(n - len(arr), np.uint8)]),
                    )
            if len(self.inactivity_scores) < n:
                self.inactivity_scores = np.concatenate(
                    [self.inactivity_scores, np.zeros(n - len(self.inactivity_scores), U64)]
                )
            self.state.previous_epoch_participation = [
                int(x) for x in self.previous_participation
            ]
            self.state.current_epoch_participation = [
                int(x) for x in self.current_participation
            ]
            self.state.inactivity_scores = [int(x) for x in self.inactivity_scores]

    @property
    def slot(self) -> int:
        return self.state.slot

    @property
    def current_epoch(self) -> int:
        return util.compute_epoch_at_slot(self.state.slot, self.preset.SLOTS_PER_EPOCH)

    @property
    def previous_epoch(self) -> int:
        return max(GENESIS_EPOCH, self.current_epoch - 1)

    def copy(self) -> "CachedBeaconState":
        self.sync_flat()  # flat arrays may be dirty mid-pipeline
        return CachedBeaconState(self.config, self.state.copy(), self.preset)

    def reload_state(self, state) -> None:
        """Adopt a new underlying state in place (fork upgrades swap the
        state container type mid-process_slots; reference rebuilds the
        CachedBeaconState on upgrade — stateTransition.ts processSlots)."""
        self.__init__(self.config, state, self.preset)

"""ForkChoice: LMD-GHOST votes + FFG checkpoints over the proto-array.

Reference behavior: `fork-choice/src/forkChoice/forkChoice.ts` —
`onBlock` (:294), `onAttestation` (:505), `updateHead` (:184), queued
attestations for future epochs, equivocation (attester-slashing) handling,
checkpoint balances. Vote state here is three numpy arrays indexed by
validator (current root index, next root index, last-update epoch) so
`compute_deltas` is two bincounts over int arrays
(reference computeDeltas.ts walks a JS array per validator).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..params.constants import INTERVALS_PER_SLOT
from .proto_array import ProtoArray

NO_VOTE = -1


@dataclass
class ForkChoiceStore:
    """FFG bookkeeping (reference IForkChoiceStore, forkChoice/store.ts)."""

    current_slot: int
    justified_checkpoint: tuple[int, bytes]
    finalized_checkpoint: tuple[int, bytes]
    justified_balances: np.ndarray  # effective balances at justified state
    # better justified checkpoint held back by the bouncing-attack guard
    # (adopted at the next epoch boundary — forkChoice.ts onTick)
    best_justified: tuple[int, bytes] | None = None
    best_justified_balances: np.ndarray | None = None
    # best checkpoints any imported block WOULD reach if its epoch ended
    # now (forkChoice.ts fcStore.unrealizedJustified)
    unrealized_justified: tuple[int, bytes] | None = None
    unrealized_justified_balances: np.ndarray | None = None
    unrealized_finalized: tuple[int, bytes] | None = None


class ForkChoiceError(ValueError):
    pass


class ForkChoice:
    def __init__(
        self,
        store: ForkChoiceStore,
        proto_array: ProtoArray,
        slots_per_epoch: int,
        seconds_per_slot: int = 12,
        proposer_score_boost: int = 40,
        safe_slots_to_update_justified: int = 8,
        proposer_boost_enabled: bool = True,
        justified_balances_getter=None,
    ):
        self.store = store
        self.proto = proto_array
        # resolves (epoch, root) -> effective balances of THAT checkpoint's
        # state (reference justifiedBalancesGetter, forkChoice.ts:129);
        # without it adoption falls back to whatever balances the importing
        # block carried — close, but wrong across a large balance churn
        self.justified_balances_getter = justified_balances_getter
        self.slots_per_epoch = slots_per_epoch
        self.proto.slots_per_epoch = slots_per_epoch
        self.proto.current_slot = store.current_slot
        self.seconds_per_slot = seconds_per_slot
        self.proposer_score_boost = proposer_score_boost
        self.safe_slots_to_update_justified = safe_slots_to_update_justified
        self.proposer_boost_enabled = proposer_boost_enabled
        # timely-block boost (reference forkChoice.ts:93-95): root boosted
        # this slot, and the cached score at the current justified balances
        self.proposer_boost_root: bytes | None = None
        self._justified_proposer_boost_score: int | None = None
        n = len(store.justified_balances)
        # votes: per-validator (current message root idx, next message root
        # idx into proto.indices-space roots, target epoch of next message)
        self._vote_current = {}
        self._vote_next: dict[int, bytes] = {}
        self._vote_current_root: dict[int, bytes] = {}
        self._vote_next_epoch: dict[int, int] = {}
        self._equivocating: set[int] = set()
        self._queued_attestations: list[tuple[int, list[int], bytes, int]] = []
        self._balances_used = store.justified_balances.copy()
        self.head_root: bytes | None = None

    # -- time ----------------------------------------------------------------

    def update_time(self, current_slot: int) -> None:
        if current_slot - self.store.current_slot > 2 * self.slots_per_epoch:
            # far-future jump (node way behind wall clock): stepping every
            # slot would grind millions of iterations — land directly and
            # drain the queues/boost once
            self.store.current_slot = current_slot
            self.proposer_boost_root = None
            self._on_epoch_boundary()
            self._process_queued_attestations()
            return
        while self.store.current_slot < current_slot:
            self.store.current_slot += 1
            # a new slot always clears the previous slot's proposer boost
            # (reference onTick :1168-1171)
            self.proposer_boost_root = None
            if self.store.current_slot % self.slots_per_epoch == 0:
                self._on_epoch_boundary()
                self._process_queued_attestations()

    def _on_epoch_boundary(self) -> None:
        """Adopt held-back and unrealized checkpoints (reference onTick
        :1178-1201): best_justified first (bouncing-attack guard release),
        then any better unrealized justification/finalization."""
        s = self.store
        if (
            s.best_justified is not None
            and s.best_justified[0] > s.justified_checkpoint[0]
            and self._is_descendant_of_finalized(s.best_justified[1])
        ):
            s.justified_checkpoint = s.best_justified
            bal = self._resolve_justified_balances(
                s.best_justified, s.best_justified_balances
            )
            if bal is not None:
                s.justified_balances = bal
            self._justified_proposer_boost_score = None
        if s.unrealized_justified is not None and self._is_descendant_of_finalized(
            s.unrealized_justified[1]
        ):
            # same conflicting-fork guard as best_justified: the unrealized
            # max may come from a fork finalization has since orphaned
            self._update_checkpoints(
                s.unrealized_justified,
                s.unrealized_finalized,
                s.unrealized_justified_balances,
                state_slot=None,  # epoch boundary: adopt unconditionally
            )

    def _resolve_justified_balances(self, checkpoint, fallback):
        """Balances for the checkpoint's own state when the chain can
        provide them (checkpoint-state cache), else the caller's fallback."""
        if self.justified_balances_getter is not None:
            bal = self.justified_balances_getter(checkpoint)
            if bal is not None:
                return bal
        return fallback

    def _is_descendant_of_finalized(self, root: bytes) -> bool:
        fin_epoch, fin_root = self.store.finalized_checkpoint
        if fin_epoch == 0:
            return True
        fin_slot = fin_epoch * self.slots_per_epoch
        return self.proto.get_ancestor_at_slot(root, fin_slot) == fin_root

    def _current_epoch(self) -> int:
        return self.store.current_slot // self.slots_per_epoch

    # -- block import --------------------------------------------------------

    def on_block(
        self,
        slot: int,
        root: bytes,
        parent_root: bytes,
        state_root: bytes,
        justified_checkpoint: tuple[int, bytes],
        finalized_checkpoint: tuple[int, bytes],
        justified_balances: np.ndarray | None = None,
        execution_status: str = "pre_merge",
        unrealized_justified_checkpoint: tuple[int, bytes] | None = None,
        unrealized_finalized_checkpoint: tuple[int, bytes] | None = None,
        block_delay_sec: float | None = None,
    ) -> None:
        """Register an imported block (caller has fully verified it —
        reference onBlock precondition).

        `block_delay_sec` (arrival time minus slot start) drives the
        proposer boost: a block for the CURRENT slot arriving before the
        attesting interval (1/3 slot) gets the boost (reference
        forkChoice.ts:362-369)."""
        if parent_root not in self.proto.indices and len(self.proto.nodes) > 0:
            raise ForkChoiceError("unknown parent")

        if (
            self.proposer_boost_enabled
            and block_delay_sec is not None
            # non-negative: a block broadcast AHEAD of its slot (clock
            # disparity, or current_slot forced forward by the import
            # path) must not collect a free boost
            and 0 <= block_delay_sec < self.seconds_per_slot / INTERVALS_PER_SLOT
            and self.store.current_slot == slot
        ):
            self.proposer_boost_root = root

        self._update_checkpoints(
            justified_checkpoint,
            finalized_checkpoint,
            justified_balances,
            state_slot=slot,
        )

        uj = unrealized_justified_checkpoint or justified_checkpoint
        uf = unrealized_finalized_checkpoint or finalized_checkpoint
        s = self.store
        if s.unrealized_justified is None or uj[0] > s.unrealized_justified[0]:
            s.unrealized_justified = uj
            s.unrealized_justified_balances = (
                justified_balances
                if justified_balances is not None
                else s.justified_balances
            )
        if s.unrealized_finalized is None or uf[0] > s.unrealized_finalized[0]:
            s.unrealized_finalized = uf
        # a block from a PAST epoch pulls its unrealized checkpoints up
        # right away (reference forkChoice.ts:445-453)
        if slot // self.slots_per_epoch < self._current_epoch():
            self._update_checkpoints(uj, uf, justified_balances, state_slot=slot)

        self.proto.on_block(
            slot,
            root,
            parent_root if len(self.proto.nodes) > 0 else None,
            state_root,
            justified_checkpoint[0],
            finalized_checkpoint[0],
            execution_status,
            unrealized_justified_epoch=uj[0],
            unrealized_finalized_epoch=uf[0],
        )

    def _update_checkpoints(
        self,
        justified_checkpoint: tuple[int, bytes],
        finalized_checkpoint: tuple[int, bytes] | None,
        justified_balances: np.ndarray | None,
        state_slot: int | None,
    ) -> None:
        """Reference updateCheckpoints (forkChoice.ts:916+): a better
        justified checkpoint is adopted immediately only early in the
        epoch (bouncing-attack prevention, SAFE_SLOTS_TO_UPDATE_JUSTIFIED)
        — otherwise held in best_justified for the next epoch boundary.
        Finalization always advances, and forces the justified update."""
        s = self.store
        if justified_checkpoint[0] > s.justified_checkpoint[0]:
            if (
                s.best_justified is None
                or justified_checkpoint[0] > s.best_justified[0]
            ):
                s.best_justified = justified_checkpoint
                s.best_justified_balances = justified_balances
            in_safe_window = (
                state_slot is None
                or s.current_slot % self.slots_per_epoch
                < self.safe_slots_to_update_justified
            )
            if in_safe_window:
                s.justified_checkpoint = justified_checkpoint
                bal = self._resolve_justified_balances(
                    justified_checkpoint, justified_balances
                )
                if bal is not None:
                    s.justified_balances = bal
                self._justified_proposer_boost_score = None
        if (
            finalized_checkpoint is not None
            and finalized_checkpoint[0] > s.finalized_checkpoint[0]
        ):
            s.finalized_checkpoint = finalized_checkpoint
            if justified_checkpoint[0] > s.justified_checkpoint[0]:
                s.justified_checkpoint = justified_checkpoint
                bal = self._resolve_justified_balances(
                    justified_checkpoint, justified_balances
                )
                if bal is not None:
                    s.justified_balances = bal
                self._justified_proposer_boost_score = None

    # -- attestations --------------------------------------------------------

    def on_attestation(
        self,
        validator_indices: list[int],
        block_root: bytes,
        target_epoch: int,
    ) -> None:
        """Record LMD votes (caller validated the attestation). Future-epoch
        attestations queue until their epoch (reference queues by slot)."""
        if target_epoch > self._current_epoch():
            self._queued_attestations.append(
                (target_epoch, list(validator_indices), block_root, target_epoch)
            )
            return
        if block_root not in self.proto.indices:
            raise ForkChoiceError("attestation for unknown block")
        for v in validator_indices:
            if v in self._equivocating:
                continue
            prev_epoch = self._vote_next_epoch.get(v, -1)
            if target_epoch > prev_epoch:
                self._vote_next[v] = block_root
                self._vote_next_epoch[v] = target_epoch

    def on_attester_slashing(self, validator_indices: list[int]) -> None:
        """Equivocating validators stop counting (reference
        forkChoice.onAttesterSlashing)."""
        self._equivocating.update(validator_indices)

    def _process_queued_attestations(self) -> None:
        epoch = self._current_epoch()
        still: list = []
        for item in self._queued_attestations:
            if item[0] <= epoch:
                try:
                    self.on_attestation(item[1], item[2], item[3])
                except ForkChoiceError:
                    pass
            else:
                still.append(item)
        self._queued_attestations = still

    # -- head ----------------------------------------------------------------

    def _compute_deltas(self) -> np.ndarray:
        """Vectorized computeDeltas: subtract old-vote weight, add new-vote
        weight, per node — two bincounts over node indices."""
        n_nodes = len(self.proto.nodes)
        deltas = np.zeros(n_nodes, np.int64)
        old_bal = self._balances_used
        new_bal = self.store.justified_balances

        sub_idx, sub_w, add_idx, add_w = [], [], [], []
        for v, next_root in list(self._vote_next.items()):
            equiv = v in self._equivocating
            cur_root = self._vote_current_root.get(v)
            if cur_root is not None and cur_root in self.proto.indices:
                w = int(old_bal[v]) if v < len(old_bal) else 0
                sub_idx.append(self.proto.indices[cur_root])
                sub_w.append(w)
            if not equiv and next_root in self.proto.indices:
                w = int(new_bal[v]) if v < len(new_bal) else 0
                add_idx.append(self.proto.indices[next_root])
                add_w.append(w)
                self._vote_current_root[v] = next_root
            elif equiv:
                self._vote_current_root.pop(v, None)
                self._vote_next.pop(v, None)
        if sub_idx:
            deltas -= np.bincount(
                np.asarray(sub_idx), weights=np.asarray(sub_w), minlength=n_nodes
            ).astype(np.int64)
        if add_idx:
            deltas += np.bincount(
                np.asarray(add_idx), weights=np.asarray(add_w), minlength=n_nodes
            ).astype(np.int64)
        self._balances_used = new_bal.copy()
        return deltas

    def _compute_proposer_boost_score(self) -> int:
        """Boost = committee-weight-per-slot × PROPOSER_SCORE_BOOST%
        (reference computeProposerBoostScore, forkChoice.ts:1251-1263),
        cached until the justified balances change."""
        if self._justified_proposer_boost_score is None:
            bal = self.store.justified_balances
            total = int(bal[bal > 0].sum())
            committee_weight = total // self.slots_per_epoch
            self._justified_proposer_boost_score = (
                committee_weight * self.proposer_score_boost
            ) // 100
        return self._justified_proposer_boost_score

    def update_head(self) -> bytes:
        """Apply pending vote deltas, refresh scores, walk to head
        (reference updateHead :184)."""
        deltas = self._compute_deltas()
        boost = None
        if self.proposer_boost_enabled and self.proposer_boost_root is not None:
            boost = (self.proposer_boost_root, self._compute_proposer_boost_score())
        self.proto.apply_score_changes(
            deltas,
            self.store.justified_checkpoint[0],
            self.store.finalized_checkpoint[0],
            proposer_boost=boost,
            current_slot=self.store.current_slot,
        )
        self.head_root = self.proto.find_head(self.store.justified_checkpoint[1])
        return self.head_root

    def get_proposer_boost_root(self) -> bytes | None:
        return self.proposer_boost_root

    # -- queries -------------------------------------------------------------

    def get_ancestor(self, root: bytes, slot: int) -> bytes | None:
        return self.proto.get_ancestor_at_slot(root, slot)

    def has_block(self, root: bytes) -> bool:
        return root in self.proto.indices

    def prune(self) -> None:
        self.proto.maybe_prune(self.store.finalized_checkpoint[1])

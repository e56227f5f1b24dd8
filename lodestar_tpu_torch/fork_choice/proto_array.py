"""Proto-array: the flat DAG behind LMD-GHOST head selection.

Reference behavior: `fork-choice/src/protoArray/protoArray.ts` —
append-only node list in insertion (topological) order; weights updated by
a single backward pass (`applyScoreChanges` :91), head found by walking
best-descendant links (`findHead` :455). Re-derived from the original
proto_array design; this implementation keeps weights/deltas in numpy
int64 arrays so score application is array math plus one sequential
parent-accumulation pass.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ProtoNode:
    slot: int
    root: bytes
    parent: int | None          # index into nodes
    state_root: bytes
    justified_epoch: int
    finalized_epoch: int
    # what the checkpoints would be if the block's epoch ended at import
    # time (reference protoArray/interface.ts:71-74); used by the
    # viability filter for blocks from prior epochs
    unrealized_justified_epoch: int = 0
    unrealized_finalized_epoch: int = 0
    # execution status is tracked for bellatrix+ (optimistic sync);
    # "valid" for pre-merge blocks
    execution_status: str = "pre_merge"  # pre_merge | valid | syncing | invalid
    best_child: int | None = None
    best_descendant: int | None = None


class ProtoArrayError(ValueError):
    pass


class ProtoArray:
    def __init__(
        self,
        justified_epoch: int,
        finalized_epoch: int,
        slots_per_epoch: int = 32,
    ):
        self.nodes: list[ProtoNode] = []
        self.indices: dict[bytes, int] = {}
        self.weights = np.zeros(0, np.int64)
        self.justified_epoch = justified_epoch
        self.finalized_epoch = finalized_epoch
        self.slots_per_epoch = slots_per_epoch
        self.current_slot = 0  # refreshed by apply_score_changes
        # boost applied in the previous score pass, to back out before
        # applying this pass's boost (reference previousProposerBoost)
        self.previous_proposer_boost: tuple[bytes, int] | None = None
        self.prune_threshold = 256

    # -- insertion -----------------------------------------------------------

    def on_block(
        self,
        slot: int,
        root: bytes,
        parent_root: bytes | None,
        state_root: bytes,
        justified_epoch: int,
        finalized_epoch: int,
        execution_status: str = "pre_merge",
        unrealized_justified_epoch: int | None = None,
        unrealized_finalized_epoch: int | None = None,
    ) -> None:
        if root in self.indices:
            return
        parent = self.indices.get(parent_root) if parent_root is not None else None
        node_idx = len(self.nodes)
        self.nodes.append(
            ProtoNode(
                slot=slot,
                root=root,
                parent=parent,
                state_root=state_root,
                justified_epoch=justified_epoch,
                finalized_epoch=finalized_epoch,
                unrealized_justified_epoch=(
                    unrealized_justified_epoch
                    if unrealized_justified_epoch is not None
                    else justified_epoch
                ),
                unrealized_finalized_epoch=(
                    unrealized_finalized_epoch
                    if unrealized_finalized_epoch is not None
                    else finalized_epoch
                ),
                execution_status=execution_status,
            )
        )
        self.indices[root] = node_idx
        self.weights = np.append(self.weights, np.int64(0))
        if parent is not None:
            self._maybe_update_best_child_and_descendant(parent, node_idx)

    # -- scoring -------------------------------------------------------------

    def apply_score_changes(
        self,
        deltas: np.ndarray,
        justified_epoch: int,
        finalized_epoch: int,
        proposer_boost: tuple[bytes, int] | None = None,
        current_slot: int | None = None,
    ) -> None:
        """deltas: (len(nodes),) int64 — per-node vote weight change.
        proposer_boost: (block_root, score) for this pass — the previous
        pass's boost is backed out automatically (reference
        protoArray.ts:145-148 currentBoost/previousBoost).

        TWO backward passes, as in the reference (protoArray.ts
        applyScoreChanges): first apply every weight and back-propagate
        child deltas to parents; only then refresh best-child/descendant
        links — sibling comparisons must see a fully coherent weight set,
        or a best child losing weight keeps its crown against an
        already-visited heavier sibling."""
        if len(deltas) != len(self.nodes):
            raise ProtoArrayError("delta/node length mismatch")
        self.justified_epoch = justified_epoch
        self.finalized_epoch = finalized_epoch
        if current_slot is not None:
            self.current_slot = current_slot

        deltas = deltas.astype(np.int64).copy()
        # fold boosts into the deltas up front (one dict lookup each, not a
        # root comparison per node); the invalid-node override below still
        # discards them on an invalidated node
        if proposer_boost is not None:
            idx = self.indices.get(proposer_boost[0])
            if idx is not None:
                deltas[idx] += proposer_boost[1]
        if self.previous_proposer_boost is not None:
            idx = self.indices.get(self.previous_proposer_boost[0])
            if idx is not None:
                deltas[idx] -= self.previous_proposer_boost[1]
        for i in range(len(self.nodes) - 1, -1, -1):
            node = self.nodes[i]
            if node.execution_status == "invalid":
                deltas[i] = -int(self.weights[i])
            self.weights[i] += deltas[i]
            if self.weights[i] < 0:
                raise ProtoArrayError(f"negative node weight at {i}")
            if node.parent is not None:
                deltas[node.parent] += deltas[i]
        for i in range(len(self.nodes) - 1, -1, -1):
            parent = self.nodes[i].parent
            if parent is not None:
                self._maybe_update_best_child_and_descendant(parent, i)
        self.previous_proposer_boost = proposer_boost

    # -- head selection ------------------------------------------------------

    def find_head(self, justified_root: bytes) -> bytes:
        idx = self.indices.get(justified_root)
        if idx is None:
            raise ProtoArrayError("justified root unknown to proto array")
        node = self.nodes[idx]
        best = node.best_descendant if node.best_descendant is not None else idx
        head = self.nodes[best]
        if not self._node_is_viable_for_head(head):
            raise ProtoArrayError("best descendant not viable for head")
        return head.root

    def _node_is_viable_for_head(self, node: ProtoNode) -> bool:
        """filter_block_tree equivalent (reference protoArray.ts:733-763):
        blocks from a PREVIOUS epoch are judged on their unrealized
        checkpoints — a tip that would justify the store's checkpoint if
        its epoch ended now must stay viable, or every late-epoch fork
        tip gets filtered and head selection can dead-end."""
        if node.execution_status == "invalid":
            return False
        current_epoch = self.current_slot // self.slots_per_epoch
        from_prev_epoch = node.slot // self.slots_per_epoch < current_epoch
        j = node.unrealized_justified_epoch if from_prev_epoch else node.justified_epoch
        f = node.unrealized_finalized_epoch if from_prev_epoch else node.finalized_epoch
        return (j == self.justified_epoch or self.justified_epoch == 0) and (
            f == self.finalized_epoch or self.finalized_epoch == 0
        )

    def _node_leads_to_viable_head(self, node: ProtoNode) -> bool:
        if node.best_descendant is not None:
            return self._node_is_viable_for_head(self.nodes[node.best_descendant])
        return self._node_is_viable_for_head(node)

    def _maybe_update_best_child_and_descendant(self, parent_idx: int, child_idx: int):
        child = self.nodes[child_idx]
        parent = self.nodes[parent_idx]
        child_leads = self._node_leads_to_viable_head(child)
        child_best = (
            child.best_descendant if child.best_descendant is not None else child_idx
        )

        if parent.best_child == child_idx:
            if not child_leads:
                self._change_to_none(parent_idx)
            else:
                parent.best_descendant = child_best
        elif child_leads:
            if parent.best_child is None:
                parent.best_child = child_idx
                parent.best_descendant = child_best
            else:
                current_best = self.nodes[parent.best_child]
                current_leads = self._node_leads_to_viable_head(current_best)
                cb_idx = (
                    current_best.best_descendant
                    if current_best.best_descendant is not None
                    else parent.best_child
                )
                if not current_leads:
                    parent.best_child = child_idx
                    parent.best_descendant = child_best
                else:
                    cw = self.weights[child_idx]
                    bw = self.weights[parent.best_child]
                    # tie-break on root bytes (deterministic, matches the
                    # ≥ semantics: later-inserted equal-weight wins via >=)
                    if cw > bw or (
                        cw == bw and child.root >= current_best.root
                    ):
                        parent.best_child = child_idx
                        parent.best_descendant = child_best

    def _change_to_none(self, parent_idx: int) -> None:
        self.nodes[parent_idx].best_child = None
        self.nodes[parent_idx].best_descendant = None

    # -- queries -------------------------------------------------------------

    def __contains__(self, root: bytes) -> bool:
        return root in self.indices

    def get_node(self, root: bytes) -> ProtoNode | None:
        idx = self.indices.get(root)
        return self.nodes[idx] if idx is not None else None

    def is_descendant(self, ancestor_root: bytes, descendant_root: bytes) -> bool:
        a = self.indices.get(ancestor_root)
        d = self.indices.get(descendant_root)
        if a is None or d is None:
            return False
        a_slot = self.nodes[a].slot
        idx: int | None = d
        while idx is not None and self.nodes[idx].slot >= a_slot:
            if idx == a:
                return True
            idx = self.nodes[idx].parent
        return False

    def get_ancestor_at_slot(self, root: bytes, slot: int) -> bytes | None:
        idx = self.indices.get(root)
        while idx is not None:
            node = self.nodes[idx]
            if node.slot <= slot:
                return node.root
            idx = node.parent
        return None

    def iter_ancestors(self, root: bytes):
        idx = self.indices.get(root)
        while idx is not None:
            node = self.nodes[idx]
            yield node
            idx = node.parent

    # -- pruning -------------------------------------------------------------

    def maybe_prune(self, finalized_root: bytes) -> list[ProtoNode]:
        """Drop everything before the finalized node (reference maybePrune:
        only when the prefix exceeds pruneThreshold, to amortize)."""
        fin_idx = self.indices.get(finalized_root)
        if fin_idx is None:
            raise ProtoArrayError("finalized root unknown")
        if fin_idx < self.prune_threshold:
            return []
        removed = self.nodes[:fin_idx]
        self.nodes = self.nodes[fin_idx:]
        self.weights = self.weights[fin_idx:].copy()
        for node in removed:
            del self.indices[node.root]
        for root in list(self.indices):
            self.indices[root] -= fin_idx
        for node in self.nodes:
            node.parent = (
                node.parent - fin_idx
                if node.parent is not None and node.parent >= fin_idx
                else None
            )
            node.best_child = (
                node.best_child - fin_idx
                if node.best_child is not None and node.best_child >= fin_idx
                else None
            )
            node.best_descendant = (
                node.best_descendant - fin_idx
                if node.best_descendant is not None and node.best_descendant >= fin_idx
                else None
            )
        return removed


    # -- optimistic sync (execution status transitions) ----------------------

    def set_execution_valid(self, root: bytes) -> None:
        """VALID from the EL: this block and every SYNCING ancestor payload
        is valid (reference protoArray validateLatestHash upward walk).
        Never resurrects an 'invalid' node — a contradictory EL signal is
        ignored rather than re-enabling an EL-rejected branch."""
        idx = self.indices.get(root)
        if idx is None:
            return
        node = self.nodes[idx]
        if node.execution_status == "invalid":
            return
        if node.execution_status == "syncing":
            node.execution_status = "valid"
        # ancestors: an EL-valid payload transitively validates every
        # optimistically imported (syncing) ancestor payload
        idx = node.parent
        while idx is not None and self.nodes[idx].execution_status == "syncing":
            self.nodes[idx].execution_status = "valid"
            idx = self.nodes[idx].parent

    def invalidate_payloads(self, head_root: bytes, latest_valid_root: bytes | None) -> list[bytes]:
        """INVALID from the EL with a latest-valid-hash: every block from
        `head_root` back to (exclusive) `latest_valid_root` is invalid,
        and every DESCENDANT of an invalidated block is too (reference
        protoArray invalidation walk for engine INVALID + LVH).

        Returns the invalidated roots. Weights are corrected on the next
        apply_score_changes pass (the invalid override zeroes them)."""
        start = self.indices.get(head_root)
        if start is None:
            return []
        if latest_valid_root is not None:
            # a stale/faulty EL can report an LVH that is NOT on the head's
            # ancestor path; walking until we "hit" it would invalidate the
            # whole optimistic chain back to the last validated block. Verify
            # ancestry first — off-path LVH degrades to the no-LVH behavior
            # (invalidate only the offending payload).
            idx: int | None = start
            on_path = False
            while idx is not None:
                node = self.nodes[idx]
                if node.root == latest_valid_root:
                    on_path = True
                    break
                if node.execution_status in ("pre_merge", "valid"):
                    break
                idx = node.parent
            if not on_path:
                latest_valid_root = None
        bad: set[int] = set()
        idx = start
        while idx is not None:
            node = self.nodes[idx]
            if latest_valid_root is not None and node.root == latest_valid_root:
                break
            if node.execution_status in ("pre_merge", "valid"):
                # never cross an EL-validated (or pre-merge) block: an
                # LVH that is off this ancestor path, stale, or malicious
                # must not invalidate the whole chain
                break
            bad.add(idx)
            node.execution_status = "invalid"
            if latest_valid_root is None:
                break  # no LVH: only the head payload is known-bad
            idx = node.parent
        # descendants of any invalidated node are unreachable-valid
        for i, node in enumerate(self.nodes):
            if node.parent in bad and i not in bad:
                bad.add(i)
                node.execution_status = "invalid"
        # drop best-child links that point into the invalid set
        for node in self.nodes:
            if node.best_child in bad:
                node.best_child = None
            if node.best_descendant in bad:
                node.best_descendant = None
        return [self.nodes[i].root for i in sorted(bad)]

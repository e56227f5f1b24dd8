"""Backfill sync: repopulate history below a checkpoint anchor.

Reference: `sync/backfill/backfill.ts:106` + `verify.ts` — after
checkpoint (weak-subjectivity) sync, walk BACKWARD from the anchor to
genesis: batches are validated by hash-chain linkage (child.parent_root
== parent root) and proposer signatures verified in one batched dispatch
per segment (no state transition — the anchor state's registry provides
pubkeys since the registry is append-only).
"""

from __future__ import annotations

from ..bls import api as bls
from ..config.beacon_config import compute_signing_root
from ..params import DOMAIN_BEACON_PROPOSER
from .peer import IPeer, PeerError

BACKFILL_BATCH_SLOTS = 64


class BackfillError(Exception):
    pass


class BackfillSync:
    def __init__(
        self, config, types, db, anchor_block, anchor_state, verifier,
        terminal_root: bytes | None = None, metrics=None,
    ):
        """`anchor_block`: trusted signed block (checkpoint); `anchor_state`
        its post state (pubkey registry); `verifier`: IBlsVerifier;
        `terminal_root`: the genesis block root — backfill is complete when
        the linkage reaches it (None: complete when the slot-1 window is
        exhausted)."""
        self.config = config
        self.types = types
        self.db = db
        self.verifier = verifier
        self.metrics = metrics
        self.anchor = anchor_block
        self.terminal_root = terminal_root
        self._pubkeys = [bytes(v.pubkey) for v in anchor_state.validators]
        self.peers: list[IPeer] = []
        self.oldest_slot = anchor_block.message.slot
        self._expected_parent = bytes(anchor_block.message.parent_root)

    def add_peer(self, peer: IPeer) -> None:
        self.peers.append(peer)

    # -- verification (reference backfill/verify.ts) -------------------------

    def _verify_segment(self, blocks: list) -> None:
        """Blocks ascending by slot, ending at the current backfill head:
        linkage + batched proposer signatures."""
        # hash-chain linkage up to the known oldest block
        expected = self._expected_parent
        for signed in reversed(blocks):
            root = signed.message.hash_tree_root()
            if root != expected:
                raise BackfillError(
                    f"linkage broken at slot {signed.message.slot}: "
                    f"{root.hex()[:12]} != {expected.hex()[:12]}"
                )
            expected = bytes(signed.message.parent_root)
        # batched proposer signature verification
        sets = []
        for signed in blocks:
            msg = signed.message
            if msg.proposer_index >= len(self._pubkeys):
                raise BackfillError("proposer index beyond anchor registry")
            domain = self.config.get_domain(DOMAIN_BEACON_PROPOSER, msg.slot)
            sets.append(
                bls.SignatureSet(
                    pubkey=bls.PublicKey.from_bytes(
                        self._pubkeys[msg.proposer_index], validate=False
                    ),
                    message=compute_signing_root(msg.hash_tree_root(), domain),
                    signature=bytes(signed.signature),
                )
            )
        if sets and not self.verifier.verify_signature_sets(sets):
            raise BackfillError("backfill segment signature verification failed")

    # -- driving -------------------------------------------------------------

    def sync_to_genesis(self) -> int:
        """Backfill until the linkage reaches the terminal (genesis) root,
        or the slot-1 window is exhausted; returns archived block count."""
        archived = 0
        while self.oldest_slot > 1 and self._expected_parent != self.terminal_root:
            start = max(1, self.oldest_slot - BACKFILL_BATCH_SLOTS)
            count = self.oldest_slot - start
            blocks = self._download_verified(start, count)
            m = getattr(self, "metrics", None)
            if m is not None:
                m.backfill_batches_total.inc(
                    outcome="verified" if blocks else "empty"
                )
                m.backfill_slot.set(self.oldest_slot)
            if not blocks:
                if start == 1:
                    break  # chain has no blocks below oldest_slot — done
                raise BackfillError(f"no blocks available below {self.oldest_slot}")
            for signed in blocks:
                self.db.archive_block(signed)
                archived += 1
            self.oldest_slot = blocks[0].message.slot
            self._expected_parent = bytes(blocks[0].message.parent_root)
        # an empty final window is only complete if the linkage actually
        # reached the terminal root — otherwise a peer served a lying empty
        # response over an unreachable hole
        if (
            self.terminal_root is not None
            and self._expected_parent != self.terminal_root
        ):
            raise BackfillError(
                f"backfill incomplete: linkage stopped at "
                f"{self._expected_parent.hex()[:12]}, terminal "
                f"{self.terminal_root.hex()[:12]} not reached"
            )
        return archived

    def _download_verified(self, start: int, count: int) -> list:
        """Download + verify one batch, rotating peers on EITHER transport
        failure or verification failure — one bad peer must not brick
        backfill while honest peers remain (reference: batch retries with
        peer rotation)."""
        transport_err: Exception | None = None
        verify_err: Exception | None = None
        served_empty = False
        for peer in self.peers:
            try:
                blocks = peer.beacon_blocks_by_range(start, count)
            except PeerError as e:
                transport_err = e
                continue
            if not blocks:
                served_empty = True
                continue
            try:
                self._verify_segment(blocks)
                return blocks
            except BackfillError as e:
                verify_err = e
        # a verification failure is stronger evidence than an empty reply:
        # some peer HAS blocks for this range, so don't accept emptiness
        if verify_err is not None:
            raise BackfillError(str(verify_err))
        if served_empty:
            return []  # every responsive peer confirms the range is empty
        if transport_err is not None:
            raise BackfillError(str(transport_err))
        return []

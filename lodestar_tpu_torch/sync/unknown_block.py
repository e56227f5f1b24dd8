"""Unknown-block sync: resolve unknown parent chains by root.

Reference: `sync/unknownBlock.ts:26` — when gossip delivers a block (or an
attestation references a root) whose ancestry is unknown, walk parents
backward via beacon_blocks_by_root until connecting to the known chain,
then import forward."""

from __future__ import annotations

from .peer import IPeer, PeerError

MAX_PARENT_CHAIN = 32


class UnknownBlockSyncError(Exception):
    pass


class UnknownBlockSync:
    def __init__(self, chain, types):
        self.chain = chain
        self.types = types
        self.peers: list[IPeer] = []

    def add_peer(self, peer: IPeer) -> None:
        self.peers.append(peer)

    def resolve(self, signed_block, verify_signatures: bool = True) -> bytes:
        """Import `signed_block`, fetching unknown ancestors first.
        Returns the imported block root."""
        pending = [signed_block]
        seen = {signed_block.message.hash_tree_root()}
        while True:
            parent_root = bytes(pending[-1].message.parent_root)
            if parent_root in self.chain.blocks or parent_root in self.chain.finalized_blocks:
                break
            if len(pending) >= MAX_PARENT_CHAIN:
                raise UnknownBlockSyncError("parent chain too long")
            fetched = self._fetch_by_root(parent_root)
            if fetched is None:
                raise UnknownBlockSyncError(
                    f"no peer has parent {parent_root.hex()}"
                )
            root = fetched.message.hash_tree_root()
            if root != parent_root or root in seen:
                raise UnknownBlockSyncError("peer returned wrong/duplicate block")
            seen.add(root)
            pending.append(fetched)
        for signed in reversed(pending):
            self.chain.process_block(signed, verify_signatures=verify_signatures)
        return signed_block.message.hash_tree_root()

    def _fetch_by_root(self, root: bytes):
        for peer in self.peers:
            try:
                got = peer.beacon_blocks_by_root([root])
            except PeerError:
                continue
            if got:
                return got[0]
        return None

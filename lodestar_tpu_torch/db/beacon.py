"""BeaconDb: the typed repositories a beacon node persists.

Reference: `beacon-node/src/db/beacon.ts` + `db/repositories/` — block,
blockArchive (slot-indexed with root indices), stateArchive, eth1 data,
light-client buckets."""

from __future__ import annotations

from .controller import IDatabaseController, MemoryDb
from .repository import Bucket, Repository


class BeaconDb:
    def __init__(self, types, db: IDatabaseController | None = None):
        self.db = db if db is not None else MemoryDb()
        t = types
        # hot blocks by root
        self.block = Repository(self.db, Bucket.allForks_block, t.SignedBeaconBlock.ssz_type)
        # finalized blocks by slot (ordered) + root→slot index
        self.block_archive = Repository(
            self.db, Bucket.allForks_blockArchive, t.SignedBeaconBlock.ssz_type
        )
        self._block_archive_root_index = Repository(
            self.db, Bucket.index_blockArchiveRootIndex, _BytesType()
        )
        # finalized states by slot
        self.state_archive = Repository(
            self.db, Bucket.allForks_stateArchive, t.BeaconState.ssz_type
        )
        self.eth1_data = Repository(self.db, Bucket.phase0_eth1Data, t.Eth1Data.ssz_type)

    # -- block archive helpers (reference blockArchive repo dual-index) ------

    def archive_block(self, signed_block) -> None:
        slot_key = Repository.slot_key(signed_block.message.slot)
        self.block_archive.put(slot_key, signed_block)
        self._block_archive_root_index.put(
            signed_block.message.hash_tree_root(), slot_key
        )

    def get_archived_block_by_root(self, root: bytes):
        slot_key = self._block_archive_root_index.get(root)
        if slot_key is None:
            return None
        return self.block_archive.get(slot_key)

    def close(self) -> None:
        self.db.close()


class _BytesType:
    @staticmethod
    def serialize(v: bytes) -> bytes:
        return v

    @staticmethod
    def deserialize(v: bytes) -> bytes:
        return v

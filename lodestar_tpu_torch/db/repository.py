"""Bucket-prefixed typed repositories.

Reference: `db/src/schema.ts:5-70` (Bucket enum — numeric prefixes
namespacing each repository inside one KV store) + `abstractRepository.ts`
(`Repository<Id, T>`: SSZ encode/decode at the boundary, batch ops, key
streaming)."""

from __future__ import annotations

from enum import IntEnum
from typing import Generic, Iterator, TypeVar

T = TypeVar("T")


class Bucket(IntEnum):
    # mirrors the reference's bucket ids where meaningful (schema.ts)
    allForks_stateArchive = 0
    allForks_block = 1
    allForks_blockArchive = 2
    index_blockArchiveParentRootIndex = 3
    index_blockArchiveRootIndex = 4
    phase0_eth1Data = 6
    index_depositDataRoot = 7
    phase0_depositEvent = 8
    phase0_preGenesisState = 30
    phase0_preGenesisStateLastProcessedBlock = 31
    # validator / slashing protection (20-24 reference range)
    validator_metaData = 41
    validator_slashingProtectionBlockBySlot = 20
    validator_slashingProtectionAttestationByTarget = 21
    validator_slashingProtectionAttestationLowerBound = 22
    validator_slashingProtectionMinSpanDistance = 23
    validator_slashingProtectionMaxSpanDistance = 24
    # light client server
    lightClient_syncCommitteeWitness = 51
    lightClient_syncCommittee = 52
    lightClient_checkpointHeader = 54
    lightClient_bestLightClientUpdate = 55
    backfilled_ranges = 42


def _encode_key(bucket: int, key: bytes) -> bytes:
    return bucket.to_bytes(1, "big") + key


class Repository(Generic[T]):
    """SSZ-typed repository over one bucket. `ssz_type` must expose
    serialize/deserialize (any SSZType); ids are raw bytes (roots) or
    uint64-BE slots for ordered range scans."""

    # class-level op counters by (bucket, op) — the reference records
    # per-repository db operation metrics (db pkg "per-op metrics") that
    # feed lodestar_db_* families; exposed via snapshot_op_metrics()
    _op_counts: dict[tuple[int, str], int] = {}

    def __init__(self, db, bucket: Bucket, ssz_type):
        self.db = db
        self.bucket = int(bucket)
        self.type = ssz_type

    def _count(self, op: str) -> None:
        key = (self.bucket, op)
        Repository._op_counts[key] = Repository._op_counts.get(key, 0) + 1

    @classmethod
    def snapshot_op_metrics(cls) -> dict[tuple[int, str], int]:
        return dict(cls._op_counts)

    # -- keys ----------------------------------------------------------------

    def _key(self, id_: bytes) -> bytes:
        return _encode_key(self.bucket, id_)

    @staticmethod
    def slot_key(slot: int) -> bytes:
        return slot.to_bytes(8, "big")

    # -- ops -----------------------------------------------------------------

    def get(self, id_: bytes) -> T | None:
        self._count("get")
        raw = self.db.get(self._key(id_))
        return self.type.deserialize(raw) if raw is not None else None

    def get_binary(self, id_: bytes) -> bytes | None:
        return self.db.get(self._key(id_))

    def has(self, id_: bytes) -> bool:
        return self.db.get(self._key(id_)) is not None

    def put(self, id_: bytes, value: T) -> None:
        self._count("put")
        self.db.put(self._key(id_), self.type.serialize(value))

    def put_binary(self, id_: bytes, raw: bytes) -> None:
        self.db.put(self._key(id_), raw)

    def delete(self, id_: bytes) -> None:
        self._count("delete")
        self.db.delete(self._key(id_))

    def batch_put(self, items: list[tuple[bytes, T]]) -> None:
        self._count("batch_put")
        self.db.batch_put(
            [(self._key(i), self.type.serialize(v)) for i, v in items]
        )

    def batch_delete(self, ids: list[bytes]) -> None:
        for i in ids:
            self.delete(i)

    # -- streams -------------------------------------------------------------

    def _range(self) -> tuple[bytes, bytes]:
        return _encode_key(self.bucket, b""), _encode_key(self.bucket + 1, b"")

    def keys_stream(self) -> Iterator[bytes]:
        gte, lt = self._range()
        for k in self.db.keys_stream(gte, lt):
            yield k[1:]

    def values_stream(self) -> Iterator[T]:
        gte, lt = self._range()
        for v in self.db.values_stream(gte, lt):
            yield self.type.deserialize(v)

    def first_key(self) -> bytes | None:
        for k in self.keys_stream():
            return k
        return None

    def last_key(self) -> bytes | None:
        last = None
        for k in self.keys_stream():
            last = k
        return last

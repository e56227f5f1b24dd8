"""Database controllers: ordered KV stores.

`MemoryDb` — sorted-dict semantics over a plain dict (tests, sim).
`FileDb` — crash-tolerant append-only log with periodic compaction and an
in-memory index: the LSM idea of LevelDB reduced to its minimum viable
form in stdlib Python (reference's native leveldown → SURVEY.md §2.3;
a full C++ LSM engine is a later tier — the interface won't change).
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, Protocol


class IDatabaseController(Protocol):
    def get(self, key: bytes) -> bytes | None: ...
    def put(self, key: bytes, value: bytes) -> None: ...
    def delete(self, key: bytes) -> None: ...
    def batch_put(self, items: list[tuple[bytes, bytes]]) -> None: ...
    def keys_stream(self, gte: bytes, lt: bytes) -> Iterator[bytes]: ...
    def values_stream(self, gte: bytes, lt: bytes) -> Iterator[bytes]: ...
    def close(self) -> None: ...


class MemoryDb:
    def __init__(self):
        self._data: dict[bytes, bytes] = {}

    def get(self, key: bytes) -> bytes | None:
        return self._data.get(key)

    def put(self, key: bytes, value: bytes) -> None:
        self._data[key] = value

    def delete(self, key: bytes) -> None:
        self._data.pop(key, None)

    def batch_put(self, items) -> None:
        for k, v in items:
            self._data[k] = v

    def keys_stream(self, gte: bytes, lt: bytes):
        for k in sorted(self._data):
            if gte <= k < lt:
                yield k

    def values_stream(self, gte: bytes, lt: bytes):
        for k in self.keys_stream(gte, lt):
            yield self._data[k]

    def entries_stream(self, gte: bytes, lt: bytes):
        for k in self.keys_stream(gte, lt):
            yield k, self._data[k]

    def close(self) -> None:
        pass


_REC = struct.Struct("<BII")  # op, key_len, value_len


class FileDb(MemoryDb):
    """Append-only log + in-memory index. Every put/delete appends a
    record; open() replays the log; compact() rewrites it. Durable across
    restarts (fsync on batch boundaries)."""

    COMPACT_WASTE_RATIO = 4

    def __init__(self, path: str):
        self.metrics = None  # set by the node for compaction counters
        super().__init__()
        self.path = path
        self._ops = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if os.path.exists(path):
            self._replay()
        self._fh = open(path, "ab")

    def _replay(self) -> None:
        with open(self.path, "rb") as fh:
            while True:
                head = fh.read(_REC.size)
                if len(head) < _REC.size:
                    break
                op, klen, vlen = _REC.unpack(head)
                key = fh.read(klen)
                value = fh.read(vlen)
                if len(key) < klen or len(value) < vlen:
                    break  # torn tail record: ignore (crash tolerance)
                if op == 0:
                    self._data[key] = value
                else:
                    self._data.pop(key, None)
                self._ops += 1

    def _append(self, op: int, key: bytes, value: bytes) -> None:
        self._fh.write(_REC.pack(op, len(key), len(value)))
        self._fh.write(key)
        self._fh.write(value)
        self._ops += 1

    def put(self, key: bytes, value: bytes) -> None:
        super().put(key, value)
        self._append(0, key, value)
        self._fh.flush()

    def delete(self, key: bytes) -> None:
        super().delete(key)
        self._append(1, key, b"")
        self._fh.flush()

    def batch_put(self, items) -> None:
        for k, v in items:
            super().put(k, v)
            self._append(0, k, v)
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._maybe_compact()

    def _maybe_compact(self) -> None:
        if self._ops > self.COMPACT_WASTE_RATIO * max(64, len(self._data)):
            self.compact()
            m = getattr(self, "metrics", None)
            if m is not None:
                m.db_compactions_total.inc()

    def compact(self) -> None:
        tmp = self.path + ".compact"
        with open(tmp, "wb") as fh:
            for k, v in self._data.items():
                fh.write(_REC.pack(0, len(k), len(v)))
                fh.write(k)
                fh.write(v)
            fh.flush()
            os.fsync(fh.fileno())
        self._fh.close()
        os.replace(tmp, self.path)
        self._fh = open(self.path, "ab")
        self._ops = len(self._data)

    def close(self) -> None:
        self._fh.close()

"""Incremental merkleization: cached chunk trees with dirty-path rehashing.

The reference backs every beacon state with a persistent merkle tree
(`@chainsafe/ssz` ViewDU; `stateTransition.ts:69-74` ends in
commit+hashTreeRoot per block) precisely because a full-tree recompute at
mainnet size is minutes. Here the same role is played columnar-style: the
hot state fields already live in flat numpy arrays
(`state_transition/cache.FlatValidators`), so instead of object-graph
dirty tracking the tree DIFFS its leaf array against the previous call —
one vectorized compare (O(n) bytes, no hashing) finds the dirty chunks,
and only their root paths re-hash (O(dirty · log n) SHA-256 pairs through
the native batched `sha256_level`).

`ChunkTree` is the building block: a merkle tree over a growable array of
32-byte chunks with a fixed virtual limit (spec `merkleize(chunks, limit)`
semantics, zero-subtree padding). `hash_tree_root` output is
bit-identical to `hashing.merkleize_chunks` — differential-tested.
"""

from __future__ import annotations

import numpy as np

from .hashing import ZERO_HASHES, next_power_of_two
from . import hashing as _hashing

_ZERO_ROWS = [np.frombuffer(z, np.uint8) for z in ZERO_HASHES]


def _hash_rows(pairs: np.ndarray) -> np.ndarray:
    """(k, 64) uint8 sibling pairs → (k, 32) uint8 parents via the
    pluggable (native-batched) level hasher."""
    out = _hashing._backend_hash_level(pairs.tobytes())
    return np.frombuffer(out, np.uint8).reshape(-1, 32)


def rows_ne(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(n, 32) uint8 row-wise inequality as (n,) bool — compared through a
    uint64 view (4 words/row) instead of 32 byte lanes: at mainnet sizes
    the naive `(a != b).any(1)` byte compare is the dominant per-call cost
    of the whole incremental hasher (measured 80 ms per million rows)."""
    n = len(a)
    if n == 0:
        return np.zeros(0, bool)
    av = np.ascontiguousarray(a).view(np.uint64).reshape(n, 4)
    bv = np.ascontiguousarray(b).view(np.uint64).reshape(n, 4)
    return np.any(av != bv, axis=1)


class ChunkTree:
    """Merkle tree over ≤ `limit` 32-byte chunks with cached levels.

    `update(leaves)` adopts a new (n, 32) uint8 leaf array: unchanged
    chunks (vs the previous call) cost one vectorized compare; changed and
    appended chunks re-hash only their root paths. Shrinking rebuilds (the
    big consensus lists are append-only; small ones are cheap anyway).
    """

    __slots__ = ("limit", "depth", "levels", "_top")

    def __init__(self, limit_chunks: int):
        self.limit = limit_chunks
        self.depth = (next_power_of_two(max(limit_chunks, 1)) - 1).bit_length()
        self.levels: list[np.ndarray] | None = None
        self._top: bytes | None = None

    # -- internals ----------------------------------------------------------

    def _level_sizes(self, n: int) -> list[int]:
        """Real node count per level, leaves upward, until one node."""
        sizes = [n]
        while sizes[-1] > 1:
            sizes.append((sizes[-1] + 1) // 2)
        return sizes

    def _hash_parents(self, lvl: np.ndarray, idx: np.ndarray, d: int) -> np.ndarray:
        """Hash the `idx` parents of level-d array `lvl` → (k, 32)."""
        n = len(lvl)
        left = lvl[2 * idx]
        right_idx = 2 * idx + 1
        right = np.where(
            (right_idx < n)[:, None],
            lvl[np.minimum(right_idx, n - 1)],
            _ZERO_ROWS[d][None, :],
        )
        return _hash_rows(np.concatenate([left, right], axis=1))

    def _rebuild(self, leaves: np.ndarray) -> None:
        sizes = self._level_sizes(len(leaves))
        levels = [leaves]
        for d in range(len(sizes) - 1):
            idx = np.arange(sizes[d + 1])
            levels.append(self._hash_parents(levels[d], idx, d))
        self.levels = levels
        self._top = None

    # -- public -------------------------------------------------------------

    def update(self, leaves: np.ndarray) -> None:
        """Adopt a new leaf array ((n, 32) uint8, n ≤ limit)."""
        if leaves.ndim != 2 or leaves.shape[1] != 32:
            raise ValueError("leaves must be (n, 32)")
        if len(leaves) > self.limit:
            raise ValueError(f"chunk count {len(leaves)} exceeds limit {self.limit}")
        leaves = np.ascontiguousarray(leaves, dtype=np.uint8)

        # NOTE on aliasing: callers may hand a view of a buffer they mutate
        # in place between calls (the validators hasher does) — the stored
        # level-0 array is the diff baseline and must not alias it, so a
        # private copy is taken at every adoption point below. The clean
        # path (no dirty chunks) adopts nothing and stays copy-free.
        if self.levels is None or len(leaves) < len(self.levels[0]):
            self._rebuild(leaves.copy())
            return
        old = self.levels[0]
        n_old, n_new = len(old), len(leaves)
        if n_new == 0:
            self._rebuild(leaves.copy())
            return
        dirty = np.nonzero(rows_ne(old, leaves[:n_old]))[0]
        if n_new > n_old:
            dirty = np.concatenate([dirty, np.arange(n_old, n_new)])
        if len(dirty) == 0:
            return
        leaves = leaves.copy()
        sizes = self._level_sizes(n_new)
        levels = [leaves]
        for d in range(len(sizes) - 1):
            dirty = np.unique(dirty // 2)
            nxt = np.empty((sizes[d + 1], 32), np.uint8)
            prev = self.levels[d + 1] if d + 1 < len(self.levels) else None
            if prev is not None:
                keep = min(len(prev), sizes[d + 1])
                nxt[:keep] = prev[:keep]
            nxt[dirty] = self._hash_parents(levels[d], dirty, d)
            levels.append(nxt)
        self.levels = levels
        self._top = None

    def root(self) -> bytes:
        """Spec merkleize(chunks, limit) root (no length mix-in)."""
        if self._top is not None:
            return self._top
        if self.levels is None or len(self.levels[0]) == 0:
            return ZERO_HASHES[self.depth]
        top = self.levels[-1][0].tobytes()
        # fold the real subtree up through the virtual zero padding
        for d in range(len(self.levels) - 1, self.depth):
            top = _hashing.hash_pair(top, ZERO_HASHES[d])
        self._top = top
        return top

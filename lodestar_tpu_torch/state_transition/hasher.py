"""Incremental BeaconState hashing from flat columns.

`stateTransition` ends in commit + hashTreeRoot per block
(reference `state-transition/src/stateTransition.ts:69-74`); the reference
affords that because `@chainsafe/ssz` ViewDU states re-hash only dirty
subtrees. This module (the port's copy of the JAX package's
`state_transition/hasher.py`) plays that role columnar-style: the hot
per-validator data already lives in numpy columns
(`cache.FlatValidators`), so each big list/vector field is hashed through
a cached `ssz.tree_cache.ChunkTree` whose leaf arrays are BUILT
VECTORIZED from the columns and DIFFED against the previous call — dirty
discovery is a numpy compare, re-hashing is O(dirty · log n) batched
SHA-256, and no object-graph walk ever happens.

Output is bit-identical to the plain `BeaconState.hash_tree_root()`
(the port's tests hold it to the JAX package's); the plain path remains
the oracle.
"""

from __future__ import annotations

import numpy as np

from ..ssz.hashing import merkleize_chunks, mix_in_length
from ..ssz.tree_cache import ChunkTree, _hash_rows, rows_ne

U64 = np.uint64


def _u64_chunks(arr: np.ndarray) -> np.ndarray:
    """(n,) uint64 → (ceil(n/4), 32) uint8 packed little-endian chunks."""
    n = len(arr)
    nchunks = (n + 3) // 4
    buf = np.zeros(nchunks * 4, U64)
    buf[:n] = arr
    return buf.astype("<u8").view(np.uint8).reshape(nchunks, 32)


def _u8_chunks(arr: np.ndarray) -> np.ndarray:
    """(n,) uint8 → (ceil(n/32), 32) packed chunks."""
    n = len(arr)
    nchunks = (n + 31) // 32
    buf = np.zeros(nchunks * 32, np.uint8)
    buf[:n] = arr
    return buf.reshape(nchunks, 32)


def _bytes32_rows(values) -> np.ndarray:
    """List of 32-byte values → (n, 32) uint8."""
    if not values:
        return np.zeros((0, 32), np.uint8)
    return np.frombuffer(b"".join(bytes(v) for v in values), np.uint8).reshape(
        -1, 32
    )


def _u64_col_chunk(arr: np.ndarray) -> np.ndarray:
    """(n,) uint64 → (n, 32) uint8: one chunk per element (LE + zero pad)."""
    out = np.zeros((len(arr), 32), np.uint8)
    out[:, :8] = arr.astype("<u8").view(np.uint8).reshape(-1, 8)
    return out


class _ValidatorsHasher:
    """Cached per-validator roots + the registry list tree.

    Leaf chunks per validator (SSZ Validator container, 8 fields):
      0 pubkey root = H(pk[0:32] ‖ pk[32:48]·0¹⁶)   (append-only)
      1 withdrawal_credentials
      2 effective_balance  3 slashed  4 activation_eligibility_epoch
      5 activation_epoch   6 exit_epoch  7 withdrawable_epoch
    Dirty rows are found by comparing the numeric/wc columns against
    snapshots (vectorized); only dirty rows re-hash their 8-chunk subtree
    (3 batched SHA-256 levels)."""

    _NUM_COLS = (
        "effective_balance",
        "slashed",
        "activation_eligibility_epoch",
        "activation_epoch",
        "exit_epoch",
        "withdrawable_epoch",
    )

    def __init__(self, limit: int):
        self.tree = ChunkTree(limit)
        self.pk_roots = np.zeros((0, 32), np.uint8)
        self.roots = np.zeros((0, 32), np.uint8)
        self.snap: dict[str, np.ndarray] | None = None
        self.last_dirty = 0  # rows re-hashed by the latest root() call

    def _pubkey_roots_for(self, pubkeys, start: int) -> np.ndarray:
        raw = np.frombuffer(
            b"".join(bytes(pk) for pk in pubkeys[start:]), np.uint8
        ).reshape(-1, 48)
        pairs = np.zeros((len(raw), 64), np.uint8)
        pairs[:, :48] = raw
        return _hash_rows(pairs)

    def root(self, flat) -> bytes:
        n = len(flat)
        # no astype copies: the flat columns are already uint64/bool — the
        # per-call cost must stay at one compare pass, not O(n) memcpys
        cols = {
            name: np.asarray(getattr(flat, name), U64)[:n]
            for name in self._NUM_COLS
        }
        wc = flat.withdrawal_credentials[:n]
        # append-only pubkey roots
        if len(self.pk_roots) < n:
            new = self._pubkey_roots_for(flat.pubkeys, len(self.pk_roots))
            self.pk_roots = (
                np.concatenate([self.pk_roots, new]) if len(self.pk_roots) else new
            )
        # dirty rows: column diff vs snapshot (+ everything appended)
        if self.snap is None:
            dirty = np.arange(n)
        else:
            prev_n = len(self.snap["effective_balance"])
            keep = min(prev_n, n)
            changed = np.zeros(keep, bool)
            for name in self._NUM_COLS:
                changed |= self.snap[name][:keep] != cols[name][:keep]
            changed |= rows_ne(self.snap["wc"][:keep], wc[:keep])
            dirty = np.nonzero(changed)[0]
            if n > prev_n:
                dirty = np.concatenate([dirty, np.arange(prev_n, n)])
        if len(dirty) > 0:
            d = len(dirty)
            chunks = np.zeros((d, 8, 32), np.uint8)
            chunks[:, 0] = self.pk_roots[dirty]
            chunks[:, 1] = wc[dirty]
            chunks[:, 2] = _u64_col_chunk(cols["effective_balance"][dirty])
            chunks[:, 3, 0] = cols["slashed"][dirty].astype(np.uint8)
            chunks[:, 4] = _u64_col_chunk(
                cols["activation_eligibility_epoch"][dirty]
            )
            chunks[:, 5] = _u64_col_chunk(cols["activation_epoch"][dirty])
            chunks[:, 6] = _u64_col_chunk(cols["exit_epoch"][dirty])
            chunks[:, 7] = _u64_col_chunk(cols["withdrawable_epoch"][dirty])
            lvl = chunks.reshape(d * 4, 64)
            lvl = _hash_rows(lvl).reshape(d * 2, 64)  # 8 → 4
            lvl = _hash_rows(lvl).reshape(d, 64)      # 4 → 2
            new_roots = _hash_rows(lvl)               # 2 → 1
            if len(self.roots) < n:
                grown = np.zeros((n, 32), np.uint8)
                grown[: len(self.roots)] = self.roots
                self.roots = grown
            self.roots[dirty] = new_roots
        # snapshot maintenance is O(dirty), not O(n): untouched rows are
        # already equal to the snapshot by construction of `dirty`
        if self.snap is None or len(self.snap["effective_balance"]) != n:
            self.snap = {name: cols[name].copy() for name in self._NUM_COLS}
            self.snap["wc"] = wc.copy()
        elif len(dirty) > 0:
            for name in self._NUM_COLS:
                self.snap[name][dirty] = cols[name][dirty]
            self.snap["wc"][dirty] = wc[dirty]
        self.last_dirty = int(len(dirty))
        self.tree.update(self.roots[:n])
        return mix_in_length(self.tree.root(), n)


class StateHasher:
    """hash_tree_root of a CachedBeaconState from its flat columns, with
    cached trees for every O(n_validators)/O(history) field."""

    def __init__(self, state):
        self.state_class = type(state)
        self._trees: dict[str, ChunkTree] = {}
        self._validators: _ValidatorsHasher | None = None
        self._memo: dict[str, tuple[object, bytes]] = {}

    def _tree(self, name: str, limit_chunks: int) -> ChunkTree:
        t = self._trees.get(name)
        if t is None:
            t = self._trees[name] = ChunkTree(limit_chunks)
        return t

    def _tree_root(self, name, leaves, limit_chunks, length=None) -> bytes:
        t = self._tree(name, limit_chunks)
        t.update(leaves)
        r = t.root()
        return r if length is None else mix_in_length(r, length)

    def root(self, cached) -> bytes:
        state = cached.state
        flat = cached.flat
        chunks = []
        for name, typ in state.fields:
            if name == "validators":
                if self._validators is None:
                    self._validators = _ValidatorsHasher(typ.limit)
                r = self._validators.root(flat)
            elif name == "balances":
                arr = np.asarray(flat.balances, U64)
                r = self._tree_root(
                    name, _u64_chunks(arr), (typ.limit + 3) // 4, len(arr)
                )
            elif name == "inactivity_scores":
                arr = np.asarray(cached.inactivity_scores, U64)
                r = self._tree_root(
                    name, _u64_chunks(arr), (typ.limit + 3) // 4, len(arr)
                )
            elif name in (
                "previous_epoch_participation",
                "current_epoch_participation",
            ):
                arr = np.asarray(
                    cached.previous_participation
                    if name.startswith("previous")
                    else cached.current_participation,
                    np.uint8,
                )
                r = self._tree_root(
                    name, _u8_chunks(arr), (typ.limit + 31) // 32, len(arr)
                )
            elif name in ("block_roots", "state_roots", "randao_mixes"):
                rows = _bytes32_rows(getattr(state, name))
                r = self._tree_root(name, rows, typ.length)
            elif name == "slashings":
                arr = np.asarray(getattr(state, name), U64)
                r = self._tree_root(name, _u64_chunks(arr), (typ.length + 3) // 4)
            elif name == "historical_roots":
                vals = getattr(state, name)
                r = self._tree_root(
                    name, _bytes32_rows(vals), typ.limit, len(vals)
                )
            elif name in ("current_sync_committee", "next_sync_committee"):
                # replaced (never mutated in place) at period boundaries —
                # memo by identity, keeping a strong ref against id reuse
                val = getattr(state, name)
                hit = self._memo.get(name)
                if hit is not None and hit[0] is val:
                    r = hit[1]
                else:
                    r = typ.hash_tree_root(val)
                    self._memo[name] = (val, r)
            else:
                r = typ.hash_tree_root(getattr(state, name))
            chunks.append(r)
        return merkleize_chunks(b"".join(chunks))

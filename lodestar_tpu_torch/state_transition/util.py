"""Spec helper functions: epoch math, seeds, shuffling, committees.

Equivalent surface to the reference's `state-transition/src/util/`
(epoch.ts, seed.ts, shuffle.ts, aggregator.ts…), with the shuffle
implemented as a whole-permutation vectorized pass (numpy) rather than a
per-index loop: one round touches every position at once — the same
swap-or-not network the spec defines, evaluated SIMD-style.

The port's copy of `lodestar_tpu/state_transition/util.py`: host code on
numpy, as there.
"""

from __future__ import annotations

import numpy as np

from ..ssz.hashing import sha256

UINT64_MAX = 2**64 - 1


def integer_squareroot(n: int) -> int:
    """Largest x with x² <= n (Newton iteration on exact ints — the spec's
    integer_squareroot; floats would break determinism)."""
    x = n
    y = (x + 1) // 2
    while y < x:
        x = y
        y = (x + n // x) // 2
    return x


# --- epoch / slot math ------------------------------------------------------

def compute_epoch_at_slot(slot: int, slots_per_epoch: int) -> int:
    return slot // slots_per_epoch

def compute_start_slot_at_epoch(epoch: int, slots_per_epoch: int) -> int:
    return epoch * slots_per_epoch

def compute_activation_exit_epoch(epoch: int, max_seed_lookahead: int) -> int:
    return epoch + 1 + max_seed_lookahead


# --- validator predicates (scalar + vectorized forms) -----------------------

def is_active_validator(v, epoch: int) -> bool:
    return v.activation_epoch <= epoch < v.exit_epoch


def active_mask(activation_epoch: np.ndarray, exit_epoch: np.ndarray, epoch: int):
    return (activation_epoch <= epoch) & (epoch < exit_epoch)


# --- randao / seeds ---------------------------------------------------------

def get_randao_mix(state, epoch: int, epochs_per_historical_vector: int) -> bytes:
    return state.randao_mixes[epoch % epochs_per_historical_vector]


def get_seed(state, epoch: int, domain_type: bytes, preset) -> bytes:
    """hash(domain_type + epoch + mix at epoch − MIN_SEED_LOOKAHEAD − 1)."""
    mix = get_randao_mix(
        state,
        epoch + preset.EPOCHS_PER_HISTORICAL_VECTOR - preset.MIN_SEED_LOOKAHEAD - 1,
        preset.EPOCHS_PER_HISTORICAL_VECTOR,
    )
    return sha256(domain_type + epoch.to_bytes(8, "little") + mix)


# --- swap-or-not shuffle ----------------------------------------------------

def compute_shuffled_index(index: int, count: int, seed: bytes, rounds: int) -> int:
    """Single-index forward shuffle (spec compute_shuffled_index): used for
    proposer sampling where only a few indices are needed."""
    assert index < count
    for r in range(rounds):
        pivot = int.from_bytes(sha256(seed + bytes([r]))[:8], "little") % count
        flip = (pivot + count - index) % count
        position = max(index, flip)
        source = sha256(seed + bytes([r]) + (position // 256).to_bytes(4, "little"))
        byte = source[(position % 256) // 8]
        if (byte >> (position % 8)) & 1:
            index = flip
    return index


def shuffle_list(indices: np.ndarray, seed: bytes, rounds: int) -> np.ndarray:
    """Whole-list shuffle L with L[i] = indices[π(i)] where π is the spec's
    `compute_shuffled_index` (vectorized; one pass per round over a boolean
    flip field derived from the round hashes).

    Each round's swap network σ_r is an involution and bit(i)=bit(flip(i)),
    so composing array-gathers in REVERSE round order yields
    indices ∘ σ_{R-1} ∘ … ∘ σ_0 = indices ∘ π — the same permutation as the
    per-index forward walk. (The reference keeps an optimized list form too:
    `state-transition/src/util/shuffle.ts`.)
    """
    n = len(indices)
    if n == 0:
        return indices.copy()
    out = indices.copy()
    pos = np.arange(n, dtype=np.int64)
    for r in range(rounds - 1, -1, -1):
        out = _shuffle_round(out, pos, seed, r, n)
    return out


def unshuffle_list(indices: np.ndarray, seed: bytes, rounds: int) -> np.ndarray:
    """Inverse of `shuffle_list` (rounds walked forward)."""
    n = len(indices)
    if n == 0:
        return indices.copy()
    out = indices.copy()
    pos = np.arange(n, dtype=np.int64)
    for r in range(rounds):
        out = _shuffle_round(out, pos, seed, r, n)
    return out


def _shuffle_round(out: np.ndarray, pos: np.ndarray, seed: bytes, r: int, n: int):
    pivot = int.from_bytes(sha256(seed + bytes([r]))[:8], "little") % n
    flip = (pivot + n - pos) % n
    position = np.maximum(pos, flip)
    # bit source: one 32-byte hash covers 256 positions
    n_blocks = int(position.max()) // 256 + 1
    prefix = seed + bytes([r])
    blocks = np.frombuffer(
        b"".join(
            sha256(prefix + blk.to_bytes(4, "little")) for blk in range(n_blocks)
        ),
        dtype=np.uint8,
    )
    byte_vals = blocks[(position // 8)]
    bits = (byte_vals >> (position % 8).astype(np.uint8)) & 1
    swap = bits.astype(bool)
    result = out.copy()
    result[swap] = out[flip[swap]]
    return result


# --- committees -------------------------------------------------------------

def get_committee_count_per_slot(active_count: int, preset) -> int:
    return max(
        1,
        min(
            preset.MAX_COMMITTEES_PER_SLOT,
            active_count // preset.SLOTS_PER_EPOCH // preset.TARGET_COMMITTEE_SIZE,
        ),
    )


def compute_committee_slice(
    shuffled: np.ndarray, slot_in_epoch: int, committee_index: int,
    committees_per_slot: int, slots_per_epoch: int,
) -> np.ndarray:
    """Committee = contiguous slice of the epoch's shuffled active set."""
    n = len(shuffled)
    committees = committees_per_slot * slots_per_epoch
    i = slot_in_epoch * committees_per_slot + committee_index
    start = n * i // committees
    end = n * (i + 1) // committees
    return shuffled[start:end]


def compute_proposer_index(
    effective_balances: np.ndarray, active_indices: np.ndarray, seed: bytes,
    preset,
) -> int:
    """Effective-balance-weighted sampling over the shuffled candidate
    stream (spec compute_proposer_index)."""
    total = len(active_indices)
    assert total > 0
    max_byte = 255
    i = 0
    while True:
        shuffled_i = compute_shuffled_index(
            i % total, total, seed, preset.SHUFFLE_ROUND_COUNT
        )
        candidate = int(active_indices[shuffled_i])
        rand = sha256(seed + (i // 32).to_bytes(8, "little"))[i % 32]
        eff = int(effective_balances[candidate])
        if eff * max_byte >= preset.MAX_EFFECTIVE_BALANCE * rand:
            return candidate
        i += 1


# --- merkle -----------------------------------------------------------------

def is_valid_merkle_branch(
    leaf: bytes, branch: list[bytes], depth: int, index: int, root: bytes
) -> bool:
    value = leaf
    for i in range(depth):
        if (index >> i) & 1:
            value = sha256(branch[i] + value)
        else:
            value = sha256(value + branch[i])
    return value == root

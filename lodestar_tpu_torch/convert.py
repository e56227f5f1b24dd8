"""Carrying the JAX package's arrays across to the port.

This system has no learned weights: what plays their part is the
constant tables the kernels close over and the arrays a verdict is
computed from. Both packages keep the same int32 (..., 32) limb layout, so
a conversion is a dtype- and shape-checked copy onto a device.

- `port_tables()` — the port's own constant tables (built from its own
  copy of the oracle), under the names `constants_from_jax` takes.
- `constants_from_jax(tables)` — the JAX package's tables, as numpy
  arrays under those names, → torch tensors.
- `grouped_inputs_from_jax(g, sig_raw, a_bits, b_bits)` — a JAX
  `GroupedArrays` plus its raw signatures and random bits → the
  arguments of `parallel.verifier.grouped_verify_kernel_raw`.
- `set_inputs_from_jax(arrs, r_bits)` — a JAX `SetArrays` (the per-set
  bucket) plus its random bits → the arguments of
  `parallel.verifier.bisect_tree_kernel`; without the bits, those of
  `individual_verify_kernel`.
- `pk_grouped_inputs_from_jax(g, sig_raw, a_bits, b_bits)` — a JAX
  `PkGroupedArrays` plus its raw signatures and GLS bits → the arguments
  of `parallel.verifier.pk_grouped_verify_kernel_raw`.
- `flat_inputs_from_jax(arrs, sig_raw, r_bits)` — a JAX `SetArrays` plus
  its raw signatures and random bits → the arguments of
  `parallel.verifier.batch_verify_kernel_raw`.

The port never imports the JAX package; callers (the tests) pass its
arrays in.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import fp, fp12, g2_decompress, limbs, points

def port_tables() -> dict[str, np.ndarray]:
    """The port's constant tables, named after the JAX package's arrays
    (`ops/limbs.py` *_LIMBS, `ops/fp.py` *_P2_COLS, `ops/points.py`
    b3 / generators / −[2^b]g1 (32 and 64 entries) / ψ, `ops/fp12.py` γ,
    `ops/g2_decompress.py` 1/2 and (p+1)/2)."""
    return {
        "P": limbs.P_LIMBS,
        "TWO_P": limbs.TWO_P_LIMBS,
        "R2": limbs.R2_LIMBS,
        "ONE_MONT": limbs.ONE_MONT_LIMBS,
        "FOUR_P2_COLS": fp.FOUR_P2_COLS,
        "EIGHT_P2_COLS": fp.EIGHT_P2_COLS,
        "G1_B3": points.g1.b3_np,
        "G2_B3": points.g2.b3_np,
        "G1_GEN_X": points.G1_GEN_X,
        "G1_GEN_Y": points.G1_GEN_Y,
        "NEG_G1_POW2_X": points.NEG_G1_POW2_X,
        "NEG_G1_POW2_Y": points.NEG_G1_POW2_Y,
        "NEG_G1_POW2_64_X": points.NEG_G1_POW2_64_X,
        "NEG_G1_POW2_64_Y": points.NEG_G1_POW2_64_Y,
        "PSI_CX": points.PSI_CX_L,
        "PSI_CY": points.PSI_CY_L,
        "FROB_GAMMA": fp12.GAMMA,
        "INV2": g2_decompress.INV2,
        "HALF_P1": g2_decompress.HALF_P1,
    }


def _to_tensor(name: str, arr, shape, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype != np.int32:
        raise TypeError(f"{name}: expected int32 limbs, got {arr.dtype}")
    if shape is not None and arr.shape != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {arr.shape}")
    return torch.from_numpy(np.array(arr)).to(device)


def _raw_to_tensor(sig_raw, shape, device) -> torch.Tensor:
    raw = np.asarray(sig_raw)
    if raw.dtype != np.uint8 or raw.shape != tuple(shape):
        raise ValueError(f"sig_raw: expected {tuple(shape)} uint8")
    return torch.from_numpy(raw.copy()).to(device)


def constants_from_jax(tables: dict, device="cpu") -> dict[str, torch.Tensor]:
    """The JAX package's constant tables (numpy arrays under the names of
    `port_tables`) → int32 tensors on `device`, each checked against the
    shape of the port's own table of that name."""
    own = port_tables()
    unknown = set(tables) - set(own)
    if unknown:
        raise KeyError(f"unknown tables: {sorted(unknown)}")
    return {k: _to_tensor(k, v, own[k].shape, device) for k, v in tables.items()}


def grouped_inputs_from_jax(g, sig_raw, a_bits, b_bits, device="cpu") -> tuple:
    """A JAX `GroupedArrays` (R rows × L lanes) with its raw signatures
    (R, L, 96) and GLS bits (R, L, 32) → the argument tuple of
    `grouped_verify_kernel_raw`: (pk_x, pk_y, msg_x, msg_y, sig_raw,
    a_bits, b_bits, valid) as tensors on `device`."""
    rows, lanes = np.asarray(g.valid).shape
    out = [
        _to_tensor("pk_x", g.pk_x, (rows, lanes, 32), device),
        _to_tensor("pk_y", g.pk_y, (rows, lanes, 32), device),
        _to_tensor("msg_x", g.msg_x, (rows, 2, 32), device),
        _to_tensor("msg_y", g.msg_y, (rows, 2, 32), device),
    ]
    out.append(_raw_to_tensor(sig_raw, (rows, lanes, 96), device))
    out.append(_to_tensor("a_bits", a_bits, (rows, lanes, 32), device))
    out.append(_to_tensor("b_bits", b_bits, (rows, lanes, 32), device))
    out.append(torch.from_numpy(np.asarray(g.valid, bool).copy()).to(device))
    return tuple(out)


def set_inputs_from_jax(arrs, r_bits=None, device="cpu") -> tuple:
    """A JAX `SetArrays` (N lanes) and its random bits (N, 64), MSB first →
    the argument tuple of `bisect_tree_kernel`: (pk_x, pk_y, msg_x, msg_y,
    sig_x, sig_y, r_bits, valid) as tensors on `device`. With r_bits None
    the tuple omits them and is the argument tuple of
    `individual_verify_kernel`."""
    lanes = np.asarray(arrs.valid).shape[0]
    out = [
        _to_tensor("pk_x", arrs.pk_x, (lanes, 32), device),
        _to_tensor("pk_y", arrs.pk_y, (lanes, 32), device),
        _to_tensor("msg_x", arrs.msg_x, (lanes, 2, 32), device),
        _to_tensor("msg_y", arrs.msg_y, (lanes, 2, 32), device),
        _to_tensor("sig_x", arrs.sig_x, (lanes, 2, 32), device),
        _to_tensor("sig_y", arrs.sig_y, (lanes, 2, 32), device),
    ]
    if r_bits is not None:
        out.append(_to_tensor("r_bits", r_bits, (lanes, 64), device))
    out.append(torch.from_numpy(np.asarray(arrs.valid, bool).copy()).to(device))
    return tuple(out)


def pk_grouped_inputs_from_jax(g, sig_raw, a_bits, b_bits, device="cpu") -> tuple:
    """A JAX `PkGroupedArrays` (R pubkey rows × L lanes) with its raw
    signatures (R, L, 96) and GLS bits (R, L, 32) → the argument tuple of
    `pk_grouped_verify_kernel_raw`: (pk_x, pk_y, msg_x, msg_y, sig_raw,
    a_bits, b_bits, valid) as tensors on `device`."""
    rows, lanes = np.asarray(g.valid).shape
    return (
        _to_tensor("pk_x", g.pk_x, (rows, 32), device),
        _to_tensor("pk_y", g.pk_y, (rows, 32), device),
        _to_tensor("msg_x", g.msg_x, (rows, lanes, 2, 32), device),
        _to_tensor("msg_y", g.msg_y, (rows, lanes, 2, 32), device),
        _raw_to_tensor(sig_raw, (rows, lanes, 96), device),
        _to_tensor("a_bits", a_bits, (rows, lanes, 32), device),
        _to_tensor("b_bits", b_bits, (rows, lanes, 32), device),
        torch.from_numpy(np.asarray(g.valid, bool).copy()).to(device),
    )


def flat_inputs_from_jax(arrs, sig_raw, r_bits, device="cpu") -> tuple:
    """A JAX `SetArrays` (N lanes) with its raw signatures (N, 96) and
    random bits (N, 64), MSB first → the argument tuple of
    `batch_verify_kernel_raw`: (pk_x, pk_y, msg_x, msg_y, sig_raw, r_bits,
    valid) as tensors on `device`."""
    lanes = np.asarray(arrs.valid).shape[0]
    return (
        _to_tensor("pk_x", arrs.pk_x, (lanes, 32), device),
        _to_tensor("pk_y", arrs.pk_y, (lanes, 32), device),
        _to_tensor("msg_x", arrs.msg_x, (lanes, 2, 32), device),
        _to_tensor("msg_y", arrs.msg_y, (lanes, 2, 32), device),
        _raw_to_tensor(sig_raw, (lanes, 96), device),
        _to_tensor("r_bits", r_bits, (lanes, 64), device),
        torch.from_numpy(np.asarray(arrs.valid, bool).copy()).to(device),
    )

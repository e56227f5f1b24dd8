"""`lodestar_tpu_torch.convert`: the JAX package's constant tables and a
grouped or per-set batch's arrays carried into the port.

The port builds its tables from its own copy of the oracle; they must
equal the JAX package's arrays exactly, and `constants_from_jax` /
`grouped_inputs_from_jax` / `set_inputs_from_jax` /
`pk_grouped_inputs_from_jax` / `flat_inputs_from_jax` must round-trip the
JAX arrays unchanged.
"""

import numpy as np
import pytest

from lodestar_tpu.ops import fp as jfp
from lodestar_tpu.ops import fp12 as jfp12
from lodestar_tpu.ops import g2_decompress as jdec
from lodestar_tpu.ops import limbs as jlimbs
from lodestar_tpu.ops import points as jpoints
from lodestar_tpu.parallel.verifier import GroupedArrays, PkGroupedArrays, SetArrays
from lodestar_tpu_torch.convert import (
    constants_from_jax,
    flat_inputs_from_jax,
    grouped_inputs_from_jax,
    pk_grouped_inputs_from_jax,
    port_tables,
    set_inputs_from_jax,
)


def jax_tables():
    return {
        "P": jlimbs.P_LIMBS,
        "TWO_P": jlimbs.TWO_P_LIMBS,
        "R2": jlimbs.R2_LIMBS,
        "ONE_MONT": jlimbs.ONE_MONT_LIMBS,
        "FOUR_P2_COLS": jfp.FOUR_P2_COLS,
        "EIGHT_P2_COLS": jfp.EIGHT_P2_COLS,
        "G1_B3": jpoints.g1.b3,
        "G2_B3": jpoints.g2.b3,
        "G1_GEN_X": jpoints.G1_GEN_X,
        "G1_GEN_Y": jpoints.G1_GEN_Y,
        "NEG_G1_POW2_X": jpoints.NEG_G1_POW2_X,
        "NEG_G1_POW2_Y": jpoints.NEG_G1_POW2_Y,
        "NEG_G1_POW2_64_X": jpoints.NEG_G1_POW2_64_X,
        "NEG_G1_POW2_64_Y": jpoints.NEG_G1_POW2_64_Y,
        "PSI_CX": jpoints._PSI_CX_L,
        "PSI_CY": jpoints._PSI_CY_L,
        "FROB_GAMMA": jfp12._GAMMA,
        "INV2": jdec._INV2,
        "HALF_P1": jdec._HALF_P1,
    }


def test_port_tables_equal_the_jax_arrays():
    """Built from the port's own oracle copy, they equal the JAX arrays."""
    ours, theirs = port_tables(), jax_tables()
    assert set(ours) == set(theirs)
    for name in ours:
        np.testing.assert_array_equal(ours[name], np.asarray(theirs[name]), err_msg=name)


def test_constants_from_jax_round_trip():
    tables = {k: np.asarray(v) for k, v in jax_tables().items()}
    out = constants_from_jax(tables)
    for name, arr in tables.items():
        assert out[name].dtype.is_floating_point is False
        np.testing.assert_array_equal(out[name].numpy(), arr, err_msg=name)


def test_constants_from_jax_refuses_wrong_tables():
    with pytest.raises(KeyError):
        constants_from_jax({"NOT_A_TABLE": np.zeros(32, np.int32)})
    with pytest.raises(ValueError):
        constants_from_jax({"P": np.zeros(31, np.int32)})
    with pytest.raises(TypeError):
        constants_from_jax({"P": np.zeros(32, np.int64)})


def test_grouped_inputs_from_jax_round_trip():
    rng = np.random.default_rng(3)
    g = GroupedArrays(2, 4)
    for name in ("pk_x", "pk_y", "msg_x", "msg_y"):
        arr = getattr(g, name)
        arr[...] = rng.integers(0, 4096, size=arr.shape)
    g.valid[0, :3] = True
    sig_raw = rng.integers(0, 256, size=(2, 4, 96), dtype=np.uint8)
    a_bits = rng.integers(0, 2, size=(2, 4, 32)).astype(np.int32)
    b_bits = rng.integers(0, 2, size=(2, 4, 32)).astype(np.int32)
    out = grouped_inputs_from_jax(g, sig_raw, a_bits, b_bits)
    want = (g.pk_x, g.pk_y, g.msg_x, g.msg_y, sig_raw, a_bits, b_bits, g.valid)
    assert len(out) == len(want)
    for got, arr in zip(out, want):
        np.testing.assert_array_equal(got.numpy(), arr)
    with pytest.raises(ValueError):
        grouped_inputs_from_jax(g, sig_raw[:, :3], a_bits, b_bits)


def test_set_inputs_from_jax_round_trip():
    rng = np.random.default_rng(4)
    arrs = SetArrays(4)
    names = ("pk_x", "pk_y", "msg_x", "msg_y", "sig_x", "sig_y")
    for name in names:
        arr = getattr(arrs, name)
        arr[...] = rng.integers(0, 4096, size=arr.shape)
    arrs.valid[:3] = True
    r_bits = rng.integers(0, 2, size=(4, 64)).astype(np.int32)
    out = set_inputs_from_jax(arrs, r_bits)
    want = tuple(getattr(arrs, k) for k in names) + (r_bits, arrs.valid)
    assert len(out) == len(want) == 8
    for got, arr in zip(out, want):
        np.testing.assert_array_equal(got.numpy(), arr)
    short = set_inputs_from_jax(arrs)  # the arguments of individual_verify_kernel
    assert len(short) == 7
    np.testing.assert_array_equal(short[-1].numpy(), arrs.valid)
    with pytest.raises(ValueError):
        set_inputs_from_jax(arrs, r_bits[:, :32])
    with pytest.raises(TypeError):
        set_inputs_from_jax(arrs, r_bits.astype(np.int64))


def test_pk_grouped_inputs_from_jax_round_trip():
    rng = np.random.default_rng(5)
    g = PkGroupedArrays(2, 4)
    for name in ("pk_x", "pk_y", "msg_x", "msg_y"):
        arr = getattr(g, name)
        arr[...] = rng.integers(0, 4096, size=arr.shape)
    g.valid[1, :2] = True
    sig_raw = rng.integers(0, 256, size=(2, 4, 96), dtype=np.uint8)
    a_bits = rng.integers(0, 2, size=(2, 4, 32)).astype(np.int32)
    b_bits = rng.integers(0, 2, size=(2, 4, 32)).astype(np.int32)
    out = pk_grouped_inputs_from_jax(g, sig_raw, a_bits, b_bits)
    want = (g.pk_x, g.pk_y, g.msg_x, g.msg_y, sig_raw, a_bits, b_bits, g.valid)
    assert len(out) == len(want)
    for got, arr in zip(out, want):
        np.testing.assert_array_equal(got.numpy(), arr)
    with pytest.raises(ValueError):
        pk_grouped_inputs_from_jax(g, sig_raw[:, :3], a_bits, b_bits)
    with pytest.raises(TypeError):
        pk_grouped_inputs_from_jax(g, sig_raw, a_bits.astype(np.int64), b_bits)


def test_flat_inputs_from_jax_round_trip():
    rng = np.random.default_rng(6)
    arrs = SetArrays(4)
    for name in ("pk_x", "pk_y", "msg_x", "msg_y"):
        arr = getattr(arrs, name)
        arr[...] = rng.integers(0, 4096, size=arr.shape)
    arrs.valid[:3] = True
    sig_raw = rng.integers(0, 256, size=(4, 96), dtype=np.uint8)
    r_bits = rng.integers(0, 2, size=(4, 64)).astype(np.int32)
    out = flat_inputs_from_jax(arrs, sig_raw, r_bits)
    want = (arrs.pk_x, arrs.pk_y, arrs.msg_x, arrs.msg_y, sig_raw, r_bits, arrs.valid)
    assert len(out) == len(want) == 7
    for got, arr in zip(out, want):
        np.testing.assert_array_equal(got.numpy(), arr)
    with pytest.raises(ValueError):
        flat_inputs_from_jax(arrs, sig_raw.astype(np.int32), r_bits)
    with pytest.raises(ValueError):
        flat_inputs_from_jax(arrs, sig_raw, r_bits[:, :32])

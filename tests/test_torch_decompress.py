"""The port's on-device G2 decompression (`ops/g2_decompress.py`).

`decompress` is held against the JAX package's C host tier
(`lodestar_tpu.native.bls_g2_decompress`, without its subgroup check, as
the device path has none): the same limbs and the right ok-bit on valid
signatures and on the malformed encodings of `tests/test_decompress_fuzz.py`.
The limb-exact comparison against the JAX decompress kernel compiles two
380-step power chains and sits in the slow tier.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lodestar_tpu import native as jnative
from lodestar_tpu.bls import api as bls
from lodestar_tpu.bls.fields import P
from lodestar_tpu.ops import g2_decompress as jdec
from lodestar_tpu_torch.ops import fp
from lodestar_tpu_torch.ops import g2_decompress as dec

# several pytest workers share the host: one intra-op thread each keeps
# OpenMP from spinning against the others
torch.set_num_threads(1)


def _sigs():
    return [
        bls.interop_secret_key(i).sign(bytes([0x30 + i]) * 32).to_bytes()
        for i in range(3)
    ]


def _clear_compression(b):
    raw = bytearray(b)
    raw[0] &= 0x7F
    return bytes(raw)


def _flip_y_sign(b):
    raw = bytearray(b)
    raw[0] ^= 0x20
    return bytes(raw)


def _x_ge_p(b):
    raw = bytearray(b)
    pb = bytearray(P.to_bytes(48, "big"))
    pb[0] |= 0x80 | (raw[0] & 0x20)
    raw[:48] = pb
    return bytes(raw)


def _x0_ge_p(b):
    raw = bytearray(b)
    raw[48:] = P.to_bytes(48, "big")
    return bytes(raw)


def _infinity_with_payload(_b):
    return bytes([0xC0, 0x01]) + b"\x00" * 94


def _infinity(_b):
    return bytes([0xC0]) + b"\x00" * 95


def _off_curve(b):
    """Walk the last x byte until the host tier refuses the point."""
    raw = bytearray(b)
    while True:
        raw[95] = (raw[95] + 1) % 256
        if jnative.bls_g2_decompress(bytes(raw), check_subgroup=False)[0] != 0:
            return bytes(raw)


MUTATORS = [_clear_compression, _flip_y_sign, _x_ge_p, _x0_ge_p,
            _infinity_with_payload, _infinity, _off_curve]


def _corpus():
    sigs = _sigs()
    return sigs + [m(sigs[k % len(sigs)]) for k, m in enumerate(MUTATORS)]


def test_decompress_matches_host_tier():
    corpus = _corpus()
    raw = torch.as_tensor(np.frombuffer(b"".join(corpus), np.uint8).reshape(-1, 96).copy())
    x, y, ok = dec.decompress(raw)
    for k, sig in enumerate(corpus):
        rc, limbs = jnative.bls_g2_decompress(sig, check_subgroup=False)
        assert bool(ok[k]) == (rc == 0), k
        if rc == 0:
            np.testing.assert_array_equal(fp.canonical(x[k]).numpy(), limbs[0])
            np.testing.assert_array_equal(fp.canonical(y[k]).numpy(), limbs[1])
    assert ok.numpy()[: len(_sigs())].all()  # the valid signatures decode
    assert not ok.numpy()[len(_sigs()) + 2:].any()  # all but the sign flip fail


@pytest.mark.slow
def test_decompress_limb_exact_against_jax():
    corpus = _corpus()
    raw = np.frombuffer(b"".join(corpus), np.uint8).reshape(-1, 96).copy()
    got = dec.decompress(torch.as_tensor(raw))
    ref = jax.jit(jdec.decompress)(jnp.asarray(raw))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))

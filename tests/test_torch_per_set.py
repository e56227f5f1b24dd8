"""The port's per-set verdict path (`TorchBlsVerifier.
verify_signature_sets_individual` and what it runs), on the CPU.

- `CurveOps.add_mixed` and `scalar_mul_bits` on G1 and G2 (2 lanes, 8
  bits), limb for limb against the JAX package (tolerance 0);
- `native.bls_marshal_sets` against the JAX package's binding, and the
  verifier's `_marshal` against `TpuBlsVerifier._marshal`, limb for limb;
- `_rand_bits`: nonzero 64-bit coefficients, MSB first, from a Generator,
  a callable or the CSPRNG;
- `verify_signature_sets_individual(device="cpu")` on 4 sets with one
  invalid equals the host C tier, by bisection; one malformed set sends
  the batch through `_verify_one`; the 2⁻⁶⁴ fallback is taken when every
  probe passes under a failed root.
- Slow tier: `bisect_tree_kernel` (every level) and
  `individual_verify_kernel`, fed through `convert.set_inputs_from_jax`,
  limb for limb and verdict for verdict against the JAX kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lodestar_tpu import native as jnative
from lodestar_tpu.bls import api as bls
from lodestar_tpu.ops import points as jpoints
from lodestar_tpu.parallel import verifier as jverifier
from lodestar_tpu_torch import convert, native
from lodestar_tpu_torch.bls.api import DST_G2
from lodestar_tpu_torch.bls.fields import P
from lodestar_tpu_torch.ops import fp12
from lodestar_tpu_torch.ops.limbs import int_to_limbs
from lodestar_tpu_torch.ops.points import g1, g2
from lodestar_tpu_torch.parallel import verifier
from lodestar_tpu_torch.parallel.verifier import TorchBlsVerifier, _rand_bits

# several pytest workers share the host: one intra-op thread each keeps
# OpenMP from spinning against the others
torch.set_num_threads(1)


def rand(seed, shape):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(48), "little") % (2 * P) for _ in range(n)]
    return np.stack([int_to_limbs(v) for v in vals]).reshape(tuple(shape) + (32,))


def t(x):
    return torch.as_tensor(np.array(x))


def _sets(n: int, first: int = 40):
    """n valid sets over n signing roots (interop keys)."""
    out = []
    for i in range(n):
        sk = bls.interop_secret_key(first + i)
        root = bytes([0xA0 + i]) * 32
        out.append(bls.SignatureSet(
            pubkey=sk.to_public_key(), message=root,
            signature=jnative.bls_sign(sk.to_bytes(), root, DST_G2)[1],
        ))
    return out


def _host(sets):
    return jnative.bls_verify_sets(
        b"".join(s.pubkey.to_bytes() for s in sets), [s.message for s in sets],
        b"".join(s.signature for s in sets), DST_G2)


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_add_mixed_limb_exact(curve):
    ops, jops = (g1, jpoints.g1) if curve == "g1" else (g2, jpoints.g2)
    coord = () if curve == "g1" else (2,)
    p = tuple(rand(s, (2,) + coord) for s in (1, 2, 3))
    q = tuple(rand(s, (2,) + coord) for s in (4, 5))
    got = ops.add_mixed(tuple(map(t, p)), tuple(map(t, q)))
    ref = jax.jit(jops.add_mixed)(tuple(map(jnp.asarray, p)), tuple(map(jnp.asarray, q)))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_scalar_mul_bits_limb_exact(curve):
    ops, jops = (g1, jpoints.g1) if curve == "g1" else (g2, jpoints.g2)
    coord = () if curve == "g1" else (2,)
    q = tuple(rand(s, (2,) + coord) for s in (6, 7))
    bits = np.random.default_rng(8).integers(0, 2, size=(2, 8)).astype(np.int32)
    bits[0] = [1, 0, 1, 1, 0, 0, 1, 0]
    got = ops.scalar_mul_bits(t(bits), tuple(map(t, q)))
    ref = jax.jit(jops.scalar_mul_bits)(jnp.asarray(bits), tuple(map(jnp.asarray, q)))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("do_hash,do_pk", [(True, True), (False, False)])
def test_marshal_sets_equals_the_jax_binding(do_hash, do_pk):
    sets = _sets(3)
    sigs = bytearray(b"".join(s.signature for s in sets))
    sigs[96 + 20] ^= 1  # set 1: a corrupted signature
    pks = b"".join(s.pubkey.to_bytes() for s in sets)
    msgs = b"".join(s.message for s in sets)
    got = native.bls_marshal_sets(pks, msgs, bytes(sigs), DST_G2, do_hash=do_hash, do_pk=do_pk)
    ref = jnative.bls_marshal_sets(pks, msgs, bytes(sigs), DST_G2, do_hash=do_hash, do_pk=do_pk)
    ok = ref[6]
    np.testing.assert_array_equal(got[6], ok)
    assert list(ok) == [True, False, True]
    # the JAX binding leaves skipped and failed lanes unwritten; compare the rest
    fields = [4, 5] + ([0, 1] if do_pk else []) + ([2, 3] if do_hash else [])
    for k in fields:
        np.testing.assert_array_equal(got[k][ok], np.asarray(ref[k])[ok])
    with pytest.raises(ValueError):
        native.bls_marshal_sets(pks, msgs[:-1], bytes(sigs), DST_G2)


def test_marshal_equals_the_jax_verifier():
    sets = _sets(5)
    got = TorchBlsVerifier(device="cpu")._marshal(sets)
    ref = jverifier.TpuBlsVerifier(mesh=None, device_decompress=False)._marshal(sets)
    assert got.n == ref.n == 5 and got.pk_x.shape == (16, 32)
    for k in ("pk_x", "pk_y", "msg_x", "msg_y", "sig_x", "sig_y", "valid"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k))


def test_rand_bits_forms():
    a = _rand_bits(5, np.random.default_rng(1))
    b = _rand_bits(5, np.random.default_rng(1))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (5, 64) and a.dtype == np.int32 and a.any(axis=1).all()
    words = iter([0, 0b101 << 61, 1])  # a zero draw is drawn again
    c = _rand_bits(2, lambda: next(words))
    assert list(c[0, :3]) == [1, 0, 1] and c[0, 3:].sum() == 0
    assert c[1, -1] == 1 and c[1, :-1].sum() == 0
    np.testing.assert_array_equal(c, jverifier._rand_bits(2, iter([0b101 << 61, 1]).__next__))
    d = _rand_bits(4)  # the CSPRNG draw
    assert d.shape == (4, 64) and d.any(axis=1).all()


def test_individual_four_sets_one_invalid_equals_the_host_tier():
    sets = _sets(4)
    sets[2] = bls.SignatureSet(pubkey=sets[2].pubkey, message=sets[1].message,
                               signature=sets[2].signature)
    v = TorchBlsVerifier(device="cpu", rng=np.random.default_rng(3))
    got = v.verify_signature_sets_individual(sets)
    assert got == _host(sets) == [True, True, False, True]
    assert v.last_bisect == {"rounds": 2, "probes": 4}
    assert v.verify_signature_sets_individual([]) == []


def test_malformed_set_takes_verify_one(monkeypatch):
    sets = _sets(2, first=50)
    raw = bytearray(sets[1].signature)
    raw[:48] = P.to_bytes(48, "big")  # x.c1 = p under valid flags
    raw[0] |= 0x80 | (sets[1].signature[0] & 0x20)
    sets[1] = bls.SignatureSet(pubkey=sets[1].pubkey, message=sets[1].message,
                               signature=bytes(raw))
    v = TorchBlsVerifier(device="cpu")
    seen = []
    one = v._verify_one
    monkeypatch.setattr(v, "_verify_one", lambda s: seen.append(s) or one(s))
    assert v.verify_signature_sets_individual(sets) == _host(sets) == [True, False]
    assert seen == sets


def test_cancellation_fallback_when_every_probe_passes(monkeypatch):
    sets = _sets(3, first=60)
    v = TorchBlsVerifier(device="cpu", rng=np.random.default_rng(4))
    ones = fp12.one((4,))
    levels = [ones, ones[:2], ones[:1]]
    calls = []
    monkeypatch.setattr(v, "verify_bisect_tree", lambda arrs, r_bits: (torch.tensor(False), levels))
    monkeypatch.setattr(v, "probe_nodes", lambda fs: torch.ones(fs.shape[0], dtype=torch.bool))
    monkeypatch.setattr(v, "verify_individual", lambda arrs: calls.append(arrs.n)
                        or torch.tensor([True, False, True, False]))
    assert v.verify_signature_sets_individual(sets) == [True, False, True]
    assert calls == [3] and v.last_bisect == {"rounds": 1, "probes": 2}


def test_buckets():
    v = TorchBlsVerifier(device="cpu")
    assert [v.bucket_for(n) for n in (1, 4, 5, 16, 17, 100, 128, 129)] == [
        4, 4, 16, 16, 64, 128, 128, 128]
    assert v._marshal(_sets(1) * 129) is None  # more than the largest bucket


def _jax_set_arrays(sets, lanes=4):
    arrs = jverifier.TpuBlsVerifier(
        buckets=(lanes,), mesh=None, device_decompress=False)._marshal(sets)
    rng = np.random.default_rng(9)
    r_bits = jverifier._rand_bits(lanes, lambda: int(rng.integers(1, 1 << 63)))
    return arrs, r_bits


@pytest.mark.slow
def test_bisect_tree_kernel_limb_exact():
    sets = _sets(3, first=70)
    sets[1] = bls.SignatureSet(pubkey=sets[1].pubkey, message=sets[0].message,
                               signature=sets[1].signature)
    arrs, r_bits = _jax_set_arrays(sets)
    root, levels = verifier.bisect_tree_kernel(*convert.set_inputs_from_jax(arrs, r_bits))
    jroot, jlevels = jax.jit(jverifier.bisect_tree_kernel)(
        arrs.pk_x, arrs.pk_y, arrs.msg_x, arrs.msg_y, arrs.sig_x, arrs.sig_y, r_bits, arrs.valid)
    assert bool(root) == bool(jroot) is False
    assert len(levels) == len(jlevels) == 3
    for a, b in zip(levels, jlevels):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.slow
def test_individual_verify_kernel_equals_jax():
    sets = _sets(3, first=80)
    sets[2] = bls.SignatureSet(pubkey=sets[0].pubkey, message=sets[2].message,
                               signature=sets[2].signature)
    arrs, _ = _jax_set_arrays(sets)
    got = verifier.individual_verify_kernel(*convert.set_inputs_from_jax(arrs))
    ref = jax.jit(jverifier.individual_verify_kernel)(
        arrs.pk_x, arrs.pk_y, arrs.msg_x, arrs.msg_y, arrs.sig_x, arrs.sig_y, arrs.valid)
    assert list(got.numpy()) == list(np.asarray(ref)) == [True, True, False, False]

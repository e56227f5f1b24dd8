"""The port's C host tier (`lodestar_tpu_torch.native`, its own copy of the
sources built with `cc` and loaded with ctypes) against the JAX package's
`lodestar_tpu.native`: byte- and limb-identical results for
`g1_decompress`, `hash_to_g2`, `sign` and `verify_sets`, the pinned KAT
signatures of `tests/test_device_kats.py` accepted, and `sk_to_pk` (an
entry point the copy adds) equal to the oracle's public keys. The G1
aggregate returns the compressed sum (the JAX `aggregate_pubkeys(...)
.to_bytes()`), the G2 aggregate (another addition) the JAX
`aggregate_signatures`' bytes, `sha256_level` hashlib's digests, and the
port's `bls.api` over them the JAX API's answers. One departure: the
copy's `verify_sets` keeps each set's own message after a set it refuses
before hashing.
"""

import os

import numpy as np
import pytest

from lodestar_tpu import native as jnative
from lodestar_tpu.bls import api as bls
from lodestar_tpu_torch import build, native
from lodestar_tpu_torch.bls.api import DST_G2

# (interop sk index, message, pinned signature hex) from test_device_kats.py
PAIR_KATS = [
    (10, b"\x40" * 32,
     "8026279efc7e27f0a69a5926666fb0762180a6962852061c0dea8c9b0cfaa290"
     "c2ba1f7061bf591231ad97457efa90f8105db1a7d79fbffc2244bc60814027a3"
     "aacf05d896cb1b9b4b34001a6e2bd1500c7b46e828667a1a284f53bd6fc090f9"),
    (11, b"\x41" * 32,
     "895dbf73414f4a6c9f2519905c44c8a87a108a0fa3f035aeba189140a9c940cc"
     "dc8241f0011686fb3c89c569a3ce69fd17304b3c280f18a91c830bad3e8c1585"
     "567d3aee2fb6a0834d052041b798c02c2c8ced3dba7d799a10a9816caef56ec8"),
    (12, b"\x42" * 32,
     "afe804241d437e1e60cd5955f3f0b02600c4802571cc8c128072abe46c9c5835"
     "699b24d40a96ad4354dd1ec4d0fa5a7205fb2359cac30baa7aa67eddd9675a6d"
     "2b66d1f25873bf3228de235e407502c8de97be4e224025f1acf7fc3db08e6f07"),
]
# interop keys 0..3 all sign FAST_AGG_MSG; their aggregate signature
FAST_AGG_MSG = b"\x2a" * 32
FAST_AGG_SIG = (
    "a68f51bca0c4b79ea27d259b90a96601f12c047f786a57edd5c24813d628f302"
    "637e4f41d79082facf98615f491e4f79089c0ce2152a43ab557758100f57851d"
    "d0dab846e55b91f0dc1175d29996dd17d8eb655b36128aba5fa21dba7269d23f"
)


def keys(n, first=0):
    return [bls.interop_secret_key(first + i) for i in range(n)]


def test_dst_and_consts_header_are_the_jax_packages():
    assert DST_G2 == bls.DST_G2
    ours = os.path.join(build.CSRC, "host", "bls12_consts.h")
    theirs = os.path.join(os.path.dirname(jnative.__file__), "src", "bls12_consts.h")
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


def test_sk_to_pk_matches_oracle():
    for sk in keys(3):
        rc, pk = native.sk_to_pk(sk.to_bytes())
        assert rc == 0 and pk == sk.to_public_key().to_bytes()
    assert native.sk_to_pk(b"\x00" * 32)[0] == -1


def test_g1_decompress_identical():
    for sk in keys(3):
        pk = sk.to_public_key().to_bytes()
        for check in (False, True):
            rc, limbs = native.g1_decompress(pk, check_subgroup=check)
            jrc, jlimbs = jnative.bls_g1_decompress(pk, check_subgroup=check)
            assert rc == jrc == 0
            np.testing.assert_array_equal(limbs, jlimbs)
    bad = bytes([0x80]) + b"\xff" * 47  # x >= p
    assert native.g1_decompress(bad)[0] == jnative.bls_g1_decompress(bad)[0] != 0


def test_hash_to_g2_and_sign_identical():
    for i, sk in enumerate(keys(3)):
        msg = bytes([0x70 + i]) * 32
        rc, limbs = native.hash_to_g2(msg, DST_G2)
        jrc, jlimbs = jnative.bls_hash_to_g2(msg, DST_G2)
        assert rc == jrc == 0
        np.testing.assert_array_equal(limbs, jlimbs)
        rc, sig = native.sign(sk.to_bytes(), msg, DST_G2)
        assert (rc, sig) == jnative.bls_sign(sk.to_bytes(), msg, DST_G2)


def test_verify_sets_identical_and_accepts_pinned_kats():
    agg_pk = bls.aggregate_pubkeys([sk.to_public_key() for sk in keys(4)])
    pks, msgs, sigs = [agg_pk.to_bytes()], [FAST_AGG_MSG], [bytes.fromhex(FAST_AGG_SIG)]
    for idx, msg, sig_hex in PAIR_KATS:
        pks.append(bls.interop_secret_key(idx).to_public_key().to_bytes())
        msgs.append(msg)
        sigs.append(bytes.fromhex(sig_hex))
    # a tampered copy: the first pair's signature under the second message
    pks.append(pks[1])
    msgs.append(msgs[2])
    sigs.append(sigs[1])
    args = (b"".join(pks), msgs, b"".join(sigs), DST_G2)
    ours = native.verify_sets(*args)
    assert ours == jnative.bls_verify_sets(*args) == [True, True, True, True, False]
    assert native.verify_sets(*args, threads=2) == ours


def test_verify_sets_keeps_later_sets_after_a_refused_one():
    """A set refused before its message is hashed (a signature that does
    not decode, a pubkey off the curve) must not shift the messages of the
    sets after it: one call over the batch gives each set's own verdict.
    (The JAX package's C tier advances its message offset only when it
    hashes, so there every later set of such a batch reads the wrong
    message.)"""
    from lodestar_tpu_torch.bls.fields import P

    sks = [bls.interop_secret_key(i) for i in range(6)]
    msgs = [bytes([0x50 + i]) * 32 for i in range(6)]
    pks = [sk.to_public_key().to_bytes() for sk in sks]
    sigs = [native.sign(sk.to_bytes(), m, DST_G2)[1] for sk, m in zip(sks, msgs)]
    bad = bytearray(sigs[1])
    bad[:48] = P.to_bytes(48, "big")  # x.c1 = p under valid flags: does not decode
    bad[0] |= 0x80 | (sigs[1][0] & 0x20)
    sigs[1] = bytes(bad)
    pks[3] = b"\xc0" + b"\x00" * 47  # the infinity pubkey: refused
    alone = [native.verify_sets(pk, [m], s, DST_G2)[0] for pk, m, s in zip(pks, msgs, sigs)]
    assert alone == [True, False, True, False, True, True]
    batch = native.verify_sets(b"".join(pks), msgs, b"".join(sigs), DST_G2)
    assert batch == alone
    assert native.verify_sets(b"".join(pks), msgs, b"".join(sigs), DST_G2, threads=3) == alone


INFINITY_G1 = b"\xc0" + b"\x00" * 47
INFINITY_G2 = b"\xc0" + b"\x00" * 95


def test_g1_aggregate_is_the_jax_compressed_sum():
    sks = keys(5, first=20)
    pks = [bls.PublicKey.from_bytes(native.sk_to_pk(sk.to_bytes())[1]) for sk in sks]
    for group in (pks[:1], pks[:2], pks, pks + pks[:1]):
        rc, agg = native.g1_aggregate(b"".join(pk.to_bytes() for pk in group))
        assert rc == 0
        assert agg == bls.aggregate_pubkeys(group).to_bytes()
    jrc, jlimbs = jnative.bls_g1_aggregate(b"".join(pk.to_bytes() for pk in pks), check_each=True)
    _, limbs = native.g1_decompress(native.g1_aggregate(
        b"".join(pk.to_bytes() for pk in pks), check_each=True)[1])
    assert jrc == 0
    np.testing.assert_array_equal(limbs, np.stack([jlimbs[0], jlimbs[1]]))
    # P + (−P) is infinity; an infinity key adds nothing; bad bytes are refused
    neg = bytearray(pks[0].to_bytes())
    neg[0] ^= 0x20
    assert native.g1_aggregate(pks[0].to_bytes() + bytes(neg)) == (1, INFINITY_G1)
    assert native.g1_aggregate(pks[1].to_bytes() + INFINITY_G1)[1] == pks[1].to_bytes()
    assert native.g1_aggregate(bytes([0x80]) + b"\xff" * 47)[0] < 0


def test_g2_aggregate_is_the_jax_sum():
    msg = b"\x33" * 32
    sigs = [native.sign(sk.to_bytes(), msg, DST_G2)[1] for sk in keys(4, first=30)]
    for group in (sigs[:1], sigs[:3], sigs + sigs[:1]):
        rc, agg = native.g2_aggregate(b"".join(group), check_each=True)
        want = bls.aggregate_signatures(
            [bls.Signature.from_bytes(s, validate=False) for s in group]).to_bytes()
        assert (rc, agg) == (0, want)
    neg = bytearray(sigs[0])
    neg[0] ^= 0x20
    assert native.g2_aggregate(sigs[0] + bytes(neg)) == (1, INFINITY_G2)
    assert native.g2_aggregate(sigs[2] + INFINITY_G2)[1] == sigs[2]
    bad = bytearray(sigs[0])
    bad[0] &= 0x7F
    assert native.g2_aggregate(bytes(bad))[0] == -1


def test_sha256_level_is_hashlib_and_the_jax_packages():
    import hashlib

    rng = np.random.default_rng(16)
    for n in (0, 1, 3, 64):
        data = rng.bytes(64 * n)
        want = b"".join(hashlib.sha256(data[64 * i: 64 * i + 64]).digest() for i in range(n))
        assert native.sha256_level(data) == want == jnative.sha256_level(data)


def test_bls_api_over_the_host_tier_matches_the_jax_api():
    """`lodestar_tpu_torch.bls.api`: interop keys, KeyValidate, the
    aggregates' bytes, `verify` and `fast_aggregate_verify` as the JAX
    API answers them."""
    from lodestar_tpu_torch.bls import api as papi

    sks, jsks = [papi.interop_secret_key(i) for i in range(3)], keys(3)
    assert [sk.to_bytes() for sk in sks] == [sk.to_bytes() for sk in jsks]
    pks = [sk.to_public_key() for sk in sks]
    assert [pk.to_bytes() for pk in pks] == [
        native.sk_to_pk(sk.to_bytes())[1] for sk in jsks]
    msg = b"\x5c" * 32
    sigs = [sk.sign(msg) for sk in sks]
    assert [s.to_bytes() for s in sigs] == [
        jnative.bls_sign(sk.to_bytes(), msg, DST_G2)[1] for sk in jsks]
    jpks = [bls.PublicKey.from_bytes(pk.to_bytes()) for pk in pks]
    assert papi.aggregate_pubkeys(pks).to_bytes() == bls.aggregate_pubkeys(jpks).to_bytes()
    agg = papi.aggregate_signatures(sigs)
    assert agg.to_bytes() == bls.aggregate_signatures(
        [bls.Signature.from_bytes(s.to_bytes(), validate=False) for s in sigs]).to_bytes()
    assert papi.fast_aggregate_verify(pks, msg, agg)
    assert not papi.fast_aggregate_verify(pks[:2], msg, agg)
    assert not papi.fast_aggregate_verify([], msg, agg)
    assert papi.verify(pks[0], msg, sigs[0]) and not papi.verify(pks[1], msg, sigs[0])
    # KeyValidate refuses infinity and a key off the curve; a signature
    # must decode; an infinity signature never verifies
    for bad in (INFINITY_G1, bytes([0x80]) + b"\xff" * 47):
        with pytest.raises(papi.BlsError):
            papi.PublicKey.from_bytes(bad)
    assert papi.PublicKey.from_bytes(INFINITY_G1, validate=False).to_bytes() == INFINITY_G1
    flagless = bytearray(sigs[0].to_bytes())
    flagless[0] &= 0x7F
    with pytest.raises(papi.BlsError):
        papi.Signature.from_bytes(bytes(flagless))
    assert not papi.verify(pks[0], msg, papi.Signature.from_bytes(INFINITY_G2))
    with pytest.raises(papi.BlsError):
        papi.aggregate_pubkeys([])

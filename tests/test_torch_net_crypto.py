"""The network's own primitives (`lodestar_tpu_torch/network/crypto.py` and
the C AEAD of `csrc/host/chacha20poly1305.c`): the RFC vectors, seeded
random inputs byte-equal to the `cryptography` wheel the JAX transport
uses, and tampered tags, ciphertexts and signatures refused."""

import random

import pytest

from lodestar_tpu_torch import native
from lodestar_tpu_torch.network import crypto

h = bytes.fromhex

# RFC 7748 §5.2: (scalar, u, output)
X25519_VECTORS = [
    ("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4",
     "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c",
     "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"),
    ("4b66e9d4d1b4673c5ad22691957d6af5c11b6421e0ea01d42ca4169e7918ba0d",
     "e5210f12786811d3f4b7959d0538ae2c31dbe7106fc03c3efc4cd549c715a493",
     "95cbde9476e8907d7aade45cb4b873f88b595a68799fa152e6f8f7647aac7957"),
]

# RFC 8032 §7.1 tests 1-3: (secret key, public key, message, signature)
ED25519_VECTORS = [
    ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
     "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a", "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
     "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
     "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c", "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
     "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
    ("c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
     "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025", "af82",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
     "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a"),
]

# RFC 5869 A.1-A.3: (ikm, salt, info, length, okm)
HKDF_VECTORS = [
    (b"\x0b" * 22, h("000102030405060708090a0b0c"), h("f0f1f2f3f4f5f6f7f8f9"), 42,
     "3cb25f25faacd57a90434f64d0362f2a2d2d0a90cf1a5a4c5db02d56ecc4c5bf34007208d5b887185865"),
    (bytes(range(0x50)), bytes(range(0x60, 0xB0)), bytes(range(0xB0, 0x100)), 82,
     "b11e398dc80327a1c8e7f78c596a49344f012eda2d4efad8a050cc4c19afa97c"
     "59045a99cac7827271cb41c65e590e09da3275600c2f09b8367793a9aca3db71"
     "cc30c58179ec3e87c14c01d5c1f3434f1d87"),
    (b"\x0b" * 22, b"", b"", 42,
     "8da4e775a563c18f715f802a063c5a31b8a11f5c5ee1879ec3454e5f3c738d2d9d201395faa4b61a96c8"),
]

# RFC 8439 §2.8.2
AEAD_KEY = h("808182838485868788898a8b8c8d8e8f909192939495969798999a9b9c9d9e9f")
AEAD_NONCE = h("070000004041424344454647")
AEAD_AAD = h("50515253c0c1c2c3c4c5c6c7")
AEAD_PT = (b"Ladies and Gentlemen of the class of '99: If I could offer you only one "
           b"tip for the future, sunscreen would be it.")
AEAD_CT = h("d31a8d34648e60db7b86afbc53ef7ec2a4aded51296e08fea9e2b5a736ee62d6"
            "3dbea45e8ca9671282fafb69da92728b1a71de0a9e060b2905d6a5b67ecd3b36"
            "92ddbd7f2d778b8c9803aee328091b58fab324e4fad675945585808b4831d7bc"
            "3ff4def08e4b7a9de576d26586cec64b6116")
AEAD_TAG = h("1ae10b594f09e26a7e902ecbd0600691")


@pytest.mark.parametrize("scalar,u,out", X25519_VECTORS)
def test_x25519_rfc7748_section_5_2(scalar, u, out):
    assert crypto.x25519(h(scalar), h(u)) == h(out)


def test_x25519_rfc7748_iterated_1000():
    k = u = bytes([9]) + bytes(31)
    for i in range(1000):
        k, u = crypto.x25519(k, u), k
        if i == 0:
            assert k.hex() == "422c8e7a6227d7bca1350b3e2bb7279f7897b87bb6854b783c60e80311ae3079"
    assert k.hex() == "684cf59ba83309552800ef566f2f4d3c1c3887c49360e3875f2eb94d99532c51"


def test_x25519_rfc7748_section_6_1():
    alice = h("77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a")
    bob = h("5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb")
    alice_pub, bob_pub = crypto.x25519_public(alice), crypto.x25519_public(bob)
    assert alice_pub.hex() == "8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a"
    assert bob_pub.hex() == "de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f"
    shared = "4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742"
    assert crypto.x25519(alice, bob_pub).hex() == shared
    assert crypto.x25519(bob, alice_pub).hex() == shared


def test_x25519_refuses_a_low_order_point():
    with pytest.raises(ValueError):
        crypto.x25519(bytes(range(32)), bytes(32))


@pytest.mark.parametrize("sk,pk,msg,sig", ED25519_VECTORS)
def test_ed25519_rfc8032_section_7_1(sk, pk, msg, sig):
    assert crypto.ed25519_public(h(sk)) == h(pk)
    assert crypto.ed25519_sign(h(sk), h(msg)) == h(sig)
    assert crypto.ed25519_verify(h(pk), h(sig), h(msg))


@pytest.mark.parametrize("ikm,salt,info,length,okm", HKDF_VECTORS)
def test_hkdf_rfc5869_appendix_a(ikm, salt, info, length, okm):
    assert crypto.hkdf_sha256(ikm, salt, info, length) == h(okm)


def test_chacha20_poly1305_rfc8439_section_2_8_2():
    aead = crypto.ChaCha20Poly1305(AEAD_KEY)
    assert aead.encrypt(AEAD_NONCE, AEAD_PT, AEAD_AAD) == AEAD_CT + AEAD_TAG
    assert aead.decrypt(AEAD_NONCE, AEAD_CT + AEAD_TAG, AEAD_AAD) == AEAD_PT


@pytest.mark.parametrize("seed", range(4))
def test_primitives_equal_cryptography_on_seeded_inputs(seed):
    cg = pytest.importorskip("cryptography")  # noqa: F841
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey,
        X25519PublicKey,
    )
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
    from cryptography.hazmat.primitives.kdf.hkdf import HKDF

    rng = random.Random(seed)

    def rand(n):
        return bytes(rng.getrandbits(8) for _ in range(n))

    for i in range(3):
        sk, msg = rand(32), rand(rng.randrange(0, 300))
        ref = Ed25519PrivateKey.from_private_bytes(sk)
        pub = ref.public_key().public_bytes_raw()
        assert crypto.ed25519_public(sk) == pub
        assert crypto.ed25519_sign(sk, msg) == ref.sign(msg)
        assert crypto.ed25519_verify(pub, ref.sign(msg), msg)
        a, b = rand(32), rand(32)
        ref_a = X25519PrivateKey.from_private_bytes(a)
        assert crypto.x25519_public(a) == ref_a.public_key().public_bytes_raw()
        b_pub = crypto.x25519_public(b)
        assert crypto.x25519(a, b_pub) == ref_a.exchange(X25519PublicKey.from_public_bytes(b_pub))
        ikm, salt, info, n = rand(40), rand(rng.randrange(0, 40)), rand(12), rng.randrange(1, 200)
        assert crypto.hkdf_sha256(ikm, salt, info, n) == HKDF(
            algorithm=hashes.SHA256(), length=n, salt=salt, info=info).derive(ikm)
    for n in (0, 1, 15, 16, 17, 63, 64, 65, 1000, 70_000):
        key, nonce, aad, pt = rand(32), rand(12), rand(rng.randrange(0, 40)), rand(n)
        ct = native.aead_seal(key, nonce, pt, aad)
        assert ct == ChaCha20Poly1305(key).encrypt(nonce, pt, aad)
        assert native.aead_open(key, nonce, ct, aad) == pt


def test_tampered_tag_ciphertext_or_signature_is_refused():
    aead = crypto.ChaCha20Poly1305(AEAD_KEY)
    sealed = AEAD_CT + AEAD_TAG
    for at in (0, len(AEAD_CT) // 2, len(AEAD_CT) - 1, len(AEAD_CT), len(sealed) - 1):
        bad = bytearray(sealed)
        bad[at] ^= 0x01
        with pytest.raises(crypto.InvalidTag):
            aead.decrypt(AEAD_NONCE, bytes(bad), AEAD_AAD)
    with pytest.raises(crypto.InvalidTag):
        aead.decrypt(AEAD_NONCE, sealed, AEAD_AAD + b"x")
    with pytest.raises(crypto.InvalidTag):
        aead.decrypt(AEAD_NONCE, AEAD_TAG[:15], b"")
    sk, pk, msg, sig = (h(x) for x in ED25519_VECTORS[2])
    for at in (0, 31, 32, 63):
        bad = bytearray(sig)
        bad[at] ^= 0x04
        assert not crypto.ed25519_verify(pk, bytes(bad), msg)
    assert not crypto.ed25519_verify(pk, sig, msg + b"\x00")
    assert not crypto.ed25519_verify(crypto.ed25519_public(bytes(32)), sig, msg)
    # S ≥ L is refused, as RFC 8032 §5.1.7 asks
    s = int.from_bytes(sig[32:], "little") + crypto.L
    assert not crypto.ed25519_verify(pk, sig[:32] + s.to_bytes(32, "little"), msg)
    assert not crypto.ed25519_verify(pk, sig[:63], msg)

"""The port's EIP-2335 keystores (`validator/keystore.py`) over the host
tier's C AES-128-CTR (`csrc/host/aes128ctr.c`, `native.aes128ctr`),
against the JAX package's `validator/keystore.py` (which takes AES from
the `cryptography` wheel) and the keystore half of
`tests/test_node_validator_cli.py` (`test_keystore_roundtrip`).

The cipher is held to NIST SP 800-38A F.5.1 (CTR-AES128.Encrypt, cited
from the standard) and to the wheel on seeded random keys, counter blocks
and lengths from 0 to 97 bytes, counters that wrap past 2^64 and 2^128
among them. Keystores go both ways between the packages for PBKDF2 and
scrypt. Tolerance: byte-equality throughout.
"""

import json

import numpy as np
import pytest

pytest.importorskip("cryptography")  # the JAX keystores' AES

from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

from lodestar_tpu.validator import keystore as jks
from lodestar_tpu_torch import native
from lodestar_tpu_torch.bls import api as bls
from lodestar_tpu_torch.validator import keystore as ks

# NIST SP 800-38A, Appendix F.5.1: CTR-AES128.Encrypt
NIST_KEY = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
NIST_CTR = bytes.fromhex("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff")
NIST_PLAIN = bytes.fromhex(
    "6bc1bee22e409f96e93d7e117393172a" "ae2d8a571e03ac9c9eb76fac45af8e51"
    "30c81c46a35ce411e5fbc1191a0a52ef" "f69f2445df4f9b17ad2b417be66c3710")
NIST_CIPHER = bytes.fromhex(
    "874d6191b620e3261bef6864990db6ce" "9806f66b7970fdff8617187bb9fffdff"
    "5ae4df3edbd5d35e5b4f09020db03eab" "1e031dda2fbe03d1792170a0f3009cee")

SECRET = bls.interop_secret_key(7).to_bytes()
# a password with a control code and text NFKD rewrites (EIP-2335's own
# example: mathematical letters normalize to ASCII)
ODD_PASSWORD = "\U0001d531\U0001d522\U0001d530\U0001d531pass\x7fwordé\x01\U0001f511"
ODD_NORMAL = "testpasswordé\U0001f511"  # é precomposed: NFKD splits it
ODD_NFKD = "testpassworde\u0301\U0001f511"


def _wheel(key: bytes, iv: bytes, data: bytes) -> bytes:
    enc = Cipher(algorithms.AES(key), modes.CTR(iv)).encryptor()
    return enc.update(data) + enc.finalize()


def test_aes128ctr_nist_vector():
    assert native.aes128ctr(NIST_KEY, NIST_CTR, NIST_PLAIN) == NIST_CIPHER
    assert native.aes128ctr(NIST_KEY, NIST_CTR, NIST_CIPHER) == NIST_PLAIN
    assert native.aes128ctr(NIST_KEY, NIST_CTR, NIST_PLAIN[:16]) == NIST_CIPHER[:16]


@pytest.mark.parametrize("counter", ["random", "wrap64", "wrap128"])
def test_aes128ctr_equals_the_wheel(counter):
    rng = np.random.default_rng(20261018)
    for length in range(0, 98):
        key = rng.bytes(16)
        iv = bytearray(rng.bytes(16))
        if counter == "wrap64":  # the low 64 bits wrap inside the message
            iv[8:] = (2**64 - 2).to_bytes(8, "big")
        elif counter == "wrap128":  # the whole block wraps to zero
            iv[:] = (2**128 - 3).to_bytes(16, "big")
        data = rng.bytes(length)
        assert native.aes128ctr(key, bytes(iv), data) == _wheel(key, bytes(iv), data), length


def test_aes128ctr_refuses_bad_sizes():
    with pytest.raises(ValueError):
        native.aes128ctr(b"\x00" * 15, b"\x00" * 16, b"x")
    with pytest.raises(ValueError):
        native.aes128ctr(b"\x00" * 16, b"\x00" * 12, b"x")


@pytest.mark.parametrize("kdf", ["pbkdf2", "scrypt"])
def test_port_and_jax_decrypt_each_other(kdf):
    port_made = ks.encrypt_keystore(SECRET, "pw", path="m/12381/3600/7/0/0", kdf=kdf)
    jax_made = jks.encrypt_keystore(SECRET, "pw", path="m/12381/3600/7/0/0", kdf=kdf)
    for made in (port_made, jax_made):
        assert made["crypto"]["kdf"]["function"] == kdf
        assert ks.decrypt_keystore(made, "pw") == SECRET
        assert jks.decrypt_keystore(made, "pw") == SECRET
    assert port_made["pubkey"] == jax_made["pubkey"]
    assert port_made.keys() == jax_made.keys()
    assert port_made["crypto"]["cipher"]["function"] == "aes-128-ctr"
    # the same derived key and counter block give the same bytes in both
    rewritten = json.loads(json.dumps(jax_made))
    dk = ks._derive_key(rewritten["crypto"]["kdf"], ks._normalize_password("pw"))
    iv = bytes.fromhex(rewritten["crypto"]["cipher"]["params"]["iv"])
    assert native.aes128ctr(dk[:16], iv, SECRET).hex() == rewritten["crypto"]["cipher"]["message"]


def test_wrong_password_raises_in_both():
    made = ks.encrypt_keystore(SECRET, "right")
    with pytest.raises(ks.KeystoreError):
        ks.decrypt_keystore(made, "wrong")
    with pytest.raises(jks.KeystoreError):
        jks.decrypt_keystore(made, "wrong")
    with pytest.raises(ks.KeystoreError):
        ks.decrypt_keystore(jks.encrypt_keystore(SECRET, "right"), "wrong")


def test_password_normalization():
    assert ks._normalize_password(ODD_PASSWORD) == jks._normalize_password(ODD_PASSWORD)
    assert ks._normalize_password(ODD_PASSWORD) == ODD_NFKD.encode()
    assert ks._normalize_password(ODD_NORMAL) == ODD_NFKD.encode()
    made = ks.encrypt_keystore(SECRET, ODD_PASSWORD)
    assert jks.decrypt_keystore(made, ODD_NORMAL) == SECRET
    assert ks.decrypt_keystore(jks.encrypt_keystore(SECRET, ODD_NORMAL), ODD_PASSWORD) == SECRET


def test_unsupported_kdf():
    made = ks.encrypt_keystore(SECRET, "pw")
    made["crypto"]["kdf"]["function"] = "argon2"
    with pytest.raises(ks.KeystoreError):
        ks.decrypt_keystore(made, "pw")


def test_load_keystores_dir(tmp_path):
    secrets = [bls.interop_secret_key(i).to_bytes() for i in (3, 4)]
    (tmp_path / "keystore-0.json").write_text(json.dumps(ks.encrypt_keystore(secrets[0], "pw")))
    (tmp_path / "keystore-1.json").write_text(json.dumps(jks.encrypt_keystore(secrets[1], "pw")))
    (tmp_path / "deposit_data.json").write_text(json.dumps({"no": "crypto"}))
    (tmp_path / "notes.txt").write_text("not a keystore")
    got = ks.load_keystores_dir(str(tmp_path), "pw")
    want = jks.load_keystores_dir(str(tmp_path), "pw")
    assert [sk.to_bytes() for sk in got] == secrets
    assert [sk.value for sk in got] == [sk.value for sk in want]
    # a keystore whose pubkey is not its secret's
    other = ks.encrypt_keystore(bls.interop_secret_key(5).to_bytes(), "pw")
    other["pubkey"] = bls.interop_secret_key(6).to_public_key().to_bytes().hex()
    (tmp_path / "keystore-2.json").write_text(json.dumps(other))
    with pytest.raises(ks.KeystoreError, match="pubkey mismatch"):
        ks.load_keystores_dir(str(tmp_path), "pw")
    with pytest.raises(jks.KeystoreError, match="pubkey mismatch"):
        jks.load_keystores_dir(str(tmp_path), "pw")

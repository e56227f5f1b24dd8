"""EIP-2335 BLS keystores (encrypt/decrypt) + keystore directory loading:
the port's copy of the JAX package's `validator/keystore.py`.

Reference: the CLI's keystore management (`cli/src/cmds/validator` import
flows via @chainsafe/bls-keystore) — scrypt or pbkdf2 KDF, AES-128-CTR
cipher, sha256 checksum. Round-trips with web3signer/eth2.0-deposit-cli
keystores. The KDFs are `hashlib`'s; the cipher is the host tier's C
AES-128-CTR (`native.aes128ctr`), where the JAX package takes it from the
`cryptography` wheel.
"""

from __future__ import annotations

import hashlib
import json
import os
import secrets
import unicodedata
import uuid

from .. import native
from ..bls import api as bls


class KeystoreError(Exception):
    pass


def _normalize_password(password: str) -> bytes:
    """EIP-2335: NFKD normalize, strip C0/C1/Delete control codes."""
    norm = unicodedata.normalize("NFKD", password)
    return "".join(c for c in norm if unicodedata.category(c) != "Cc").encode()


def _derive_key(kdf: dict, password: bytes) -> bytes:
    params = kdf["params"]
    salt = bytes.fromhex(params["salt"])
    if kdf["function"] == "scrypt":
        return hashlib.scrypt(
            password,
            salt=salt,
            n=params["n"],
            r=params["r"],
            p=params["p"],
            dklen=params["dklen"],
            maxmem=2**31 - 1,
        )
    if kdf["function"] == "pbkdf2":
        return hashlib.pbkdf2_hmac(
            "sha256", password, salt, params["c"], dklen=params["dklen"]
        )
    raise KeystoreError(f"unsupported kdf {kdf['function']}")


def decrypt_keystore(keystore: dict, password: str) -> bytes:
    """→ the 32-byte BLS secret scalar."""
    crypto = keystore["crypto"]
    dk = _derive_key(crypto["kdf"], _normalize_password(password))
    ciphertext = bytes.fromhex(crypto["cipher"]["message"])
    checksum = hashlib.sha256(dk[16:32] + ciphertext).digest()
    if checksum.hex() != crypto["checksum"]["message"]:
        raise KeystoreError("wrong password (checksum mismatch)")
    iv = bytes.fromhex(crypto["cipher"]["params"]["iv"])
    return native.aes128ctr(dk[:16], iv, ciphertext)


def encrypt_keystore(
    secret: bytes, password: str, path: str = "", kdf: str = "pbkdf2"
) -> dict:
    """EIP-2335 JSON for a 32-byte secret (pbkdf2 default: fast enough for
    tests; scrypt for production-grade)."""
    salt = secrets.token_bytes(32)
    if kdf == "scrypt":
        kdf_module = {
            "function": "scrypt",
            "params": {"dklen": 32, "n": 262144, "r": 8, "p": 1, "salt": salt.hex()},
            "message": "",
        }
    else:
        kdf_module = {
            "function": "pbkdf2",
            "params": {"dklen": 32, "c": 262144, "prf": "hmac-sha256", "salt": salt.hex()},
            "message": "",
        }
    dk = _derive_key(kdf_module, _normalize_password(password))
    iv = secrets.token_bytes(16)
    ciphertext = native.aes128ctr(dk[:16], iv, secret)
    sk = bls.SecretKey.from_bytes(secret)
    return {
        "crypto": {
            "kdf": kdf_module,
            "checksum": {
                "function": "sha256",
                "params": {},
                "message": hashlib.sha256(dk[16:32] + ciphertext).digest().hex(),
            },
            "cipher": {
                "function": "aes-128-ctr",
                "params": {"iv": iv.hex()},
                "message": ciphertext.hex(),
            },
        },
        "path": path,
        "pubkey": sk.to_public_key().to_bytes().hex(),
        "uuid": str(uuid.uuid4()),
        "version": 4,
    }


def load_keystores_dir(directory: str, password: str) -> list[bls.SecretKey]:
    """Import every keystore-*.json under `directory` (reference: keystore
    import flow, one shared password file)."""
    out = []
    for name in sorted(os.listdir(directory)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(directory, name)) as f:
            ks = json.load(f)
        if "crypto" not in ks:
            continue
        secret = decrypt_keystore(ks, password)
        sk = bls.SecretKey.from_bytes(secret)
        expected = ks.get("pubkey")
        if expected and sk.to_public_key().to_bytes().hex() != expected:
            raise KeystoreError(f"{name}: pubkey mismatch after decrypt")
        out.append(sk)
    return out

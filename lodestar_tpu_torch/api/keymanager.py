"""Keymanager API (EIP-3030-style key management surface): the port's copy
of the JAX package's `api/keymanager.py`, over the port's `api/server.py`
route table.

Reference: `api/src/keymanager/` routes + `validator` keymanager server —
list/import/delete local keystores, list/import/delete remote keys, and
slashing-protection interchange export on delete. Served on the VALIDATOR
process, guarded by a bearer token (generated when none is given).
"""

from __future__ import annotations


from ..validator.keystore import KeystoreError, decrypt_keystore
from .impl import ApiError
from .routes import Route

KEYMANAGER_ROUTES: list[Route] = [
    Route("listKeys", "GET", "/eth/v1/keystores"),
    Route("importKeystores", "POST", "/eth/v1/keystores"),
    Route("deleteKeys", "DELETE", "/eth/v1/keystores"),
    Route("listRemoteKeys", "GET", "/eth/v1/remotekeys"),
    Route("importRemoteKeys", "POST", "/eth/v1/remotekeys"),
    Route("deleteRemoteKeys", "DELETE", "/eth/v1/remotekeys"),
]


def match_keymanager_route(method: str, path: str):
    parts = path.rstrip("/").split("/")
    for route in KEYMANAGER_ROUTES:
        if route.method != method:
            continue
        if route.path.split("/") == parts:
            return route, {}
    return None, {}


class KeymanagerApiImpl:
    """Binds the keymanager routes to a ValidatorStore (+ optional
    external-signer clients for remote keys)."""

    def __init__(self, store, signer_factory=None):
        self.store = store
        # url → client factory for remote key import
        self.signer_factory = signer_factory

    # -- local keystores ------------------------------------------------------

    def listKeys(self, params, query, body):
        return [
            {"validating_pubkey": "0x" + pk.hex(), "derivation_path": "", "readonly": False}
            for pk in self.store.pubkeys
            if pk in self.store._keys
        ]

    def importKeystores(self, params, query, body):
        import json as _json

        from ..bls import api as bls

        keystores = body.get("keystores", [])
        passwords = body.get("passwords", [])
        if len(passwords) not in (1, len(keystores)):
            raise ApiError(400, "passwords must match keystores")
        # EIP-3076 interchange travels with the keys so migrated validators
        # keep their anti-slashing history (keymanager spec importKeystores)
        interchange = body.get("slashing_protection")
        if interchange:
            obj = _json.loads(interchange) if isinstance(interchange, str) else interchange
            slashing = getattr(self.store, "protection", None)
            if slashing is not None:
                slashing.import_interchange(obj)
        statuses = []
        for i, raw in enumerate(keystores):
            ks = _json.loads(raw) if isinstance(raw, str) else raw
            password = passwords[i] if i < len(passwords) else passwords[0]
            try:
                secret = decrypt_keystore(ks, password)
                sk = bls.SecretKey.from_bytes(secret)
                pk = sk.to_public_key().to_bytes()
                if self.store.has_pubkey(pk):
                    statuses.append({"status": "duplicate", "message": ""})
                else:
                    self.store.add_secret_key(sk)
                    statuses.append({"status": "imported", "message": ""})
            except (KeystoreError, ValueError) as e:
                statuses.append({"status": "error", "message": str(e)})
        return statuses

    def deleteKeys(self, params, query, body):
        statuses = []
        deleted = []
        for pk_hex in body.get("pubkeys", []):
            pk = bytes.fromhex(pk_hex.removeprefix("0x"))
            if self.store.remove_key(pk):
                statuses.append({"status": "deleted", "message": ""})
                deleted.append(pk)
            else:
                statuses.append({"status": "not_found", "message": ""})
        # EIP-3076 interchange for the deleted keys (reference exports the
        # slashing history so the keys can move safely)
        gvr = getattr(self.store.config, "genesis_validators_root", b"\x00" * 32)
        interchange = self.store.protection.export_interchange(gvr, deleted)
        return {"statuses": statuses, "slashing_protection": interchange}

    # -- remote keys ----------------------------------------------------------

    def listRemoteKeys(self, params, query, body):
        return [
            {"pubkey": "0x" + pk.hex(), "url": "", "readonly": False}
            for pk in self.store.pubkeys
            if pk in self.store._remote
        ]

    def importRemoteKeys(self, params, query, body):
        if self.signer_factory is None:
            raise ApiError(501, "no external signer factory configured")
        statuses = []
        for entry in body.get("remote_keys", []):
            pk = bytes.fromhex(entry["pubkey"].removeprefix("0x"))
            try:
                self.store.add_remote_key(pk, self.signer_factory(entry.get("url", "")))
                statuses.append({"status": "imported", "message": ""})
            except Exception as e:
                statuses.append({"status": "error", "message": str(e)})
        return statuses

    def deleteRemoteKeys(self, params, query, body):
        statuses = []
        for pk_hex in body.get("pubkeys", []):
            pk = bytes.fromhex(pk_hex.removeprefix("0x"))
            statuses.append(
                {"status": "deleted" if self.store.remove_key(pk) else "not_found",
                 "message": ""}
            )
        return statuses


def create_keymanager_server(store, host: str = "127.0.0.1", port: int = 0,
                             signer_factory=None, bearer_token: str | None = None,
                             token_file: str | None = None):
    """Keymanager REST server. The reference REQUIRES bearer auth here
    (`api/rest/index.ts` keymanager registration): if no token is given,
    one is generated; `token_file` persists it (reference writes
    `api-token.txt` under the datadir) so operators can find it."""
    from .server import BeaconApiServer

    if bearer_token is None:
        import secrets as _secrets

        bearer_token = "api-token-0x" + _secrets.token_hex(16)
        from ..utils.logger import get_logger

        if token_file is not None:
            get_logger("keymanager").info(
                "generated keymanager bearer token; written to %s", token_file
            )
        else:
            # never log the secret itself (it would persist a live
            # credential in log history) and never write files the
            # caller didn't ask for — point the operator at the handle
            get_logger("keymanager").warning(
                "generated keymanager bearer token but no token_file was "
                "given: pass token_file to persist it (the CLI wires "
                "<datadir>.api-token.txt); available as server.bearer_token"
            )
    if token_file is not None:
        import os

        # owner-only from creation — no world-readable window
        fd = os.open(token_file, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w") as f:
            f.write(bearer_token + "\n")
    impl = KeymanagerApiImpl(store, signer_factory)
    server = BeaconApiServer(
        impl, host=host, port=port, matcher=match_keymanager_route,
        bearer_token=bearer_token,
    )
    server.bearer_token = bearer_token
    server.token_file = token_file
    return server

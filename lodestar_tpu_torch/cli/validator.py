"""`validator` command: run a validator client against a beacon node.

Reference: `cli/src/cmds/validator` — keys from interop range, keystore
directory, or an external signer; duty loop over the Beacon API; EIP-3076
slashing-protection db in the datadir.

The port's copy of the JAX package's `cli/validator.py`. The client does no
device work (it signs on the host tier), so it takes no `--device`; the
beacon node it talks to verifies its blocks on the card.
"""

from __future__ import annotations

import signal
import time
from urllib.parse import urlparse

from ..api.client import BeaconApiClient
from ..bls import api as bls
from ..config.beacon_config import BeaconConfig
from ..config.chain_config import MAINNET_CHAIN_CONFIG, MINIMAL_CHAIN_CONFIG
from ..db.controller import FileDb, MemoryDb
from ..params.presets import MAINNET, MINIMAL
from ..types import get_types
from ..utils.logger import get_logger
from ..validator import SlashingProtection, ValidatorStore
from ..validator.doppelganger import DoppelgangerService
from ..validator.rest_service import RestValidatorService


def _client_for(url: str) -> BeaconApiClient:
    parsed = urlparse(url if "//" in url else f"http://{url}")
    return BeaconApiClient(parsed.hostname, parsed.port or 5052)


def run_validator(args) -> int:
    log = get_logger("validator-cli")
    preset, chain_config = (
        (MINIMAL, MINIMAL_CHAIN_CONFIG)
        if args.network == "minimal-dev"
        else (MAINNET, MAINNET_CHAIN_CONFIG)
    )
    client = _client_for(args.beacon_url)
    genesis = client.getGenesis()
    config = BeaconConfig(
        chain_config,
        bytes.fromhex(genesis["genesis_validators_root"].removeprefix("0x")),
        preset,
    )
    types = get_types(preset).phase0

    controller = FileDb(args.datadir) if args.datadir else MemoryDb()
    store = ValidatorStore(config, SlashingProtection(controller))

    if args.interop_keys:
        lo, _, hi = args.interop_keys.partition(":")
        for i in range(int(lo), int(hi or int(lo) + 1)):
            store.add_secret_key(bls.interop_secret_key(i))
    if args.keystores_dir:
        from ..validator.keystore import load_keystores_dir

        password = ""
        if args.keystores_password_file:
            with open(args.keystores_password_file) as f:
                password = f.read().strip()
        for sk in load_keystores_dir(args.keystores_dir, password):
            store.add_secret_key(sk)
    if args.external_signer_url:
        from ..validator.external_signer import ExternalSignerClient

        parsed = urlparse(
            args.external_signer_url
            if "//" in args.external_signer_url
            else f"http://{args.external_signer_url}"
        )
        signer = ExternalSignerClient(parsed.hostname, parsed.port or 9000)
        for pk in signer.list_pubkeys():
            store.add_remote_key(pk, signer)
    if not store.pubkeys:
        log.error("no keys: pass --interop-keys, --keystores-dir, or --external-signer-url")
        return 1
    log.info("%d validator keys loaded", len(store.pubkeys))

    keymanager_server = None
    if args.keymanager:
        from ..api.keymanager import create_keymanager_server

        # args.datadir is the FileDb log FILE path, not a directory —
        # the token lives beside it as <datadir>.api-token.txt
        token_file = args.datadir + ".api-token.txt" if args.datadir else None
        keymanager_server = create_keymanager_server(
            store, port=args.keymanager_port, token_file=token_file
        )
        keymanager_server.start()
        log.info(
            "keymanager API on port %d (token file: %s)",
            keymanager_server.port,
            keymanager_server.token_file,
        )

    try:
        doppelganger = DoppelgangerService() if args.doppelganger else None
        service = RestValidatorService(config, types, client, store, doppelganger)
        genesis_time = int(genesis["genesis_time"])
        if doppelganger is not None:
            current_epoch = max(
                0,
                int(time.time() - genesis_time)
                // (config.SECONDS_PER_SLOT * preset.SLOTS_PER_EPOCH),
            )
            service.resolve_indices()
            for idx in service._indices.values():
                doppelganger.register(idx, current_epoch)

        stop = {"flag": False}
        signal.signal(signal.SIGINT, lambda s, f: stop.update(flag=True))
        spt = config.SECONDS_PER_SLOT
        last_slot = -1
        deadline = time.time() + args.run_seconds if args.run_seconds else None
        while not stop["flag"]:
            now = time.time()
            if deadline and now >= deadline:
                break
            slot = max(0, int(now - genesis_time) // spt)
            if slot != last_slot:
                try:
                    service.on_slot(slot)
                except Exception as e:
                    log.error("slot %d: %s", slot, e)
                last_slot = slot
            time.sleep(min(0.2, spt / 10))
        return 0
    finally:
        if keymanager_server is not None:
            keymanager_server.close()


def add_validator_parser(sub) -> None:
    p = sub.add_parser("validator", help="run a validator client")
    p.add_argument("--network", default="minimal-dev", choices=["minimal-dev", "mainnet"])
    p.add_argument("--beacon-url", default="http://127.0.0.1:5052")
    p.add_argument("--datadir", default=None, help="slashing-protection db path")
    p.add_argument("--interop-keys", default=None, help="interop key range lo:hi")
    p.add_argument("--keystores-dir", default=None, help="EIP-2335 keystore directory")
    p.add_argument("--keystores-password-file", default=None)
    p.add_argument("--external-signer-url", default=None, help="web3signer-compatible endpoint")
    p.add_argument("--doppelganger", action="store_true", help="enable doppelganger protection")
    p.add_argument("--keymanager", action="store_true", help="serve the keymanager API")
    p.add_argument("--keymanager-port", type=int, default=5062)
    p.add_argument("--run-seconds", type=float, default=0)
    p.set_defaults(func=run_validator)

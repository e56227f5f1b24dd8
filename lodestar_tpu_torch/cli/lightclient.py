"""`lightclient` command: follow the chain with merkle-proof verification
only (no state transition).

Reference: `cli/src/cmds/lightclient` — bootstrap from a trusted block
root via the Beacon API, then poll updates per sync-committee period and
optimistic/finality updates per slot.

The port's copy of the JAX package's `cli/lightclient.py`: the client does
no device work (merkle branches in Python, the sync aggregate's signature
on the C host tier), so it takes no `--device`. The `minimal-dev` network
is `MINIMAL_CHAIN_CONFIG`, whose Altair epoch is far in the future, so a
`beacon --network minimal-dev` node serves no light-client data; the
command follows a node whose chain is Altair from genesis.
"""

from __future__ import annotations

import signal
import time
from urllib.parse import urlparse

from ..api.client import BeaconApiClient
from ..config.beacon_config import BeaconConfig
from ..config.chain_config import MAINNET_CHAIN_CONFIG, MINIMAL_CHAIN_CONFIG
from ..light_client import Lightclient
from ..params.presets import MAINNET, MINIMAL
from ..types import get_types
from ..utils.logger import get_logger


def run_lightclient(args) -> int:
    log = get_logger("lightclient-cli")
    preset, chain_config = (
        (MINIMAL, MINIMAL_CHAIN_CONFIG)
        if args.network == "minimal-dev"
        else (MAINNET, MAINNET_CHAIN_CONFIG)
    )
    parsed = urlparse(
        args.beacon_url if "//" in args.beacon_url else f"http://{args.beacon_url}"
    )
    client = BeaconApiClient(parsed.hostname, parsed.port or 5052)
    genesis = client.getGenesis()
    config = BeaconConfig(
        chain_config,
        bytes.fromhex(genesis["genesis_validators_root"].removeprefix("0x")),
        preset,
    )
    t = get_types(preset).altair
    lc = Lightclient(config, t, preset)

    trusted_root = bytes.fromhex(args.trusted_block_root.removeprefix("0x"))
    boot_obj = client.getLightClientBootstrap("0x" + trusted_root.hex())
    lc.bootstrap(trusted_root, t.LightClientBootstrap.from_obj(boot_obj))
    log.info("bootstrapped at slot %d", lc.optimistic_header.slot)

    stop = {"flag": False}
    signal.signal(signal.SIGINT, lambda s, f: stop.update(flag=True))
    deadline = time.time() + args.run_seconds if args.run_seconds else None
    period_len = preset.SLOTS_PER_EPOCH * preset.EPOCHS_PER_SYNC_COMMITTEE_PERIOD
    while not stop["flag"]:
        if deadline and time.time() >= deadline:
            break
        try:
            period = lc.optimistic_header.slot // period_len
            for obj in client.getLightClientUpdatesByRange(
                query={"start_period": period, "count": 4}
            ) or []:
                lc.process_update(t.LightClientUpdate.from_obj(obj))
        except Exception as e:
            log.debug("update poll: %s", e)
        log.info(
            "optimistic slot %d  finalized slot %d  root %s",
            lc.optimistic_header.slot,
            lc.finalized_header.slot,
            lc.optimistic_header.hash_tree_root().hex()[:12],
        )
        time.sleep(args.poll_seconds)
    return 0


def add_lightclient_parser(sub) -> None:
    p = sub.add_parser("lightclient", help="run a light client")
    p.add_argument("--network", default="minimal-dev", choices=["minimal-dev", "mainnet"])
    p.add_argument("--beacon-url", default="http://127.0.0.1:5052")
    p.add_argument("--trusted-block-root", required=True)
    p.add_argument("--poll-seconds", type=float, default=2.0)
    p.add_argument("--run-seconds", type=float, default=0)
    p.set_defaults(func=run_lightclient)

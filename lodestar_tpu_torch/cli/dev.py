"""`dev` command: single-process local testnet.

Reference behavior: `lodestar dev` (cli/src/cmds/dev) — start a beacon
node from an interop genesis with all validators in-process, produce and
import blocks every (accelerated) slot, expose the REST API and metrics.

The port's copy of the JAX package's `cli/dev.py`. `--device` (default
`cuda`) takes the place of `--tpu-verifier`: the chain builds the port's
serving stack on that device, so every block's verdict runs on the card;
`--device cpu` runs the stack on the kernels' plain versions. Without a
card and unless `cpu` is asked for, the stack's build raises.
"""

from __future__ import annotations

import json
import time

from ..api import BeaconApiServer
from ..api.impl import BeaconApiImpl
from ..bls import api as bls
from ..config.beacon_config import BeaconConfig, ChainForkConfig
from ..config.chain_config import MINIMAL_CHAIN_CONFIG
from ..db import MemoryDb
from ..metrics.beacon import create_beacon_metrics
from ..metrics.server import MetricsServer
from ..metrics.validator_monitor import ValidatorMonitor
from ..params.presets import MINIMAL
from ..state_transition import interop_genesis_state
from ..types import get_types
from ..utils.logger import get_logger
from ..validator import SlashingProtection, ValidatorService, ValidatorStore


def run_dev(args) -> int:
    from ..chain import BeaconChain  # PyTorch only for this command

    log = get_logger("dev")
    preset = MINIMAL
    types = get_types(preset).phase0
    spe = preset.SLOTS_PER_EPOCH

    fork_config = ChainForkConfig(MINIMAL_CHAIN_CONFIG, preset)
    genesis_time = int(time.time())
    state = interop_genesis_state(
        fork_config, types, args.validators, genesis_time=genesis_time
    )
    config = BeaconConfig(
        MINIMAL_CHAIN_CONFIG, bytes(state.genesis_validators_root), preset
    )
    log.info(
        "interop genesis: %d validators, root %s",
        args.validators,
        state.genesis_validators_root.hex()[:16],
    )

    # the port's serving stack on `device`: the device tier behind the
    # supervisor's deadline/retry/fallback/breaker policy, as BeaconNode's
    chain = BeaconChain(config, types, state, device=args.device)
    api_server = None
    metrics_server = None
    try:
        store = ValidatorStore(config, SlashingProtection(MemoryDb()))
        for i in range(args.validators):
            store.add_secret_key(bls.interop_secret_key(i))
        metrics = create_beacon_metrics()
        chain.metrics = metrics
        service = ValidatorService(config, types, chain, store, metrics=metrics)
        # per-validator duty monitor over the local keys (reference
        # validatorMonitor: epoch-end duty summaries + metrics)
        monitor = ValidatorMonitor(metrics.registry)
        for i in range(args.validators):
            monitor.register_validator(i)
        chain.validator_monitor = monitor
        if args.rest:
            impl = BeaconApiImpl(config, types, chain, validator_service=service)
            api_server = BeaconApiServer(impl, port=args.rest_port)
            api_server.start()
            log.info("REST API on :%d", api_server.port)
        if args.metrics:
            metrics_server = MetricsServer(metrics.registry, port=args.metrics_port)
            metrics_server.start()
            log.info("metrics on :%d", metrics_server.port)

        for slot in range(1, args.slots + 1):
            chain.clock.set_slot(slot)
            t0 = time.perf_counter()
            signed = service.propose_block_if_due(slot)
            dt = time.perf_counter() - t0  # produce+import only
            service.attest_if_due(slot)
            if slot % preset.SLOTS_PER_EPOCH == 0:
                epoch_now = slot // preset.SLOTS_PER_EPOCH
                # summarize an epoch only after its inclusion window fully
                # closed (attestations from epoch e can land early in e+1);
                # stamp current balances onto the epoch being closed
                if epoch_now >= 2:
                    monitor.on_balances(
                        epoch_now - 2, chain.head_state.state.balances
                    )
                    monitor.log_epoch(epoch_now - 2, log)
            metrics.head_slot.set(chain.head_state.state.slot)
            metrics.current_justified_epoch.set(chain.justified_checkpoint[0])
            metrics.finalized_epoch.set(chain.finalized_checkpoint[0])
            if signed is not None:
                metrics.proposed_blocks_total.inc()
                metrics.processed_blocks_total.inc()
                metrics.block_import_seconds.observe(dt)
            log.info(
                "slot %d/%d  epoch %d  head %s  justified %d  finalized %d  (%.0f ms)",
                slot,
                args.slots,
                slot // spe,
                chain.head_root.hex()[:8],
                chain.justified_checkpoint[0],
                chain.finalized_checkpoint[0],
                dt * 1e3,
            )
            if args.slot_time > 0:
                time.sleep(args.slot_time)
        log.info(
            "done: head slot %d, justified epoch %d, finalized epoch %d",
            chain.head_state.state.slot,
            chain.justified_checkpoint[0],
            chain.finalized_checkpoint[0],
        )
        if args.slots >= 3 * spe and chain.justified_checkpoint[0] == 0:
            log.error("chain failed to justify after %d slots", args.slots)
            return 1
        return 0
    finally:
        if api_server:
            api_server.close()
        if metrics_server:
            metrics_server.close()
        chain.close()
        from ..parallel.mesh_pool import launch_counts

        # where the verdicts ran: K1, K4, K2, K2p, K3, K3-fe this process launched
        log.info("kernel launches %s", json.dumps(launch_counts()))


def add_dev_parser(sub) -> None:
    p = sub.add_parser("dev", help="single-process local testnet")
    p.add_argument("--validators", type=int, default=16)
    p.add_argument("--slots", type=int, default=24, help="slots to run")
    p.add_argument("--slot-time", type=float, default=0.0, help="seconds per slot (0 = as fast as possible)")
    p.add_argument("--rest", action="store_true", help="serve the REST API")
    p.add_argument("--rest-port", type=int, default=0)
    p.add_argument("--metrics", action="store_true", help="serve /metrics")
    p.add_argument("--metrics-port", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help='device of the signature-verification stack ("cuda", "cuda:N" or "cpu")')
    p.set_defaults(func=run_dev)

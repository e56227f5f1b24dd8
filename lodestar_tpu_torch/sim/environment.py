"""In-process multi-node simulation over real TCP/UDP networking (the
port's copy of the JAX package's `sim/environment.py`).

Each simulated node is a full vertical: BeaconChain + Network (secure
transport, gossipsub mesh, req/resp, discovery, over the port's own
X25519, Ed25519 and ChaCha20-Poly1305) + ValidatorService with its share
of the interop keys. Blocks travel ONLY via gossip (the proposer's node
publishes; every other node imports through the gossip validation
pipeline), aggregates travel on the aggregate topic, so a finalizing run
proves the whole stack end-to-end.

The verifiers (`verifier=`): "mock", the default as in the JAX package,
is `MockBlsVerifier`; "cpu" is the port's `CpuBlsVerifier` on the C host
tier; "device" is the port's `DeviceBlsVerifier` on `device` (the GPU
when None, raising without one; `device="cpu"` runs the kernels' plain
versions). The facade takes no `buckets=`.

A gossip verdict on a real verifier can take seconds, longer than the
JAX `_settle`'s fixed yields, and a block must reach every node before
the next slot's proposal builds on it (a peer's messages are validated
one at a time, so a block can wait behind an aggregate on its stream).
So with any verifier but "mock", `_settle` also waits, up to
`SETTLE_TIMEOUT_S`, until no node has gossip work queued or running
(`pending`, `drain`). "mock" runs settle as in JAX.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field

from ..bls import api as bls
from ..chain import BeaconChain
from ..chain.bls_verifier import MockBlsVerifier
from ..config.beacon_config import BeaconConfig, ChainForkConfig
from ..config.chain_config import MINIMAL_CHAIN_CONFIG
from ..db.controller import MemoryDb
from ..params.presets import MINIMAL
from ..state_transition import interop_genesis_state
from ..types import get_types
from ..utils.logger import get_logger
from ..validator.service import ValidatorService
from ..validator.slashing_protection import SlashingProtection
from ..validator.store import ValidatorStore
from ..network.network import Network
from ..network.transport import NodeIdentity

log = get_logger("sim")

SETTLE_TIMEOUT_S = 60.0  # the bound on one settle's wait for the nodes' gossip work


@dataclass
class EpochReport:
    epoch: int
    missed_blocks: int = 0
    head_roots: set = field(default_factory=set)
    finalized_epochs: list[int] = field(default_factory=list)
    participation: float = 0.0


@dataclass
class SimNode:
    index: int
    chain: BeaconChain
    network: Network
    validators: ValidatorService
    key_range: range


class SimulationEnvironment:
    """N beacon nodes × M total validators, keys striped across nodes."""

    def __init__(self, n_nodes: int = 4, n_validators: int = 32,
                 verifier: str = "mock", device=None):
        self.n_nodes = n_nodes
        self.n_validators = n_validators
        self.verifier_kind = verifier
        self.device = device
        types = get_types(MINIMAL).phase0
        fork_config = ChainForkConfig(MINIMAL_CHAIN_CONFIG, MINIMAL)
        state = interop_genesis_state(
            fork_config, types, n_validators, genesis_time=1_600_000_000
        )
        self.config = BeaconConfig(
            MINIMAL_CHAIN_CONFIG, bytes(state.genesis_validators_root), MINIMAL
        )
        self.types = types
        self.genesis_state = state
        self.nodes: list[SimNode] = []
        self.reports: list[EpochReport] = []
        self.blocks_produced = 0

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        per_node = self.n_validators // self.n_nodes
        for i in range(self.n_nodes):
            if self.verifier_kind == "device":
                from ..chain.bls_verifier import DeviceBlsVerifier

                verifier = DeviceBlsVerifier(device=self.device)
            elif self.verifier_kind == "cpu":
                # real verification on the native C pairing — fast enough
                # (~7 ms/set) for multi-node finalizing sims, unlike the
                # big-int oracle it replaced (round-3)
                from ..chain.bls_verifier import CpuBlsVerifier

                verifier = CpuBlsVerifier()
            else:
                verifier = MockBlsVerifier()
            chain = BeaconChain(
                self.config,
                self.types,
                self.genesis_state.copy(),
                verifier=verifier,
            )
            network = Network(
                self.config,
                self.types,
                chain,
                identity=NodeIdentity.from_seed(b"sim" + bytes([i])),
                verify_signatures=self.verifier_kind != "mock",
            )
            store = ValidatorStore(self.config, SlashingProtection(MemoryDb()))
            key_range = range(i * per_node, (i + 1) * per_node)
            for k in key_range:
                store.add_secret_key(bls.interop_secret_key(k))
            service = ValidatorService(self.config, self.types, chain, store)
            self.nodes.append(SimNode(i, chain, network, service, key_range))

        # boot networking: node 0 is the bootnode
        await self.nodes[0].network.start(discovery=True)
        boot = [self.nodes[0].network.discovery.local_enr]
        for node in self.nodes[1:]:
            await node.network.start(discovery=True, bootnodes=boot)
        for node in self.nodes:
            await node.network.discovery.lookup(node.network.peer_id)
        # let meshes converge
        for _ in range(4):
            await asyncio.sleep(0.05)
            for node in self.nodes:
                await node.network.gossip.heartbeat()

    async def stop(self) -> None:
        """Stop each node's network, then its chain's verify pool and its
        verifier (the JAX `stop` leaves those threads running)."""
        for node in self.nodes:
            await node.network.stop()
        for node in self.nodes:
            close = getattr(node.chain.bls, "close", None)
            if close is not None:
                close()
            node.chain.close()

    # -- slot loop -----------------------------------------------------------

    async def run_slot(self, slot: int) -> None:
        spe = self.config.preset.SLOTS_PER_EPOCH
        for node in self.nodes:
            node.chain.clock.set_slot(slot)
            node.chain.fork_choice.update_time(slot)

        # 1. proposal: exactly one node's validator has the duty; the
        # service imports into its own chain, the network gossips the block
        for node in self.nodes:
            signed = node.validators.propose_block_if_due(slot)
            if signed is not None:
                self.blocks_produced += 1
                await node.network.publish_block(signed)
                break

        # 2. give gossip a beat to deliver the block everywhere
        await self._settle()

        # 3. attestations: every node's validators attest to their head;
        # aggregates travel on the aggregate topic
        for node in self.nodes:
            atts = node.validators.attest_if_due(slot)
            for signed_agg in node.validators.aggregate_if_due(slot, atts):
                await node.network.publish_aggregate(signed_agg)
        await self._settle()

        # report at the first slot of the next epoch: the boundary
        # transition (justification/finality updates) has been processed by
        # this slot's block import
        if slot % spe == 0:
            self._report_epoch(slot // spe - 1)

    async def run_epochs(self, n_epochs: int) -> None:
        spe = self.config.preset.SLOTS_PER_EPOCH
        start = self.nodes[0].chain.head_state.state.slot
        for slot in range(start + 1, start + n_epochs * spe + 1):
            await self.run_slot(slot)

    async def _settle(self, rounds: int = 20) -> None:
        """Drain gossip queues/inboxes (no wall-clock slot pacing in sim);
        with a real verifier, until no node has gossip work."""
        for _ in range(rounds):
            await asyncio.sleep(0)
        await asyncio.sleep(0.05)
        if self.verifier_kind != "mock":
            await self.drain(SETTLE_TIMEOUT_S)

    def pending(self) -> int:
        """Gossip messages queued or being validated, over every node."""
        return sum(q.pending for node in self.nodes
                   for q in node.network.gossip_handlers.queues.values())

    async def drain(self, timeout_s: float) -> float | None:
        """Wait until no node has gossip work, twice in a row 0.05 s apart
        (a message still on the wire lands in a queue meanwhile); the
        seconds it took, or None when `timeout_s` passed first."""
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        quiet = 0
        while quiet < 2:
            if loop.time() - t0 > timeout_s:
                return None
            quiet = quiet + 1 if self.pending() == 0 else 0
            await asyncio.sleep(0.05)
        return loop.time() - t0

    # -- assertions ----------------------------------------------------------

    def _report_epoch(self, epoch: int) -> None:
        spe = self.config.preset.SLOTS_PER_EPOCH
        report = EpochReport(epoch=epoch)
        # reported at slot (epoch+1)*spe: proposals expected for every slot
        # 1..here (genesis slot 0 has none)
        report.missed_blocks = (epoch + 1) * spe - self.blocks_produced
        for node in self.nodes:
            report.head_roots.add(node.chain.head_root)
            report.finalized_epochs.append(node.chain.finalized_checkpoint[0])
        # participation: unique attesters of the just-rotated epoch over the
        # validator set (phase0 pending-attestation coverage on node 0)
        head = self.nodes[0].chain.head_state
        attesters: set[int] = set()
        for pa in head.state.previous_epoch_attestations:
            committee = head.epoch_ctx.get_beacon_committee(
                int(pa.data.slot), int(pa.data.index)
            )
            for pos, bit in enumerate(pa.aggregation_bits):
                if bit:
                    attesters.add(int(committee[pos]))
        report.participation = len(attesters) / max(1, len(head.state.validators))
        self.reports.append(report)
        log.info(
            "epoch %d: missed=%d heads=%d finalized=%s",
            epoch,
            report.missed_blocks,
            len(report.head_roots),
            report.finalized_epochs,
        )


class SimulationAssertions:
    """The per-epoch invariants the reference sim asserts
    (`simulation.test.ts`: missed blocks, participation, finality, heads)."""

    @staticmethod
    def assert_no_missed_blocks(env: SimulationEnvironment) -> None:
        for report in env.reports:
            assert report.missed_blocks == 0, (
                f"epoch {report.epoch}: {report.missed_blocks} missed blocks"
            )

    @staticmethod
    def assert_heads_consistent(env: SimulationEnvironment) -> None:
        for report in env.reports:
            assert len(report.head_roots) == 1, (
                f"epoch {report.epoch}: {len(report.head_roots)} distinct heads"
            )

    @staticmethod
    def assert_finalization(env: SimulationEnvironment, min_final: int) -> None:
        last = env.reports[-1]
        for i, fin in enumerate(last.finalized_epochs):
            assert fin >= min_final, (
                f"node {i} finalized epoch {fin} < {min_final}"
            )

    @staticmethod
    def assert_participation(env: SimulationEnvironment, minimum: float) -> None:
        for report in env.reports[1:]:
            assert report.participation >= minimum, (
                f"epoch {report.epoch}: participation {report.participation}"
            )

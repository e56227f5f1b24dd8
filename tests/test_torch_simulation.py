"""The port's multi-node simulation (`sim/`) against the JAX package's:
nodes over real TCP/UDP networking on loopback (the port's own X25519,
Ed25519 and ChaCha20-Poly1305), blocks by gossip only.

Fast tier: 2 nodes × 8 validators × 1 epoch with the mock verifier in
both packages. Their epoch reports are equal (missed blocks, head count,
finalized epochs, participation), and every block of the port's run, put
through the JAX state transition from the JAX genesis, gives the port's
post-state root. Slow tier, as in the JAX package: the finalizing
4 × 32 × 4-epoch simulation on the host tier's verifier, and the device
configuration (2 × 8 × 1 epoch) with the facade on the CPU."""

import asyncio

import pytest

pytest.importorskip("cryptography")  # the JAX side's transport identities

from lodestar_tpu.sim import SimulationEnvironment as JSimulationEnvironment  # noqa: E402
from lodestar_tpu.state_transition import CachedBeaconState as JCached  # noqa: E402
from lodestar_tpu.state_transition import state_transition as j_state_transition  # noqa: E402
from lodestar_tpu_torch.convert import ssz_to_jax  # noqa: E402
from lodestar_tpu_torch.sim import (  # noqa: E402
    SimulationAssertions,
    SimulationEnvironment,
)
from lodestar_tpu_torch.sim.environment import SETTLE_TIMEOUT_S  # noqa: E402


def _run(cls, epochs: int, timeout: float, **kwargs):
    async def main():
        env = cls(**kwargs)
        await env.start()
        try:
            await env.run_epochs(epochs)
        finally:
            await env.stop()
        return env

    return asyncio.run(asyncio.wait_for(main(), timeout))


def _report(env):
    return [(r.epoch, r.missed_blocks, len(r.head_roots), r.finalized_epochs, r.participation)
            for r in env.reports]


@pytest.fixture(scope="module")
def mock_pair():
    port = _run(SimulationEnvironment, 1, 300, n_nodes=2, n_validators=8)
    jax = _run(JSimulationEnvironment, 1, 300, n_nodes=2, n_validators=8)
    return port, jax


def test_mock_reports_equal_the_jax_simulation(mock_pair):
    port, jax = mock_pair
    assert port.genesis_state.hash_tree_root() == jax.genesis_state.hash_tree_root()
    assert port.blocks_produced == jax.blocks_produced == 8
    assert _report(port) == _report(jax)
    SimulationAssertions.assert_no_missed_blocks(port)
    SimulationAssertions.assert_heads_consistent(port)


def test_mock_blocks_travel_by_gossip_to_every_node(mock_pair):
    port, _ = mock_pair
    head = port.nodes[0].chain.head_root
    for node in port.nodes[1:]:
        assert node.chain.head_root == head
        assert node.chain.fork_choice.has_block(head)
    for node in port.nodes:
        foreign = [s for s in node.chain.blocks.values() if s is not None
                   and int(s.message.proposer_index) not in node.key_range]
        assert foreign, f"node {node.index} imported no gossiped block"


def test_port_blocks_replay_through_the_jax_state_transition(mock_pair):
    port, jax = mock_pair
    types = jax.types
    blocks = sorted((s for s in port.nodes[0].chain.blocks.values() if s is not None),
                    key=lambda s: int(s.message.slot))
    assert [int(s.message.slot) for s in blocks] == list(range(1, 9))
    cached = JCached(jax.config, jax.genesis_state.copy())
    for signed in blocks:
        j_state_transition(cached, types, ssz_to_jax(signed, types.SignedBeaconBlock),
                           verify_state_root=True, verify_signatures=False)
        assert cached.state.hash_tree_root() == bytes(signed.message.state_root)
    assert port.nodes[0].chain.head_root == blocks[-1].message.hash_tree_root()


def test_settle_waits_only_for_a_real_verifier():
    """With "mock" the port settles as the JAX package does (no wait on
    pending gossip work); with another verifier it waits until no node
    has gossip work queued or running."""
    calls = []

    class Spy(SimulationEnvironment):
        async def drain(self, timeout_s):
            calls.append(timeout_s)
            return 0.0

    asyncio.run(Spy(n_nodes=1, n_validators=4)._settle())
    assert calls == []
    asyncio.run(Spy(n_nodes=1, n_validators=4, verifier="cpu")._settle())
    assert calls == [SETTLE_TIMEOUT_S]
    env = SimulationEnvironment(n_nodes=1, n_validators=4)
    assert env.pending() == 0 and asyncio.run(env.drain(1.0)) is not None


@pytest.mark.slow
def test_four_nodes_finalize_on_the_host_tier():
    env = _run(SimulationEnvironment, 4, 900, n_nodes=4, n_validators=32, verifier="cpu")
    SimulationAssertions.assert_no_missed_blocks(env)
    SimulationAssertions.assert_heads_consistent(env)
    SimulationAssertions.assert_finalization(env, min_final=1)
    SimulationAssertions.assert_participation(env, minimum=0.5)


@pytest.mark.slow
def test_two_nodes_with_the_device_verifier_on_the_cpu():
    env = _run(SimulationEnvironment, 1, 3600, n_nodes=2, n_validators=8, verifier="device",
               device="cpu")
    assert env.blocks_produced > 0
    for node in env.nodes:
        assert node.chain.head_state.state.slot > 0, "node never imported"
        foreign = [s for s in node.chain.blocks.values() if s is not None
                   and int(s.message.proposer_index) not in node.key_range]
        assert foreign, f"node {node.index} imported no gossiped blocks"

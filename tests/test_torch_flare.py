"""The port's `flare` command (`self-slash-proposer`, `self-slash-attester`)
against a port `BeaconNode` whose verdicts run on the host tier
(`CpuBlsVerifier`): the slashings land in the pool through the gossip
validation ladders and the GET routes serve them, as in the JAX package's
flare tests. Against a recording server both packages' commands post the
same JSON, byte for byte, and a proposer slashing whose second header is
signed by another key is refused with 400 and never pooled."""

import json

import pytest

from lodestar_tpu.cli.__main__ import main as jax_cli_main
from lodestar_tpu.params.presets import MINIMAL as JMINIMAL
from lodestar_tpu.types import get_types as jget_types
from lodestar_tpu_torch.api.client import ApiClientError, BeaconApiClient
from lodestar_tpu_torch.bls import api as bls
from lodestar_tpu_torch.chain.bls_verifier import CpuBlsVerifier
from lodestar_tpu_torch.cli.__main__ import main as cli_main
from lodestar_tpu_torch.config.beacon_config import (
    BeaconConfig,
    ChainForkConfig,
    compute_signing_root,
)
from lodestar_tpu_torch.config.chain_config import MINIMAL_CHAIN_CONFIG
from lodestar_tpu_torch.node.node import BeaconNode, NodeOptions
from lodestar_tpu_torch.params import DOMAIN_BEACON_PROPOSER
from lodestar_tpu_torch.params.presets import MINIMAL
from lodestar_tpu_torch.state_transition import interop_genesis_state
from lodestar_tpu_torch.state_transition.block import is_slashable_attestation_data
from lodestar_tpu_torch.types import get_types
from tests.torch_loopback import LoopbackServer

PROPOSER = ["flare", "self-slash-proposer", "--validators", "0..2", "--slot", "1"]
ATTESTER = ["flare", "self-slash-attester", "--validators", "2,3,4", "--slot", "1",
            "--batch-size", "2"]


@pytest.fixture(scope="module")
def node_env():
    types = get_types(MINIMAL).phase0
    fork_config = ChainForkConfig(MINIMAL_CHAIN_CONFIG, MINIMAL)
    state = interop_genesis_state(fork_config, types, 16, genesis_time=1_600_000_000)
    config = BeaconConfig(MINIMAL_CHAIN_CONFIG, bytes(state.genesis_validators_root), MINIMAL)
    node = BeaconNode.init(config, types, state.copy(),
                           NodeOptions(rest=True, rest_port=0, verifier=CpuBlsVerifier()))
    yield config, types, node
    node.close()


def _server(node) -> list[str]:
    return ["--server", f"127.0.0.1:{node.api_server.port}"]


def test_flare_self_slash_proposer(node_env):
    config, types, node = node_env
    assert cli_main(PROPOSER + _server(node)) == 0
    pool = node.chain.op_pool
    assert set(pool.proposer_slashings) >= {0, 1}
    slashing = pool.proposer_slashings[0]
    h1, h2 = slashing.signed_header_1.message, slashing.signed_header_2.message
    assert int(h1.slot) == int(h2.slot) == 1
    assert h1.hash_tree_root() != h2.hash_tree_root()


def test_flare_self_slash_attester(node_env):
    config, types, node = node_env
    assert cli_main(ATTESTER + _server(node)) == 0
    pool = node.chain.op_pool
    assert len(pool.attester_slashings) == 2  # batches of 2 then 1
    for slashing in pool.attester_slashings:
        assert is_slashable_attestation_data(slashing.attestation_1.data,
                                             slashing.attestation_2.data)
    covered = {int(i) for s in pool.attester_slashings
               for i in s.attestation_1.attesting_indices}
    assert covered == {2, 3, 4}


def test_flare_pool_routes_roundtrip(node_env):
    """The GET pool routes serve what flare submitted."""
    config, types, node = node_env
    client = BeaconApiClient("127.0.0.1", node.api_server.port)
    props = client.getPoolProposerSlashings()
    attrs = client.getPoolAttesterSlashings()
    assert len(props) >= 2
    assert len(attrs) == 2
    restored = types.ProposerSlashing.from_obj(props[0])
    assert int(restored.signed_header_1.message.slot) == 1


def test_a_proposer_slashing_signed_by_another_key_is_refused(node_env):
    config, types, node = node_env
    client = BeaconApiClient("127.0.0.1", node.api_server.port)
    slashing = types.ProposerSlashing.from_obj(client.getPoolProposerSlashings()[0])
    index = int(slashing.signed_header_1.message.proposer_index)
    h2 = slashing.signed_header_2.message
    h2.proposer_index, h2.body_root = 5, b"\x03" * 32
    slashing.signed_header_1.message.proposer_index = 5
    domain = config.get_domain(DOMAIN_BEACON_PROPOSER, 1)
    slashing.signed_header_1.signature = bls.interop_secret_key(5).sign(compute_signing_root(
        slashing.signed_header_1.message.hash_tree_root(), domain)).to_bytes()
    slashing.signed_header_2.signature = bls.interop_secret_key(index + 7).sign(
        compute_signing_root(h2.hash_tree_root(), domain)).to_bytes()
    with pytest.raises(ApiClientError) as e:
        client.submitPoolProposerSlashings(body=slashing.to_obj())
    assert e.value.status == 400
    assert 5 not in node.chain.op_pool.proposer_slashings


def _genesis_root():
    types = get_types(MINIMAL).phase0
    state = interop_genesis_state(ChainForkConfig(MINIMAL_CHAIN_CONFIG, MINIMAL), types, 16,
                                  genesis_time=1_600_000_000)
    return bytes(state.genesis_validators_root)


@pytest.mark.parametrize("argv", [PROPOSER, ATTESTER], ids=["proposer", "attester"])
def test_both_commands_post_the_same_slashings(argv):
    """Against a server that records each request, the port's command posts
    the JAX command's JSON, and the SSZ it decodes to is the same bytes."""
    root = "0x" + _genesis_root().hex()

    def respond(method, path, body):
        if path == "/eth/v1/beacon/genesis":
            return 200, {"data": {"genesis_validators_root": root, "genesis_time": "0",
                                  "genesis_fork_version": "0x00000001"}}
        return 200, {}

    posted = []
    for cli in (jax_cli_main, cli_main):
        with LoopbackServer(respond) as server:
            assert cli(argv + ["--server", f"127.0.0.1:{server.port}"]) == 0
            posted.append([r for r in server.take() if r["method"] == "POST"])
    port, jax = posted[1], posted[0]
    assert len(port) == 2
    assert [r["path"] for r in port] == [r["path"] for r in jax]
    assert json.dumps([r["body"] for r in port]) == json.dumps([r["body"] for r in jax])
    kind = "ProposerSlashing" if argv is PROPOSER else "AttesterSlashing"
    t, jt = get_types(MINIMAL).phase0, jget_types(JMINIMAL).phase0
    for r, jr in zip(port, jax):
        assert getattr(t, kind).from_obj(r["body"]).serialize() == \
            getattr(jt, kind).from_obj(jr["body"]).serialize()

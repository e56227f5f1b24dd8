"""The port's validator client over HTTP, mirroring the validator half of
`tests/test_node_validator_cli.py` and the keymanager tests of
`tests/test_keymanager_builder.py` (`:50`, `:88`).

A port `BeaconNode` on an interop genesis of 16 validators (minimal
preset) with REST on loopback and `NodeOptions(verifier=CpuBlsVerifier())`
(the host tier) is driven by `RestValidatorService` over
`BeaconApiClient`: every proposal lands, pool attestations reach blocks,
and every signature the client publishes equals the JAX `ValidatorStore`'s
on the same object. Also: the external signer round trip (the port's
server against both packages' clients), doppelganger's state machine
(against the JAX service's on the same liveness) and its gate, the
fee-recipient registration, and the keymanager API (import, list, delete,
a wrong password, the bearer token, remote keys) answering as the JAX
package's does. Tolerance: byte-equality throughout.
"""

import http.client
import json

import pytest
import torch

from lodestar_tpu.bls import api as jbls
from lodestar_tpu.config.beacon_config import BeaconConfig as JBeaconConfig
from lodestar_tpu.config.chain_config import MINIMAL_CHAIN_CONFIG as J_MINIMAL_CC
from lodestar_tpu.db import MemoryDb as JMemoryDb
from lodestar_tpu.params.presets import MINIMAL as JMINIMAL
from lodestar_tpu.types import get_types as jget_types
from lodestar_tpu.validator import DoppelgangerService as JDoppelgangerService
from lodestar_tpu.validator import ExternalSignerClient as JExternalSignerClient
from lodestar_tpu.validator import SlashingProtection as JSlashingProtection
from lodestar_tpu.validator import ValidatorStore as JValidatorStore
from lodestar_tpu_torch.api.client import BeaconApiClient
from lodestar_tpu_torch.api.keymanager import create_keymanager_server
from lodestar_tpu_torch.bls import api as bls
from lodestar_tpu_torch.chain.bls_verifier import CpuBlsVerifier
from lodestar_tpu_torch.config.beacon_config import BeaconConfig, ChainForkConfig
from lodestar_tpu_torch.config.beacon_config import compute_signing_root
from lodestar_tpu_torch.config.chain_config import MINIMAL_CHAIN_CONFIG
from lodestar_tpu_torch.db import MemoryDb
from lodestar_tpu_torch.node import BeaconNode, NodeOptions
from lodestar_tpu_torch.params import DOMAIN_RANDAO
from lodestar_tpu_torch.params.presets import MINIMAL
from lodestar_tpu_torch.ssz import uint64
from lodestar_tpu_torch.state_transition import interop_genesis_state
from lodestar_tpu_torch.types import get_types
from lodestar_tpu_torch.validator import (
    DoppelgangerService,
    DoppelgangerStatus,
    ExternalSignerClient,
    ExternalSignerServer,
    RestValidatorService,
    SlashingProtection,
    ValidatorStore,
)
from lodestar_tpu_torch.validator.keystore import encrypt_keystore

torch.set_num_threads(1)

N = 16
SPE = MINIMAL.SLOTS_PER_EPOCH
JTYPES = jget_types(JMINIMAL).phase0


class _Recorder:
    """A `BeaconApiClient` that keeps what the validator publishes."""

    def __init__(self, client):
        self._client = client
        self.blocks, self.attestations, self.aggregates = [], [], []

    def __getattr__(self, name):
        return getattr(self._client, name)

    def publishBlock(self, body):
        self.blocks.append(body)
        return self._client.publishBlock(body=body)

    def submitPoolAttestations(self, body):
        self.attestations += body
        return self._client.submitPoolAttestations(body=body)

    def publishAggregateAndProofs(self, body):
        self.aggregates += body
        return self._client.publishAggregateAndProofs(body=body)


@pytest.fixture(scope="module")
def node_env():
    types = get_types(MINIMAL).phase0
    state = interop_genesis_state(ChainForkConfig(MINIMAL_CHAIN_CONFIG, MINIMAL), types, N,
                                  genesis_time=1_600_000_000)
    config = BeaconConfig(MINIMAL_CHAIN_CONFIG, bytes(state.genesis_validators_root), MINIMAL)
    node = BeaconNode.init(config, types, state.copy(),
                           NodeOptions(rest=True, rest_port=0, verifier=CpuBlsVerifier()))
    jconfig = JBeaconConfig(J_MINIMAL_CC, bytes(state.genesis_validators_root), JMINIMAL)
    yield config, types, node, jconfig
    node.close()


def _store(config, keys=range(N)):
    store = ValidatorStore(config, SlashingProtection(MemoryDb()))
    for i in keys:
        store.add_secret_key(bls.interop_secret_key(i))
    return store


def _jstore(jconfig, keys=range(N)):
    store = JValidatorStore(jconfig, JSlashingProtection(JMemoryDb()))
    for i in keys:
        store.add_secret_key(jbls.interop_secret_key(i))
    return store


def test_rest_validator_drives_chain(node_env):
    config, types, node, jconfig = node_env
    client = _Recorder(BeaconApiClient(port=node.api_server.port))
    store = _store(config)
    service = RestValidatorService(config, types, client, store)

    for slot in range(1, SPE + 2):
        node.on_clock_slot(slot)
        service.on_slot(slot)
    head = node.chain.head_state
    assert head.state.slot == SPE + 1  # every proposal landed via REST
    assert len(client.blocks) == SPE + 1
    head_block = node.chain.blocks[node.chain.head_root]
    assert len(head_block.message.body.attestations) > 0  # pool attestations made it in
    assert len(client.attestations) == N * (SPE + 1) // SPE  # each key once an epoch
    # the node's pool merges the single-bit attestations: each committee's
    # votes reach a later block as one attestation with every bit set
    included = {int(a.data.slot): list(a.aggregation_bits)
                for a in head_block.message.body.attestations}
    assert included == {slot: [True, True] for slot in range(1, SPE + 1)}
    # the aggregation duty finds no aggregate: REST pool attestations go
    # straight to the block pool, not to the pool `getAggregatedAttestation`
    # reads (the JAX package's behavior too)
    assert client.aggregates == []

    # every signature the client published is the JAX store's on the same object
    jstore = _jstore(jconfig)
    pk_of = {i: bls.interop_secret_key(i).to_public_key().to_bytes() for i in range(N)}
    for body in client.blocks:
        jblock = JTYPES.BeaconBlock.from_obj(body["message"])
        jsigned = jstore.sign_block(pk_of[int(jblock.proposer_index)], JTYPES, jblock)
        assert "0x" + bytes(jsigned.signature).hex() == body["signature"]
        reveal = jstore.sign_randao(pk_of[int(jblock.proposer_index)], int(jblock.slot))
        assert bytes(jblock.body.randao_reveal) == reveal
    committee_pks = {}
    for att in client.attestations:
        jatt = JTYPES.Attestation.from_obj(att)
        committee = node.chain.head_state.epoch_ctx.get_beacon_committee(
            int(jatt.data.slot), int(jatt.data.index))
        (pos,) = [k for k, bit in enumerate(jatt.aggregation_bits) if bit]
        pk = pk_of[int(committee[pos])]
        committee_pks[(int(jatt.data.slot), int(jatt.data.index), pos)] = pk
        assert jstore.sign_attestation(pk, jatt.data) == bytes(jatt.signature)
    for agg in client.aggregates:
        jagg = JTYPES.SignedAggregateAndProof.from_obj(agg)
        pk = pk_of[int(jagg.message.aggregator_index)]
        slot = int(jagg.message.aggregate.data.slot)
        assert jstore.sign_selection_proof(pk, slot) == bytes(jagg.message.selection_proof)
        resigned = jstore.sign_aggregate_and_proof(pk, JTYPES, jagg.message)
        assert bytes(resigned.signature) == bytes(jagg.signature)


def test_external_signer_roundtrip(node_env):
    config, types, node, jconfig = node_env
    sks = [bls.interop_secret_key(50), bls.interop_secret_key(51)]
    server = ExternalSignerServer(sks)
    server.start()
    try:
        signer = ExternalSignerClient("127.0.0.1", server.port)
        assert signer.upcheck()
        keys = signer.list_pubkeys()
        assert keys == [sk.to_public_key().to_bytes() for sk in sks]
        assert JExternalSignerClient("127.0.0.1", server.port).list_pubkeys() == keys
        store = ValidatorStore(config, SlashingProtection(MemoryDb()))
        pk = store.add_remote_key(keys[0], signer)
        sig = store.sign_randao(pk, 5)
        # the remote signature is the local one, and verifies
        assert sig == _store(config, [50]).sign_randao(pk, 5)
        assert sig == _jstore(jconfig, [50]).sign_randao(pk, 5)
        domain = config.get_domain(DOMAIN_RANDAO, 5)
        root = compute_signing_root(uint64.hash_tree_root(5 // SPE), domain)
        assert bls.verify(bls.PublicKey.from_bytes(keys[0]), root, bls.Signature.from_bytes(sig))
        assert JExternalSignerClient("127.0.0.1", server.port).sign(pk, root) == sig
        assert store.remove_key(pk) and not store.has_pubkey(pk)
    finally:
        server.close()


def test_doppelganger_state_machine():
    liveness = [(11, {2: True}), (12, {}), (13, {1: True})]
    port, jax = DoppelgangerService(epochs_to_check=2), JDoppelgangerService(epochs_to_check=2)
    for d in (port, jax):
        d.register(1, current_epoch=10)
        d.register(2, current_epoch=10)
    assert not port.is_signing_safe(1)
    for epoch, live in liveness:
        port.on_epoch(epoch, live)
        jax.on_epoch(epoch, live)
        assert [port.status(i).value for i in (1, 2, 3)] == \
            [jax.status(i).value for i in (1, 2, 3)], epoch
    assert port.status(2) == DoppelgangerStatus.DETECTED
    assert port.is_signing_safe(1) and not port.is_signing_safe(2)
    assert port.is_signing_safe(3)  # unregistered: managed elsewhere
    assert port.any_detected()


def test_liveness_endpoint_and_doppelganger_gate(node_env):
    config, types, node, jconfig = node_env
    client = _Recorder(BeaconApiClient(port=node.api_server.port))
    epoch = node.chain.head_state.current_epoch
    out = client.getLiveness(epoch, body=["0", "1"])
    assert isinstance(out, list) and len(out) == 2
    # a validator under its doppelganger watch signs nothing
    doppelganger = DoppelgangerService()
    store = _store(config, [0, 1, 2, 3])
    service = RestValidatorService(config, types, client, store, doppelganger)
    service.update_duties(epoch)
    assert sorted(doppelganger._state) == [0, 1, 2, 3]
    assert all(doppelganger.status(i) == DoppelgangerStatus.VERIFYING for i in range(4))
    duty_slots = sorted(service._attester_duties)
    assert duty_slots
    for slot in duty_slots:
        assert service.attest_if_due(slot) == []
    assert client.attestations == []
    # the liveness the node reports decides it: keys seen live are detected
    live = {int(e["index"]): e["is_live"] for e in
            client.getLiveness(epoch - 1, body=["0", "1", "2", "3"])}
    jdoppelganger = JDoppelgangerService()
    for i in range(4):
        jdoppelganger.register(i, epoch)
    doppelganger.on_epoch(epoch, live)
    jdoppelganger.on_epoch(epoch, live)
    assert [doppelganger.status(i).value for i in range(4)] == \
        [jdoppelganger.status(i).value for i in range(4)]
    assert any(live.values())  # they attested in the drive above
    assert doppelganger.any_detected()


def test_rest_validator_registers_fee_recipient(node_env):
    config, types, node, jconfig = node_env
    fee = bytes(range(20))
    client = BeaconApiClient("127.0.0.1", node.api_server.port)
    service = RestValidatorService(config, types, client, _store(config, range(4)),
                                   fee_recipient=fee)
    service.update_duties(node.chain.head_state.epoch_ctx.current_epoch)
    for i in range(4):
        assert node.chain.beacon_proposer_cache.get(i) == fee
    assert node.chain.beacon_proposer_cache.get(7) == b"\x00" * 20


def _km_request(port, method, path, body=None, token=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        payload = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json"} if payload else {}
        if token is not None:
            headers["Authorization"] = f"Bearer {token}"
        conn.request(method, path, body=payload, headers=headers)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


@pytest.fixture()
def km_servers(tmp_path):
    """The port's keymanager and the JAX package's, each over its own
    store, the port's with its token in a file."""
    pytest.importorskip("cryptography")  # the JAX keymanager's keystores
    from lodestar_tpu.api.keymanager import create_keymanager_server as j_create

    config = BeaconConfig(MINIMAL_CHAIN_CONFIG, b"\x00" * 32, MINIMAL)
    jconfig = JBeaconConfig(J_MINIMAL_CC, b"\x00" * 32, JMINIMAL)
    signer = ExternalSignerServer([bls.interop_secret_key(9)])
    signer.start()
    token_file = str(tmp_path / "vc.db.api-token.txt")
    store = ValidatorStore(config, SlashingProtection(MemoryDb()))
    server = create_keymanager_server(
        store, signer_factory=lambda url: ExternalSignerClient("127.0.0.1", signer.port),
        token_file=token_file)
    jstore = JValidatorStore(jconfig, JSlashingProtection(JMemoryDb()))
    jserver = j_create(
        jstore, signer_factory=lambda url: JExternalSignerClient("127.0.0.1", signer.port))
    server.start()
    jserver.start()
    yield (store, server), (jstore, jserver), token_file
    server.close()
    jserver.close()
    signer.close()


def _both(servers, method, path, body=None, token=True):
    return [_km_request(s.port, method, path, body, s.bearer_token if token else None)
            for _, s in servers]


def test_keymanager_import_list_delete(km_servers):
    (store, server), (jstore, jserver), token_file = km_servers
    servers = [(store, server), (jstore, jserver)]
    with open(token_file) as f:
        assert f.read().strip() == server.bearer_token
    sk = bls.interop_secret_key(3)
    ks = encrypt_keystore(sk.to_bytes(), "pw")
    pk_hex = "0x" + sk.to_public_key().to_bytes().hex()
    body = {"keystores": [json.dumps(ks)], "passwords": ["pw"]}

    port, jax = _both(servers, "POST", "/eth/v1/keystores", body)
    assert port == jax == (200, {"data": [{"status": "imported", "message": ""}]})
    port, jax = _both(servers, "GET", "/eth/v1/keystores")
    assert port == jax
    assert [k["validating_pubkey"] for k in port[1]["data"]] == [pk_hex]
    port, jax = _both(servers, "POST", "/eth/v1/keystores", body)  # again: a duplicate
    assert port == jax and port[1]["data"][0]["status"] == "duplicate"

    # no token, or a wrong one: 401 (the keymanager API requires bearer auth)
    port, jax = _both(servers, "DELETE", "/eth/v1/keystores", {"pubkeys": [pk_hex]}, token=False)
    assert port[0] == jax[0] == 401
    assert _km_request(server.port, "GET", "/eth/v1/keystores", token="api-token-0xwrong")[0] == 401
    # the slot it signed travels in the delete's interchange
    store.protection.check_and_insert_block_proposal(sk.to_public_key().to_bytes(), 7, b"\x0b" * 32)
    jstore.protection.check_and_insert_block_proposal(sk.to_public_key().to_bytes(), 7, b"\x0b" * 32)
    port, jax = _both(servers, "DELETE", "/eth/v1/keystores", {"pubkeys": [pk_hex, "0x" + "ab" * 48]})
    assert port == jax
    assert [s["status"] for s in port[1]["data"]["statuses"]] == ["deleted", "not_found"]
    interchange = port[1]["data"]["slashing_protection"]
    assert interchange["metadata"]["interchange_format_version"] == "5"
    assert interchange["data"][0]["signed_blocks"] == [{"slot": "7", "signing_root": "0x" + "0b" * 32}]
    assert not store.pubkeys and not jstore.pubkeys


def test_keymanager_wrong_password(km_servers):
    (store, server), (jstore, jserver), _ = km_servers
    ks = encrypt_keystore(bls.interop_secret_key(4).to_bytes(), "pw")
    port, jax = _both([(store, server), (jstore, jserver)], "POST", "/eth/v1/keystores",
                      {"keystores": [json.dumps(ks)], "passwords": ["nope"]})
    assert port == jax
    assert port[1]["data"][0]["status"] == "error"
    assert "wrong password" in port[1]["data"][0]["message"]
    assert not store.pubkeys


def test_keymanager_remote_keys(km_servers):
    (store, server), (jstore, jserver), _ = km_servers
    servers = [(store, server), (jstore, jserver)]
    pk = bls.interop_secret_key(9).to_public_key().to_bytes()
    body = {"remote_keys": [{"pubkey": "0x" + pk.hex(), "url": "http://127.0.0.1"}]}
    port, jax = _both(servers, "POST", "/eth/v1/remotekeys", body)
    assert port == jax == (200, {"data": [{"status": "imported", "message": ""}]})
    port, jax = _both(servers, "GET", "/eth/v1/remotekeys")
    assert port == jax and [k["pubkey"] for k in port[1]["data"]] == ["0x" + pk.hex()]
    assert _both(servers, "GET", "/eth/v1/keystores")[0][1] == {"data": []}  # local keys only
    assert store.sign_randao(pk, 3) == jstore.sign_randao(pk, 3)
    port, jax = _both(servers, "DELETE", "/eth/v1/remotekeys", {"pubkeys": ["0x" + pk.hex()]})
    assert port == jax and port[1]["data"][0]["status"] == "deleted"
    assert not store.has_pubkey(pk)

"""The port's Beacon API (`lodestar_tpu_torch/api/`) against the JAX
package's, over HTTP on loopback, on the CPU at the minimal preset with
64 validators: two chains built alike (`tests/torch_chain.py`'s `PLAN`,
the last block posted through `publishBlock`), each behind its package's
`BeaconApiServer`; every route of `API_ROUTES`, with its error paths,
gives equal status codes and JSON bodies; bearer-token refusals, CORS
headers and preflights are equal; the port's `BeaconApiClient` talks to
the JAX server and the JAX client to the port's, with the answers each
gets from its own; the SSE stream delivers the same events. Also the
reference quirk both packages share: `submitPoolAttestations` puts a
REST attestation into the aggregated pool and fork choice with no
signature check, where `submitPoolVoluntaryExit` validates."""

import http.client
import json

import pytest
import torch
import torch_chain

from lodestar_tpu.api import BeaconApiClient as JClient
from lodestar_tpu.api import BeaconApiServer as JServer
from lodestar_tpu.api.impl import BeaconApiImpl as JImpl
from lodestar_tpu.api.routes import API_ROUTES as J_ROUTES
from lodestar_tpu.chain.bls_verifier import CpuBlsVerifier as JCpuBlsVerifier
from lodestar_tpu.chain.chain import BeaconChain as JBeaconChain
from lodestar_tpu.params.presets import MINIMAL as JMINIMAL
from lodestar_tpu.types import get_types as jget_types
from lodestar_tpu_torch.api import BeaconApiClient, BeaconApiServer
from lodestar_tpu_torch.api.client import ApiClientError
from lodestar_tpu_torch.api.impl import BeaconApiImpl
from lodestar_tpu_torch.api.routes import API_ROUTES, match_route
from lodestar_tpu_torch.chain.bls_verifier import CpuBlsVerifier
from lodestar_tpu_torch.chain.chain import BeaconChain
from lodestar_tpu_torch.params import DOMAIN_RANDAO
from lodestar_tpu_torch.params.presets import MINIMAL
from lodestar_tpu_torch.types import get_types

torch.set_num_threads(1)

PT, JT = get_types(MINIMAL).phase0, jget_types(JMINIMAL).phase0
TOKEN, ORIGIN = "s3cret-token", "https://dash.example"


def _request(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        payload = json.dumps(body).encode() if body is not None else None
        hdrs = dict(headers or {})
        if payload is not None:
            hdrs["Content-Type"] = "application/json"
        conn.request(method, path, body=payload, headers=hdrs)
        resp = conn.getresponse()
        raw = resp.read()
        keep = {k: v for k, v in resp.getheaders()
                if k.lower().startswith("access-control") or k.lower() in ("vary", "content-type")}
        return resp.status, (json.loads(raw) if raw else None), keep
    finally:
        conn.close()


class Pair:
    """A port and a JAX chain on the same genesis and blocks, each behind
    its package's server (`server_kwargs` for both)."""

    def __init__(self, plan, direct: int, **server_kwargs):
        jconfig, jgen = torch_chain.jax_genesis()
        self.plan, self.jconfig = plan, jconfig
        self.port = BeaconChain(plan.config, PT, plan.genesis.state.copy(),
                                verifier=CpuBlsVerifier())
        self.jax = JBeaconChain(jconfig, JT, jgen.state.copy(), verifier=JCpuBlsVerifier())
        for signed in plan.blocks[:direct]:
            slot = int(signed.message.slot)
            self.port.clock.set_slot(slot)
            self.jax.clock.set_slot(slot)
            self.port.process_block(signed)
            self.jax.process_block(torch_chain.to_jax(signed, "SignedBeaconBlock"))
        self.servers = {
            "port": BeaconApiServer(BeaconApiImpl(plan.config, PT, self.port), **server_kwargs),
            "jax": JServer(JImpl(jconfig, JT, self.jax), **server_kwargs),
        }
        for s in self.servers.values():
            s.start()

    def both(self, method, path, body=None, headers=None):
        return {name: _request(s.port, method, path, body, headers)
                for name, s in self.servers.items()}

    def close(self):
        for s in self.servers.values():
            s.close()
        self.port.close()


@pytest.fixture(scope="module")
def plan():
    return torch_chain.port_chain()


@pytest.fixture(scope="module")
def pair(plan):
    p = Pair(plan, direct=len(plan.blocks) - 1)
    yield p
    p.close()


def test_route_tables_equal():
    assert [(r.operation_id, r.method, r.path) for r in API_ROUTES] == \
        [(r.operation_id, r.method, r.path) for r in J_ROUTES]
    r, params = match_route("GET", "/eth/v1/beacon/states/head/root")
    assert r.operation_id == "getStateRoot" and params == {"state_id": "head"}
    assert match_route("GET", "/eth/v1/nonexistent") == (None, {})


def _randao(plan, slot):
    from lodestar_tpu_torch.state_transition.block import _epoch_signing_root

    pre = plan.factory.advance(plan.posts[-1], slot)
    proposer = pre.epoch_ctx.get_beacon_proposer(slot)
    root = _epoch_signing_root(slot // MINIMAL.SLOTS_PER_EPOCH,
                               plan.config.get_domain(DOMAIN_RANDAO, slot))
    return "0x" + plan.factory.sign([(proposer, root)])[0].hex()


def _requests(plan, pair):
    """(operation id, method, path, body) covering every route, valid and
    refused, at the head after the posted block."""
    head = pair.port.head_state
    st = head.state
    epoch = int(st.slot) // MINIMAL.SLOTS_PER_EPOCH
    hx = lambda b: "0x" + bytes(b).hex()  # noqa: E731
    head_root, parent_root = pair.port.head_root, bytes(plan.blocks[-2].message.hash_tree_root())
    att = plan.blocks[-1].message.body.attestations[0]
    pt = get_types(MINIMAL).altair
    return [
        ("getGenesis", "GET", "/eth/v1/beacon/genesis", None),
        ("getStateRoot", "GET", "/eth/v1/beacon/states/head/root", None),
        ("getStateRoot", "GET", "/eth/v1/beacon/states/finalized/root", None),
        ("getStateRoot", "GET", "/eth/v1/beacon/states/genesis/root", None),
        ("getStateRoot", "GET", f"/eth/v1/beacon/states/{hx(st.hash_tree_root())}/root", None),
        ("getStateRoot", "GET", f"/eth/v1/beacon/states/{hx(b'x' * 32)}/root", None),
        ("getStateRoot", "GET", "/eth/v1/beacon/states/justified/root", None),
        ("getStateFinalityCheckpoints", "GET", "/eth/v1/beacon/states/head/finality_checkpoints", None),
        ("getStateValidators", "GET", "/eth/v1/beacon/states/head/validators", None),
        ("getStateValidator", "GET", "/eth/v1/beacon/states/head/validators/3", None),
        ("getStateValidator", "GET",
         f"/eth/v1/beacon/states/head/validators/{hx(head.flat.pubkeys[5])}", None),
        ("getStateValidator", "GET", "/eth/v1/beacon/states/head/validators/9999", None),
        ("getStateValidator", "GET", f"/eth/v1/beacon/states/head/validators/{hx(b'p' * 48)}", None),
        ("getBlockHeader", "GET", "/eth/v1/beacon/headers/head", None),
        ("getBlockHeader", "GET", "/eth/v1/beacon/headers/finalized", None),
        ("getBlockHeader", "GET", f"/eth/v1/beacon/headers/{hx(parent_root)}", None),
        ("getBlockHeader", "GET", f"/eth/v1/beacon/headers/{hx(b'y' * 32)}", None),
        ("getBlockHeader", "GET", "/eth/v1/beacon/headers/7", None),
        ("getBlockV2", "GET", "/eth/v2/beacon/blocks/head", None),
        ("getBlockV2", "GET", f"/eth/v2/beacon/blocks/{hx(parent_root)}", None),
        ("getBlockRoot", "GET", "/eth/v1/beacon/blocks/head/root", None),
        ("submitPoolVoluntaryExit", "POST", "/eth/v1/beacon/pool/voluntary_exits",
         pt.SignedVoluntaryExit().to_obj()),
        ("submitPoolProposerSlashings", "POST", "/eth/v1/beacon/pool/proposer_slashings",
         pt.ProposerSlashing().to_obj()),
        ("submitPoolAttesterSlashings", "POST", "/eth/v1/beacon/pool/attester_slashings",
         pt.AttesterSlashing().to_obj()),
        ("getPoolProposerSlashings", "GET", "/eth/v1/beacon/pool/proposer_slashings", None),
        ("getPoolAttesterSlashings", "GET", "/eth/v1/beacon/pool/attester_slashings", None),
        ("getNodeVersion", "GET", "/eth/v1/node/version", None),
        ("getNodeIdentity", "GET", "/eth/v1/node/identity", None),
        ("getNodePeers", "GET", "/eth/v1/node/peers", None),
        ("getSyncingStatus", "GET", "/eth/v1/node/syncing", None),
        ("getHealth", "GET", "/eth/v1/node/health", None),
        ("getSpec", "GET", "/eth/v1/config/spec", None),
        ("getDepositContract", "GET", "/eth/v1/config/deposit_contract", None),
        ("getAttesterDuties", "POST", f"/eth/v1/validator/duties/attester/{epoch}",
         [str(i) for i in range(0, 64, 3)]),
        ("getAttesterDuties", "POST", f"/eth/v1/validator/duties/attester/{epoch + 5}", ["1"]),
        ("getProposerDuties", "GET", f"/eth/v1/validator/duties/proposer/{epoch}", None),
        ("getProposerDuties", "GET", f"/eth/v1/validator/duties/proposer/{epoch + 1}", None),
        ("getProposerDuties", "GET", f"/eth/v1/validator/duties/proposer/{epoch + 4}", None),
        ("produceBlockV2", "GET",
         f"/eth/v2/validator/blocks/{int(st.slot) + 1}?randao_reveal={_randao(plan, int(st.slot) + 1)}",
         None),
        ("produceAttestationData", "GET",
         f"/eth/v1/validator/attestation_data?slot={int(st.slot)}&committee_index=0", None),
        ("getAggregatedAttestation", "GET",
         f"/eth/v1/validator/aggregate_attestation?slot={int(att.data.slot)}"
         f"&attestation_data_root={hx(att.data.hash_tree_root())}", None),
        ("getAggregatedAttestation", "GET",
         f"/eth/v1/validator/aggregate_attestation?slot=1&attestation_data_root={hx(b'z' * 32)}",
         None),
        ("publishAggregateAndProofs", "POST", "/eth/v1/validator/aggregate_and_proofs", []),
        ("getLiveness", "POST", f"/eth/v1/validator/liveness/{epoch}", ["0", "1", "2", "40"]),
        ("prepareBeaconProposer", "POST", "/eth/v1/validator/prepare_beacon_proposer",
         [{"validator_index": "1", "fee_recipient": "0x" + "11" * 20}]),
        ("prepareBeaconProposer", "POST", "/eth/v1/validator/prepare_beacon_proposer",
         [{"validator_index": "1", "fee_recipient": "0x11"}]),
        ("getDebugChainHeadsV2", "GET", "/eth/v2/debug/beacon/heads", None),
        ("getStateV2", "GET", "/eth/v2/debug/beacon/states/head", None),
        ("getStateV2", "GET", "/eth/v2/debug/beacon/states/finalized", None),
        ("getLightClientBootstrap", "GET",
         f"/eth/v1/beacon/light_client/bootstrap/{hx(head_root)}", None),
        ("getLightClientUpdatesByRange", "GET",
         "/eth/v1/beacon/light_client/updates?start_period=0&count=2", None),
        ("getLightClientFinalityUpdate", "GET", "/eth/v1/beacon/light_client/finality_update",
         None),
        ("getLightClientOptimisticUpdate", "GET",
         "/eth/v1/beacon/light_client/optimistic_update", None),
        (None, "GET", "/eth/v1/nonexistent", None),
        (None, "POST", "/eth/v1/beacon/blocks", "not a block"),
    ]


@pytest.fixture(scope="module")
def posted(plan, pair):
    """The last block posted to both servers through `publishBlock`."""
    signed = plan.blocks[-1]
    for c in (pair.port, pair.jax):
        c.clock.set_slot(int(signed.message.slot))
    out = {}
    for name, server in pair.servers.items():
        client = (BeaconApiClient if name == "port" else JClient)("127.0.0.1", server.port)
        obj = signed.to_obj() if name == "port" else \
            torch_chain.to_jax(signed, "SignedBeaconBlock").to_obj()
        out[name] = client.publishBlock(body=obj)
    assert out == {"port": None, "jax": None}
    assert pair.port.head_root == pair.jax.head_root == signed.message.hash_tree_root()
    return out


def test_every_route_equal_over_http(plan, pair, posted):
    """Each request of `_requests`: equal status, JSON body and headers;
    every route of the table is covered."""
    reqs = _requests(plan, pair)
    assert {r[0] for r in reqs if r[0]} == {r.operation_id for r in API_ROUTES} - {
        "publishBlock", "submitPoolAttestations"}  # posted above; the quirk test below
    statuses = {}
    for op, method, path, body in reqs:
        got = pair.both(method, path, body)
        assert got["port"] == got["jax"], (op, path, got["port"][:2], got["jax"][:2])
        statuses.setdefault(op, set()).add(got["port"][0])
    assert statuses["getStateRoot"] == {200, 400, 404, 501}
    assert statuses["getStateValidator"] == {200, 404}
    assert statuses["getProposerDuties"] == {200, 400}
    assert statuses[None] == {404, 500}
    assert statuses["produceBlockV2"] == {200}
    raw = {}
    for name, server in pair.servers.items():  # a body that is not JSON
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
        conn.request("POST", "/eth/v1/beacon/blocks", body=b"{not json",
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw[name] = (resp.status, resp.read())
        conn.close()
    assert raw["port"] == raw["jax"] and raw["port"][0] == 400


def test_clients_cross_packages(plan, pair, posted):
    """The port's client against the JAX server and the JAX client against
    the port's: each GET route with path parameters only gives what the
    same client gets from its own package's server; an error carries the
    same status."""
    clients = {(c, s): (BeaconApiClient if c == "port" else JClient)(
        "127.0.0.1", pair.servers[s].port) for c in ("port", "jax") for s in ("port", "jax")}
    calls = [("getGenesis", ()), ("getStateRoot", ("head",)),
             ("getStateFinalityCheckpoints", ("head",)), ("getStateValidator", ("head", "7")),
             ("getBlockHeader", ("head",)), ("getBlockV2", ("head",)),
             ("getBlockRoot", ("head",)), ("getSyncingStatus", ()), ("getSpec", ()),
             ("getProposerDuties", ("2",)), ("getDebugChainHeadsV2", ()),
             ("getStateV2", ("finalized",))]
    for op, args in calls:
        got = {k: getattr(c, op)(*args) for k, c in clients.items()}
        assert len({json.dumps(v, sort_keys=True) for v in got.values()}) == 1, op
    for (c, s), client in clients.items():
        err = ApiClientError if c == "port" else __import__(
            "lodestar_tpu.api.client", fromlist=["ApiClientError"]).ApiClientError
        with pytest.raises(err) as ei:
            client.getStateValidator("head", "9999")
        assert ei.value.status == 404


def test_bearer_token_and_cors(plan):
    """Both servers with a bearer token and a CORS origin: no or a wrong
    token is 401, the right one 200, preflights answered tokenless, the
    same headers on every answer."""
    p = Pair(plan, direct=1, bearer_token=TOKEN, cors_origin=ORIGIN)
    try:
        cases = [("GET", "/eth/v1/node/version", {}),
                 ("GET", "/eth/v1/node/version", {"Authorization": "Bearer nope"}),
                 ("GET", "/eth/v1/node/version", {"Authorization": f"Bearer {TOKEN}"}),
                 ("GET", "/eth/v1/beacon/headers/head", {"Authorization": f"Bearer {TOKEN}"}),
                 ("GET", "/eth/v1/nonexistent", {"Authorization": f"Bearer {TOKEN}"}),
                 ("OPTIONS", "/eth/v1/node/version", {"Origin": ORIGIN})]
        seen = []
        for method, path, headers in cases:
            got = p.both(method, path, headers=headers)
            assert got["port"] == got["jax"], (method, path, headers)
            seen.append(got["port"][0])
            if method != "OPTIONS":
                assert got["port"][2].get("Access-Control-Allow-Origin") == ORIGIN
        assert seen == [401, 401, 200, 200, 404, 204]
    finally:
        p.close()


def test_event_stream_delivers_the_same_events(plan):
    """SSE /eth/v1/events on both servers: importing the next block emits
    the same block and head events to a subscriber of each."""
    import queue
    import threading
    import time

    from lodestar_tpu_torch.api.client import stream_events

    p = Pair(plan, direct=2)
    try:
        got = {name: queue.Queue() for name in p.servers}

        def consume(name):
            try:
                for ev in stream_events("127.0.0.1", p.servers[name].port,
                                        topics=["block", "head"], timeout=15):
                    got[name].put(ev)
            except Exception as e:  # noqa: BLE001
                got[name].put(("error", str(e)))

        for name in p.servers:
            threading.Thread(target=consume, args=(name,), daemon=True).start()
        time.sleep(0.3)
        signed = plan.blocks[2]
        for c in (p.port, p.jax):
            c.clock.set_slot(int(signed.message.slot))
        p.port.process_block(signed)
        p.jax.process_block(torch_chain.to_jax(signed, "SignedBeaconBlock"))
        events = {name: [q.get(timeout=10) for _ in range(2)] for name, q in got.items()}
        assert events["port"] == events["jax"]
        assert {e for e, _ in events["port"]} == {"block", "head"}
    finally:
        p.close()


def test_submit_pool_attestations_skips_the_signature_check(plan):
    """The reference quirk both packages keep (ROADMAP Queue 3): an
    attestation whose signature is garbage, POSTed to
    submitPoolAttestations, is answered 200 and lands in the aggregated
    pool; the same garbage on a voluntary exit is refused 400."""
    p = Pair(plan, direct=3)
    try:
        # the newest aggregate of the slot-9 block (slot 8, target epoch 1:
        # newer than any vote of blocks 1-3)
        att = max(plan.blocks[3].message.body.attestations, key=lambda a: int(a.data.slot)).copy()
        att.data.beacon_block_root = plan.blocks[1].message.hash_tree_root()  # a new vote
        att.signature = b"\xc0" + b"\x00" * 95  # infinity: no valid aggregate
        bodies = {"port": [att.to_obj()],
                  "jax": [torch_chain.to_jax(att, "Attestation").to_obj()]}
        for c in (p.port, p.jax):
            c.clock.set_slot(int(att.data.slot) + 1)
        votes = {name: dict(c.fork_choice._vote_next) for name, c in
                 (("port", p.port), ("jax", p.jax))}
        got = {name: _request(s.port, "POST", "/eth/v1/beacon/pool/attestations", bodies[name])
               for name, s in p.servers.items()}
        assert got["port"] == got["jax"] and got["port"][0] == 200
        root = att.data.hash_tree_root()
        for name, c in (("port", p.port), ("jax", p.jax)):
            _, variants = c.aggregated_pool._by_root[root]
            assert variants == [(list(att.aggregation_bits), bytes(att.signature))]
            moved = {v: r for v, r in c.fork_choice._vote_next.items() if votes[name].get(v) != r}
            assert moved and set(moved.values()) == {bytes(att.data.beacon_block_root)}
            votes[name] = moved
        assert votes["port"] == votes["jax"]
        exit_ = get_types(MINIMAL).altair.SignedVoluntaryExit()
        exit_.signature = bytes(att.signature)
        got = p.both("POST", "/eth/v1/beacon/pool/voluntary_exits", exit_.to_obj())
        assert got["port"] == got["jax"] and got["port"][0] == 400
    finally:
        p.close()

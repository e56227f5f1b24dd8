"""The port's `execution/` (engine API mock and JSON-RPC client, builder
relay client and mock relay) against the JAX package's `execution/`: the
same calls on both sides give the same statuses, payload ids, payloads,
JSON and JWTs (the clock fixed), and the HTTP clients send the same
requests to a recording server on 127.0.0.1 (`torch_loopback.py`).
Payloads are made from a numpy seed on the minimal preset. Tolerance:
equal."""

import base64
import json

import numpy as np
import pytest
import torch_loopback

from lodestar_tpu.execution import builder as jbuilder
from lodestar_tpu.execution import engine as jengine
from lodestar_tpu.params.presets import MINIMAL as JMINIMAL
from lodestar_tpu.types import get_types as jget_types
from lodestar_tpu_torch.execution import builder, engine
from lodestar_tpu_torch.params.presets import MINIMAL
from lodestar_tpu_torch.types import get_types

SEED = 18
GENESIS_HASH = b"\x01" * 32
NOW = 1_700_000_000


def payload(rng, fork="capella", withdrawals=3):
    """A port ExecutionPayload of `fork` with seeded fields."""
    t = getattr(get_types(MINIMAL), fork)
    fields = dict(
        parent_hash=rng.bytes(32), fee_recipient=rng.bytes(20), state_root=rng.bytes(32),
        receipts_root=rng.bytes(32), logs_bloom=rng.bytes(256), prev_randao=rng.bytes(32),
        block_number=int(rng.integers(1, 2**40)), gas_limit=30_000_000,
        gas_used=int(rng.integers(0, 30_000_000)), timestamp=int(rng.integers(1, 2**40)),
        extra_data=rng.bytes(7), base_fee_per_gas=int(rng.integers(1, 2**60)),
        block_hash=rng.bytes(32), transactions=[rng.bytes(int(k)) for k in (1, 40, 3)])
    if fork == "capella":
        fields["withdrawals"] = [t.Withdrawal(index=i, validator_index=int(rng.integers(0, 64)),
                                              address=rng.bytes(20),
                                              amount=int(rng.integers(1, 2**40)))
                                 for i in range(withdrawals)]
    return t.ExecutionPayload(**fields)


def to_jax(value, fork="capella"):
    return getattr(jget_types(JMINIMAL), fork).ExecutionPayload.deserialize(value.serialize())


@pytest.fixture
def fixed_clock(monkeypatch):
    monkeypatch.setattr(engine.time, "time", lambda: NOW)
    monkeypatch.setattr(jengine.time, "time", lambda: NOW)


def _mock_flow(mod):
    """Build and import a chain of payloads through one mock EL; the
    statuses, payload ids and built payloads in order."""
    el = mod.ExecutionEngineMock(genesis_block_hash=GENESIS_HASH)
    out, head = [], GENESIS_HASH
    for k in range(1, 5):
        attrs = mod.PayloadAttributes(timestamp=1000 + 12 * k, prev_randao=bytes([k]) * 32,
                                      suggested_fee_recipient=b"\x22" * 20)
        pid = el.notify_forkchoice_update(head, head, GENESIS_HASH, attrs)
        built = el.get_payload(pid, "capella")
        status = el.notify_new_payload(built)
        out.append((pid, built.block_hash, built.parent_hash, built.block_number,
                    built.timestamp, status.value, el.head))
        head = built.block_hash
    # unknown parent: SYNCING; a number that does not follow: INVALID; a hook
    orphan = mod._MockPayload(block_hash=b"\x09" * 32, parent_hash=b"\x08" * 32, block_number=9,
                              timestamp=0, prev_randao=b"", fee_recipient=b"")
    skip = mod._MockPayload(block_hash=b"\x0a" * 32, parent_hash=head, block_number=99,
                            timestamp=0, prev_randao=b"", fee_recipient=b"")
    el.invalid_hashes.add(b"\x0b" * 32)
    hooked = mod._MockPayload(block_hash=b"\x0b" * 32, parent_hash=head, block_number=5,
                              timestamp=0, prev_randao=b"", fee_recipient=b"")
    out.append([el.notify_new_payload(p).value for p in (orphan, skip, hooked)])
    out.append(el.notify_forkchoice_update(b"\x07" * 32, head, head))  # unknown head: None
    return out


def test_mock_el_build_and_import_flow():
    assert _mock_flow(engine) == _mock_flow(jengine)


@pytest.mark.parametrize("mod", [engine, jengine], ids=["port", "jax"])
def test_payload_ids_are_single_use(mod):
    el = mod.ExecutionEngineMock(genesis_block_hash=GENESIS_HASH)
    attrs = mod.PayloadAttributes(timestamp=12, prev_randao=b"\x01" * 32,
                                  suggested_fee_recipient=b"\x02" * 20, withdrawals=[1, 2])
    pid = el.notify_forkchoice_update(GENESIS_HASH, GENESIS_HASH, GENESIS_HASH, attrs)
    assert el.get_payload(pid).withdrawals == [1, 2]
    with pytest.raises(ValueError, match="unknown payload id"):
        el.get_payload(pid)


@pytest.mark.parametrize("fork", ["bellatrix", "capella"])
def test_payload_to_engine_json(fork):
    rng = np.random.default_rng(SEED)
    for _ in range(3):
        p = payload(rng, fork)
        ours = engine.payload_to_engine_json(p)
        assert ours == jengine.payload_to_engine_json(to_jax(p, fork))
        for snake in ("block_hash", "base_fee_per_gas", "withdrawals", "nothing"):
            assert engine.engine_json_field(ours, snake, 0) == jengine.engine_json_field(
                ours, snake, 0)
            assert engine.engine_json_field(p, snake, 0) == getattr(p, snake, 0)


def test_jwt_at_a_fixed_time(fixed_clock):
    for secret in (b"\x00" * 32, np.random.default_rng(SEED).bytes(32)):
        token = engine._jwt_hs256(secret)
        assert token == jengine._jwt_hs256(secret)
        claims = token.split(".")[1]
        assert json.loads(base64.urlsafe_b64decode(claims + "=" * (-len(claims) % 4))) == {
            "iat": NOW}


def _engine_results():
    return {
        "engine_newPayloadV1": lambda params: {"status": "VALID", "latestValidHash": None},
        "engine_newPayloadV2": lambda params: {
            "status": "INVALID", "latestValidHash": "0x" + "ab" * 32},
        "engine_forkchoiceUpdatedV1": lambda params: {"payloadId": None},
        "engine_forkchoiceUpdatedV2": lambda params: {"payloadId": "0x0000000000000007"},
        "engine_getPayloadV1": lambda params: {"blockHash": "0x" + "11" * 32},
        "engine_getPayloadV2": lambda params: {"executionPayload": {"blockHash": "0x" + "22" * 32},
                                               "blockValue": "0x1"},
        "engine_exchangeTransitionConfigurationV1": lambda params: params[0],
    }


def _engine_calls(mod, port, rng, fork_types):
    client = mod.ExecutionEngineHttp("127.0.0.1", port, b"\x42" * 32, timeout=5.0, retries=0)
    bellatrix, capella = payload(rng, "bellatrix"), payload(rng, "capella")
    if fork_types == "jax":
        bellatrix, capella = to_jax(bellatrix, "bellatrix"), to_jax(capella, "capella")
    out = [client.notify_new_payload(bellatrix).value, client.last_latest_valid_hash,
           client.notify_new_payload(capella).value, client.last_latest_valid_hash]
    attrs = mod.PayloadAttributes(timestamp=1234, prev_randao=b"\x05" * 32,
                                  suggested_fee_recipient=b"\x06" * 20,
                                  withdrawals=list(capella.withdrawals))
    out.append(client.notify_forkchoice_update(b"\x01" * 32, b"\x02" * 32, b"\x03" * 32))
    out.append(client.notify_forkchoice_update(b"\x01" * 32, b"\x02" * 32, b"\x03" * 32, attrs))
    out.append(client.get_payload("0x01", "bellatrix"))
    out.append(client.get_payload("0x01", "capella"))
    out.append(client.exchange_transition_configuration(2**60, b"\x0c" * 32))
    with pytest.raises(RuntimeError, match="engine_nope"):
        client._call("engine_nope", [])
    return out


def test_engine_http_client_sends_the_jax_requests(fixed_clock):
    results = _engine_results()
    results["engine_nope"] = lambda params: (_ for _ in ()).throw(ValueError("no such method"))
    with torch_loopback.LoopbackServer(torch_loopback.jsonrpc(results)) as server:
        ours = _engine_calls(engine, server.port, np.random.default_rng(SEED), "port")
        mine = server.take()
        theirs = _engine_calls(jengine, server.port, np.random.default_rng(SEED), "jax")
        their_requests = server.take()
    assert ours == theirs
    assert mine == their_requests
    assert [r["body"]["method"] for r in mine][:4] == [
        "engine_newPayloadV1", "engine_newPayloadV2", "engine_forkchoiceUpdatedV1",
        "engine_forkchoiceUpdatedV2"]
    assert all(r["auth"] == "Bearer " + engine._jwt_hs256(b"\x42" * 32) for r in mine)


def _builder_calls(client_mod, relay_port):
    client = client_mod.BuilderApiClient("127.0.0.1", relay_port, timeout=5.0)
    header = {"parent_hash": "0x" + "aa" * 32, "block_hash": "0x" + "bb" * 32}
    blinded = {"message": {"body": {"execution_payload_header": header}}, "signature": "0x00"}
    return [
        client.check_status(),
        client.register_validators([{"message": {"pubkey": "0x" + "01" * 48}}]),
        client.get_header(5, b"\xaa" * 32, b"\x01" * 48),
        client.get_header(5, b"\xcc" * 32, b"\x01" * 48),
        client.submit_blinded_block(blinded),
    ]


@pytest.mark.parametrize("relay_mod", [builder, jbuilder], ids=["port relay", "jax relay"])
def test_builder_client_against_the_mock_relays(relay_mod):
    """Each client against each package's mock relay: the same bids, reveals
    and registrations."""
    results = []
    for client_mod in (builder, jbuilder):
        relay = relay_mod.MockBuilderRelay()
        relay.offer_payload(b"\xaa" * 32, {"block_hash": "0x" + "bb" * 32},
                            {"block_hash": "0x" + "bb" * 32, "transactions": []}, value="7")
        relay.start()
        try:
            results.append((_builder_calls(client_mod, relay.port), relay.registrations))
        finally:
            relay.close()
    assert results[0] == results[1]
    calls, registrations = results[0]
    assert calls[0] is True and calls[2] == {"header": {"block_hash": "0x" + "bb" * 32},
                                             "value": "7"}
    assert calls[3] is None and registrations == [{"message": {"pubkey": "0x" + "01" * 48}}]


def test_builder_client_sends_the_jax_requests():
    def respond(method, path, body):
        if path.endswith(("/status", "/validators")):
            return 200, {}
        if "/header/" in path:
            return 200, {"data": {"header": {"path": path}, "value": "3"}}
        if path.endswith("/blinded_blocks"):
            return 200, {"data": body}
        return 400, {"message": "refused"}

    with torch_loopback.LoopbackServer(respond) as server:
        ours = _builder_calls(builder, server.port)
        mine = server.take()
        theirs = _builder_calls(jbuilder, server.port)
        their_requests = server.take()
        with pytest.raises(builder.BuilderApiError, match="400"):
            builder.BuilderApiClient("127.0.0.1", server.port)._request("GET", "/nope")
    assert ours == theirs and mine == their_requests
    assert [r["path"] for r in mine][:2] == ["/eth/v1/builder/status",
                                            "/eth/v1/builder/validators"]

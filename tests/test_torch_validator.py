"""The port's validator client core (`validator/slashing_protection.py`,
`store.py`, `service.py`) against the JAX package's, mirroring
`tests/test_validator.py`.

Slashing protection: the same seeded sequences of block proposals and
attestations (surround and double votes, the pruned exact-root window,
the span floor and wide votes under a short lookback, the migration of
old-format records and its replay failure, the random-span property of
`tests/test_validator.py:175`) through both packages, each over its own
`MemoryDb`: every accept and refusal, the repository contents and the
EIP-3076 interchange JSON are equal, and an interchange exported by one
package imports into the other to the same repository contents.

`ValidatorService` drives the port's `BeaconChain` (the host tier's
`CpuBlsVerifier`) and the JAX package's over 3 epochs of 16 validators to
justification: the head root after every slot is the same; a re-signed
old block slot raises `SlashingError`. Tolerance: byte-equality
throughout.
"""

import json
import random

import pytest

from lodestar_tpu.bls import api as jbls
from lodestar_tpu.chain import BeaconChain as JBeaconChain
from lodestar_tpu.config.beacon_config import BeaconConfig as JBeaconConfig
from lodestar_tpu.config.beacon_config import ChainForkConfig as JChainForkConfig
from lodestar_tpu.config.chain_config import MINIMAL_CHAIN_CONFIG as J_MINIMAL_CC
from lodestar_tpu.db import MemoryDb as JMemoryDb
from lodestar_tpu.params.presets import MINIMAL as JMINIMAL
from lodestar_tpu.state_transition import interop_genesis_state as j_interop_genesis
from lodestar_tpu.types import get_types as jget_types
from lodestar_tpu.validator import SlashingError as JSlashingError
from lodestar_tpu.validator import SlashingProtection as JSlashingProtection
from lodestar_tpu.validator import ValidatorService as JValidatorService
from lodestar_tpu.validator import ValidatorStore as JValidatorStore
from lodestar_tpu_torch.bls import api as bls
from lodestar_tpu_torch.chain import BeaconChain
from lodestar_tpu_torch.chain.bls_verifier import CpuBlsVerifier
from lodestar_tpu_torch.config.beacon_config import BeaconConfig, ChainForkConfig
from lodestar_tpu_torch.config.chain_config import MINIMAL_CHAIN_CONFIG
from lodestar_tpu_torch.db import MemoryDb
from lodestar_tpu_torch.metrics.beacon import create_beacon_metrics
from lodestar_tpu_torch.params.presets import MINIMAL
from lodestar_tpu_torch.state_transition import interop_genesis_state
from lodestar_tpu_torch.types import get_types
from lodestar_tpu_torch.validator import (
    SlashingError,
    SlashingProtection,
    ValidatorService,
    ValidatorStore,
)

PACKAGES = {
    "port": (SlashingProtection, SlashingError, MemoryDb),
    "jax": (JSlashingProtection, JSlashingError, JMemoryDb),
}
PKS = [bytes([0xA0 + i]) * 48 for i in range(3)]
PK = PKS[0]
GVR = bytes(range(32))


def _root(i: int) -> bytes:
    return bytes([i % 7]) * 32


def _mixed(rng):
    """Three keys, blocks at rising slots with repeats and stale slots,
    attestations over a 64-epoch window with roots from 7 values."""
    ops, slots = [], {pk: 0 for pk in PKS}
    for i in range(600):
        pk = PKS[rng.randrange(3)]
        if rng.random() < 0.3:
            slots[pk] += rng.choice((-3, 0, 0, 1, 2))
            ops.append(("block", pk, max(0, slots[pk]), _root(rng.randrange(3))))
        else:
            s = rng.randrange(0, 64)
            ops.append(("att", pk, s, s + rng.randrange(0, 10), _root(rng.randrange(7))))
    return 8192, ops


def _pruned_window(rng):
    """`tests/test_validator.py`'s pruned-history cases: surround and
    surrounded votes answered by the spans after the exact-root window
    dropped them, and a double vote below the window refused."""
    ops = [("att", PK, 10, 11, b"\x01" * 32)]
    ops += [("att", PK, e - 1, e, bytes([e % 256]) * 32) for e in range(12, 612)]
    ops += [("att", PK, 9, 700, b"\x02" * 32), ("att", PK, 0, 40, b"\xfe" * 32),
            ("att", PKS[1], 100, 640, b"\x01" * 32)]
    ops += [("att", PKS[1], e - 1, e, bytes([e % 256]) * 32) for e in range(641, 1400)]
    ops += [("att", PKS[1], 200, 300, b"\x02" * 32), ("att", PKS[1], 1399, 1400, b"\x03" * 32)]
    ops += [("block", PK, s, _root(s)) for s in range(0, 80)]  # past the 64-root window
    ops += [("block", PK, 5, _root(5)), ("block", PK, 79, _root(79)), ("block", PK, 79, b"\x09" * 32)]
    return 8192, ops


def _short_lookback(rng):
    """A 64-epoch lookback: the span floor advances and refuses deep
    sources; wide votes land on the wide list and still bite."""
    ops = [("att", PK, 500, 501, b"\x01" * 32), ("att", PK, 100, 502, b"\x02" * 32),
           ("att", PKS[1], 100, 1000, b"\x01" * 32), ("att", PKS[1], 500, 600, b"\x02" * 32),
           ("att", PKS[1], 99, 1001, b"\x03" * 32), ("att", PKS[1], 90, 2000, b"\x04" * 32),
           ("att", PKS[1], 1000, 1001, b"\x05" * 32)]
    for i in range(200):
        s = rng.randrange(900, 1200)
        ops.append(("att", PKS[2], s, s + rng.randrange(1, 120), _root(i)))
    return 64, ops


def _migration(rng):
    """Old-format records (targets, no spans) migrate by replay; a replay
    that fails fences its target off through `pruned_below`."""
    old = {"targets": {"60": {"source": 50, "root": "aa" * 32},
                       "61": {"source": 60, "root": "bb" * 32}},
           "max_target": 61, "min_source": 50}
    lossy = {"targets": {"200": {"source": 0, "root": "aa" * 32},
                         "210": {"source": 100, "root": "bb" * 32}},
             "max_target": 210, "min_source": 0}
    ops = [("old", PK, old), ("att", PK, 40, 100, b"\x02" * 32),
           ("att", PK, 50, 60, b"\x0c" * 32), ("att", PK, 50, 60, b"\xaa" * 32),
           ("att", PK, 30, 45, b"\x03" * 32), ("att", PK, 61, 62, b"\x04" * 32),
           ("old", PKS[1], lossy), ("att", PKS[1], 211, 212, b"\x01" * 32),
           ("att", PKS[1], 150, 210, b"\x02" * 32)]
    return 64, ops


def _random_span(rng):
    """`tests/test_validator.py:175`: 400 random votes against one key."""
    ops = []
    for i in range(400):
        s = rng.randrange(0, 256)
        ops.append(("att", PK, s, s + rng.randrange(1, 40), _root(i)))
    return 8192, ops


SCENARIOS = {"mixed": _mixed, "pruned_window": _pruned_window,
             "short_lookback": _short_lookback, "migration": _migration,
             "random_span": _random_span}


def _apply(protection, error, op) -> bool:
    kind, pk, *args = op
    if kind == "old":
        protection.atts.put(pk, args[0])
        return True
    try:
        if kind == "block":
            protection.check_and_insert_block_proposal(pk, *args)
        else:
            protection.check_and_insert_attestation(pk, *args)
        return True
    except error:
        return False


def _run(package: str, scenario: str):
    cls, error, db_cls = PACKAGES[package]
    lookback, ops = SCENARIOS[scenario](random.Random(f"slashing-{scenario}"))
    db = db_cls()
    protection = cls(db, max_epoch_lookback=lookback)
    verdicts = [_apply(protection, error, op) for op in ops]
    return verdicts, dict(db._data), protection.export_interchange(GVR, PKS)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_slashing_protection_equals_jax(scenario):
    verdicts, contents, interchange = _run("port", scenario)
    j_verdicts, j_contents, j_interchange = _run("jax", scenario)
    assert verdicts == j_verdicts
    assert True in verdicts and False in verdicts
    assert contents == j_contents
    assert json.dumps(interchange, sort_keys=True) == json.dumps(j_interchange, sort_keys=True)
    assert interchange["metadata"] == {"interchange_format_version": "5",
                                       "genesis_validators_root": "0x" + GVR.hex()}

    # the interchange both ways: each package imports the other's export
    port_in, jax_in = MemoryDb(), JMemoryDb()
    SlashingProtection(port_in).import_interchange(j_interchange)
    JSlashingProtection(jax_in).import_interchange(interchange)
    assert port_in._data == jax_in._data
    assert port_in._data  # something was carried over
    # and refuses what the exporter signed, with another root
    reimported = SlashingProtection(port_in)
    for entry in j_interchange["data"]:
        pk = bytes.fromhex(entry["pubkey"][2:])
        for b in entry["signed_blocks"][-1:]:
            with pytest.raises(SlashingError):
                reimported.check_and_insert_block_proposal(pk, int(b["slot"]), b"\xee" * 32)
        for a in entry["signed_attestations"][-1:]:
            with pytest.raises(SlashingError):
                reimported.check_and_insert_attestation(
                    pk, int(a["source_epoch"]), int(a["target_epoch"]), b"\xee" * 32)


def test_random_span_property():
    """The span answers equal the brute-force surround scan over the full
    vote history (`tests/test_validator.py:175`), in the port."""
    protection = SlashingProtection(MemoryDb())
    rng = random.Random(1234)
    accepted, used_targets = [], {}
    for i in range(400):
        s = rng.randrange(0, 256)
        t = s + rng.randrange(1, 40)
        brute_reject = any((s < s2 and t > t2) or (s > s2 and t < t2) for s2, t2 in accepted)
        ok = _apply(protection, SlashingError, ("att", PK, s, t, bytes([i % 7]) * 32))
        if t in used_targets:
            assert ok == (used_targets[t] == i % 7), (i, s, t)
        else:
            assert ok == (not brute_reject), (i, s, t)
        if ok and t not in used_targets:
            accepted.append((s, t))
            used_targets[t] = i % 7


N = 16
SPE = MINIMAL.SLOTS_PER_EPOCH


def _chains():
    genesis_time = 1_600_000_000
    types = get_types(MINIMAL).phase0
    state = interop_genesis_state(ChainForkConfig(MINIMAL_CHAIN_CONFIG, MINIMAL), types, N,
                                  genesis_time=genesis_time)
    config = BeaconConfig(MINIMAL_CHAIN_CONFIG, bytes(state.genesis_validators_root), MINIMAL)
    chain = BeaconChain(config, types, state, verifier=CpuBlsVerifier())
    store = ValidatorStore(config, SlashingProtection(MemoryDb()))
    jtypes = jget_types(JMINIMAL).phase0
    jstate = j_interop_genesis(JChainForkConfig(J_MINIMAL_CC, JMINIMAL), jtypes, N,
                               genesis_time=genesis_time)
    jconfig = JBeaconConfig(J_MINIMAL_CC, bytes(jstate.genesis_validators_root), JMINIMAL)
    jchain = JBeaconChain(jconfig, jtypes, jstate)
    jstore = JValidatorStore(jconfig, JSlashingProtection(JMemoryDb()))
    for i in range(N):
        store.add_secret_key(bls.interop_secret_key(i))
        jstore.add_secret_key(jbls.interop_secret_key(i))
    metrics = create_beacon_metrics()
    service = ValidatorService(config, types, chain, store, metrics=metrics)
    jservice = JValidatorService(jconfig, jtypes, jchain, jstore)
    return (types, chain, store, service, metrics), (jchain, jservice)


def test_validator_service_drives_chain_to_justification():
    (types, chain, store, service, metrics), (jchain, jservice) = _chains()
    try:
        duties = service.get_attester_duties(0)
        assert sorted(d.validator_index for d in duties) == list(range(N))
        assert [(d.validator_index, d.slot, d.committee_index) for d in duties] == \
            [(d.validator_index, d.slot, d.committee_index) for d in jservice.get_attester_duties(0)]
        assert len(service.get_proposer_duties(0)) == SPE  # every validator is ours

        for slot in range(1, 3 * SPE + 1):
            chain.clock.set_slot(slot)
            jchain.clock.set_slot(slot)
            signed = service.propose_block_if_due(slot)
            jsigned = jservice.propose_block_if_due(slot)
            assert signed is not None
            assert signed.message.hash_tree_root() == jsigned.message.hash_tree_root(), slot
            assert bytes(signed.signature) == bytes(jsigned.signature), slot
            produced = service.attest_if_due(slot)
            jproduced = jservice.attest_if_due(slot)
            assert [bytes(a.signature) for a in produced] == \
                [bytes(a.signature) for a in jproduced], slot
            aggregates = service.aggregate_if_due(slot, produced)
            jaggregates = jservice.aggregate_if_due(slot, jproduced)
            assert [a.hash_tree_root() for a in aggregates] == \
                [a.hash_tree_root() for a in jaggregates], slot
            assert chain.head_root == jchain.head_root, slot

        assert chain.justified_checkpoint[0] >= 1
        assert chain.justified_checkpoint == jchain.justified_checkpoint
        assert chain.finalized_checkpoint == jchain.finalized_checkpoint
        text = metrics.registry.expose()
        assert f'lodestar_vc_duties_total{{kind="block",outcome="published"}} {3 * SPE}' in text
        # slashing protection refuses re-signing an old block slot
        proposer_pk = next(pk for pk in store.pubkeys
                           if (store.protection.blocks.get(pk) or {}).get("max_slot", -1) >= 1)
        with pytest.raises(SlashingError):
            store.sign_block(proposer_pk, types, types.BeaconBlock(slot=1, proposer_index=0))
    finally:
        chain.close()

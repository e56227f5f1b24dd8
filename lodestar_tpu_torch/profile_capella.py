"""A post-merge Capella chain on the GPU: the port's `BeaconChain` with the
mock execution engine, each block's signature sets verified by the
port's serving stack.

    python3 -m lodestar_tpu_torch.profile_capella [--validators 16384] [--device cuda]
        [--preset mainnet|minimal] [--verifier stack|host]

On `profile_block`'s interop genesis (`--validators` validators, the
mainnet preset by default), upgraded at slot 0 to Altair, Bellatrix and
Capella under a config with all three at epoch 0 (the JAX
`tests/test_execution_chain.py` fixture: the payload header anchored at
`EL_GENESIS_HASH` and the genesis time, validators 0–63 given an excess
balance of MAX_EFFECTIVE_BALANCE + 1,000,000 Gwei, their credentials
left BLS), it builds a `BeaconChain` with an `ExecutionEngineMock` and a
`ManualClock` and, with every signature verdict given by the verifier
(`run`):

(a) advances a copy of the genesis under a second config (Altair at 1,
    Bellatrix at 2, Capella at 3) epoch by epoch to Capella's first slot
    with `process_slots`: the fork is Capella, the payload header the
    default one, the withdrawal cursors 0 (no verdict);
(b) slot 1: with 2 × MAX_BLS_TO_EXECUTION_CHANGES signed changes in the
    pool (of the validators from where the slot-2 sweep starts: 0.. on
    mainnet at 16,384 validators, 16.. on minimal at 64) and every sync subcommittee's full
    contribution on the genesis root, produces a block (`produce_block`,
    its payload built by the engine), validates it as gossip (ACCEPT)
    and imports it: its sets are proposer, RANDAO, sync aggregate and one
    per change; the changed validators hold 0x01 credentials, the
    engine's head is the payload's hash and the head moved;
(c) slot 2: one full aggregate per committee of slot 1 through the
    attestation pool and full sync contributions on block 1, then a block
    carrying them and the other changes,
    whose payload withdraws the excess of the changed validators (the
    sweep is timed on its own); the withdrawals must be the sweep's, the
    balances debited and `next_withdrawal_index` moved on;
(d) slot 3: a produced block (with full sync contributions on block 2
    and MAX_BLS_TO_EXECUTION_CHANGES more changes in the pool) one of
    whose changes carries another change's
    signature, re-rooted and signed again by its proposer: the verdict
    is False, the per-set verdicts blame exactly that change, the import
    raises and the head stays;
(e) slot 3: a produced block whose payload hash the engine calls
    INVALID: the import raises on the payload while the verdict is True,
    and fork choice does not take the block;
(f) `prepare_next_slot.on_slot(2)` opens an engine building session for
    slot 3; the block produced from the prepared state validates as
    gossip and imports as head, and the engine's head follows it.

Prints one line per step and one JSON line (also written to `--out`,
default build/lodestar_tpu_torch/profile_capella.json); exits 1 if a
check failed. The verdicts come from the port's serving stack on
`--device` (a GPU unless `--device cpu`), or with `--verifier host` from
the C host tier alone (no stack, no device). On the CPU: `--preset
minimal --validators 64 --verifier host` runs in seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from . import profile_block, profile_chain

EL_GENESIS_HASH = b"\x01" * 32
EXCESS_VALIDATORS = 64
EXCESS_GWEI = 1_000_000


def capella_genesis(config, genesis, preset):
    """(config with Altair, Bellatrix and Capella at epoch 0, the Capella
    state made from `genesis`'s state at slot 0 as the JAX execution-chain
    fixture makes it)."""
    from .config.beacon_config import BeaconConfig
    from .state_transition.altair import upgrade_state_to_altair
    from .state_transition.bellatrix import upgrade_state_to_bellatrix
    from .state_transition.capella import upgrade_state_to_capella
    from .types import get_types

    cc = config.chain.with_overrides(ALTAIR_FORK_EPOCH=0, BELLATRIX_FORK_EPOCH=0,
                                     CAPELLA_FORK_EPOCH=0)
    t = get_types(preset)
    config = BeaconConfig(cc, bytes(genesis.state.genesis_validators_root), preset)
    genesis.sync_flat()
    state = upgrade_state_to_altair(config, preset, genesis.state, t.altair)
    state = upgrade_state_to_bellatrix(config, preset, state, t.bellatrix)
    state = upgrade_state_to_capella(config, preset, state, t.capella)
    state.latest_execution_payload_header.block_hash = EL_GENESIS_HASH
    state.latest_execution_payload_header.timestamp = state.genesis_time
    for v in range(min(EXCESS_VALIDATORS, len(state.balances))):
        state.balances[v] = preset.MAX_EFFECTIVE_BALANCE + EXCESS_GWEI
    return config, state


def scheduled_upgrades(config, genesis, preset, log=print) -> dict:
    """Step (a): a copy of `genesis` under Altair at 1, Bellatrix at 2 and
    Capella at 3, advanced epoch by epoch to Capella's first slot."""
    from .config.beacon_config import BeaconConfig
    from .params import ForkName
    from .state_transition import CachedBeaconState, process_slots
    from .state_transition.stf import fork_types

    cc = config.chain.with_overrides(ALTAIR_FORK_EPOCH=1, BELLATRIX_FORK_EPOCH=2,
                                     CAPELLA_FORK_EPOCH=3)
    genesis.sync_flat()
    t0 = time.perf_counter()
    cached = CachedBeaconState(
        BeaconConfig(cc, bytes(genesis.state.genesis_validators_root), preset),
        genesis.state.copy(), preset)
    rec = {"copy_s": time.perf_counter() - t0, "epochs": []}
    spe = preset.SLOTS_PER_EPOCH
    for epoch in range(1, cc.CAPELLA_FORK_EPOCH + 1):
        t0 = time.perf_counter()
        process_slots(cached, fork_types(cached), epoch * spe)
        rec["epochs"].append({"epoch": epoch, "fork": str(cached.fork),
                              "seconds": time.perf_counter() - t0})
    state = cached.state
    header = state.latest_execution_payload_header
    rec.update(slot=int(state.slot), fork=str(cached.fork),
               default_header=header.hash_tree_root() == type(header)().hash_tree_root(),
               cursors=[int(state.next_withdrawal_index),
                        int(state.next_withdrawal_validator_index)],
               ok=cached.fork == ForkName.capella)
    log(f"[capella] (a) scheduled upgrades to slot {rec['slot']}: "
        + ", ".join(f"epoch {e['epoch']} ({e['fork']}) {e['seconds']:.3f} s"
                    for e in rec["epochs"])
        + f"; fork {rec['fork']}, default header {rec['default_header']}, cursors "
        f"{rec['cursors']}")
    return rec


def run(verifier, *, validators: int = 16384, preset=None, scenario=None, observer=None,
        probe=None, sync=None, log=print) -> dict:
    """Steps (a)–(f) of the module's docstring through `verifier`, on
    `scenario`'s genesis (`profile_block.make_scenario`'s; an interop
    genesis of `validators` is made here when not given). Returns the
    records by step ("steps"), each with its seconds, what it moved in
    `observer`'s and `probe()`'s counts, the kernels' launches and the
    set counts of the verifier's batch and per-set calls; and every
    failed check ("failures", empty when all pass). `sync` (e.g. a
    device synchronise) runs around each step."""
    from .chain.chain import BeaconChain, BlockImportError
    from .chain.clock import ManualClock
    from .chain.validation import validate_gossip_block
    from .config.beacon_config import compute_signing_root
    from .execution.engine import ExecutionEngineMock
    from .observability import spans
    from .params import DOMAIN_BEACON_PROPOSER, DOMAIN_RANDAO, ETH1_ADDRESS_WITHDRAWAL_PREFIX
    from .state_transition.block import _epoch_signing_root
    from .state_transition.capella import (
        bls_to_execution_change_signing_root,
        get_expected_withdrawals,
    )
    from .state_transition.signature_sets import get_block_signature_sets
    from .types import get_types

    if scenario is None:
        from .params import MAINNET

        preset = preset or MAINNET
        t0 = time.perf_counter()
        config, genesis, _ = profile_block.interop_chain(
            profile_block.block_import_config(), preset, validators)
        setup = {"genesis_s": time.perf_counter() - t0}
    else:
        config, genesis, preset = scenario["config"], scenario["genesis"], scenario["preset"]
        setup = {}
    n = len(genesis.flat)
    spe = preset.SLOTS_PER_EPOCH
    t = get_types(preset).capella
    failures: list[str] = []
    steps: dict = {}
    out = {"validators": n, "preset": preset.PRESET_BASE, "steps": steps,
           "failures": failures, "setup": setup}

    def expect(cond, what):
        if not cond:
            failures.append(what)

    steps["upgrades"] = scheduled_upgrades(config, genesis, preset, log)
    a = steps["upgrades"]
    expect(a["ok"] and a["default_header"] and a["cursors"] == [0, 0],
           f"upgrades: fork {a['fork']}, default header {a['default_header']}, cursors "
           f"{a['cursors']}")

    t0 = time.perf_counter()
    config, state = capella_genesis(config, genesis, preset)
    setup["capella_state_s"] = time.perf_counter() - t0
    recorder = profile_chain.RecordingVerifier(verifier)
    factory = profile_block.BlockFactory(config, n)
    engine = ExecutionEngineMock(genesis_block_hash=EL_GENESIS_HASH)
    t0 = time.perf_counter()
    chain = BeaconChain(config, t, state, verifier=recorder, execution_engine=engine,
                        clock=ManualClock(state.genesis_time, config.SECONDS_PER_SLOT, spe))
    setup["chain_init_s"] = time.perf_counter() - t0
    step = lambda: profile_chain._Step(observer, probe, sync)  # noqa: E731
    per_block = preset.MAX_BLS_TO_EXECUTION_CHANGES

    def changes(indices):
        """Signed changes of `indices` to the address 0x<index byte>..:
        the withdrawal key is the signing key in the interop genesis."""
        msgs = [t.BLSToExecutionChange(
            validator_index=v, from_bls_pubkey=bytes(chain.head_state.flat.pubkeys[v]),
            to_execution_address=bytes([v % 256]) * 20) for v in indices]
        roots = [bls_to_execution_change_signing_root(config, chain.head_state.state, m)
                 for m in msgs]
        sigs = factory.sign(list(zip(indices, roots)))
        return [t.SignedBLSToExecutionChange(message=m, signature=s)
                for m, s in zip(msgs, sigs)]

    def produce(slot):
        """(unsigned block, signed block) produced by the chain at `slot`."""
        chain.clock.set_slot(slot)
        # every slot of the run lies in the head state's epoch
        proposer = chain.head_state.epoch_ctx.get_beacon_proposer(slot)
        (reveal,) = factory.sign([(proposer, _epoch_signing_root(
            slot // spe, config.get_domain(DOMAIN_RANDAO, slot)))])
        block = chain.produce_block(slot, reveal)
        return block, sign(block)

    def sign(block):
        (sig,) = factory.sign([(block.proposer_index, compute_signing_root(
            block.hash_tree_root(), config.get_domain(DOMAIN_BEACON_PROPOSER, block.slot)))])
        return t.SignedBeaconBlock(message=block, signature=sig)

    def calls_record(rec):
        calls = recorder.take()
        batch = [c for c in calls if c["kind"] == "batch"]
        rec.update(sets=max((len(c["sets"]) for c in batch), default=0),
                   verdicts=[c["verdicts"] for c in calls],
                   batch_call_sets=[len(c["sets"]) for c in batch],
                   individual_call_sets=[len(c["sets"]) for c in calls
                                         if c["kind"] == "individual"],
                   host_mismatches=profile_chain.host_mismatches(calls))
        return calls

    def import_step(name, signed, gossip=True):
        with step() as rec:
            if gossip:
                t1 = time.perf_counter()
                res = validate_gossip_block(chain, t, signed)
                rec["gossip_s"] = time.perf_counter() - t1
                rec["gossip"] = [res.action.value, res.reason]
            t1 = time.perf_counter()
            try:
                chain.process_block(signed)
                rec["refused"] = None
            except BlockImportError as e:
                rec["refused"] = str(e)
            rec["process_block_s"] = time.perf_counter() - t1
        rec.update(profile_chain._trace_breakdown(spans.tracer, "chain/process_block"))
        calls_record(rec)
        steps[name] = rec
        if gossip:
            expect(rec["gossip"] == ["ACCEPT", ""], f"{name}: gossip {rec['gossip']}")
        return rec

    try:
        # (b) slot 1: changes and a full sync aggregate
        t0 = time.perf_counter()
        # the changes go to the validators the slot-2 sweep visits first:
        # slot 1's payload withdraws nothing (every credential is BLS
        # then), which moves the cursor on by min(n, the sweep bound)
        first = (int(chain.head_state.state.next_withdrawal_validator_index)
                 + min(n, preset.MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP)) % n
        order = [(first + i) % n for i in range(min(3 * per_block, n))]
        pool_changes = changes(order[:2 * per_block])
        for c in pool_changes:
            chain.bls_changes_pool.add(c)
        contribution_s = _contributions(chain, factory, config, t, 0, chain.head_root)
        sign_s = time.perf_counter() - t0
        genesis_root = chain.head_root
        t0 = time.perf_counter()
        block1, signed1 = produce(1)
        produce_s = time.perf_counter() - t0
        rec = import_step("slot1", signed1)
        rec.update(sign_s=sign_s, contribution_s=contribution_s, produce_s=produce_s,
                   changes=len(block1.body.bls_to_execution_changes),
                   sync_bits=sum(block1.body.sync_aggregate.sync_committee_bits))
        changed = [int(c.message.validator_index) for c in block1.body.bls_to_execution_changes]
        creds = chain.head_state.flat.withdrawal_credentials
        expect(rec["refused"] is None and chain.head_root == block1.hash_tree_root()
               and chain.head_root != genesis_root, f"slot1: refused {rec['refused']}")
        expect(rec["changes"] == min(per_block, n)
               and rec["sync_bits"] == preset.SYNC_COMMITTEE_SIZE,
               f"slot1: {rec['changes']} changes, {rec['sync_bits']} sync bits")
        expect(rec["sets"] == 3 + rec["changes"], f"slot1: {rec['sets']} sets")
        expect(all(creds[v, 0] == ETH1_ADDRESS_WITHDRAWAL_PREFIX[0] for v in changed),
               "slot1: the changed validators do not hold 0x01 credentials")
        expect(engine.head == bytes(block1.body.execution_payload.block_hash),
               "slot1: the engine's head is not the payload's hash")

        # (c) slot 2: the committees' aggregates, the other changes, withdrawals
        pre2 = profile_block.BlockFactory.advance(chain.head_state, 2)
        t0 = time.perf_counter()
        _contributions(chain, factory, config, t, 1, chain.head_root)
        atts = factory.attestations(pre2, [1])
        for att in atts:
            chain.on_aggregated_attestation(att, att.data.hash_tree_root())
        att_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        expected = get_expected_withdrawals(pre2, t)
        sweep_s = time.perf_counter() - t0
        before = [int(b) for b in pre2.flat.balances]
        t0 = time.perf_counter()
        block2, signed2 = produce(2)
        produce_s = time.perf_counter() - t0
        rec = import_step("slot2", signed2)
        got = [(int(w.index), int(w.validator_index), bytes(w.address), int(w.amount))
               for w in block2.body.execution_payload.withdrawals]
        want = [(int(w.index), int(w.validator_index), bytes(w.address), int(w.amount))
                for w in expected]
        head = chain.head_state
        rec.update(attestations_s=att_s, sweep_s=sweep_s, sweep_validators=min(
            n, preset.MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP), produce_s=produce_s,
                   attestations=len(block2.body.attestations),
                   changes=len(block2.body.bls_to_execution_changes),
                   withdrawals=[list(w[1:2]) + [w[3]] for w in got],
                   next_withdrawal_index=int(head.state.next_withdrawal_index))
        expect(rec["refused"] is None and chain.head_root == block2.hash_tree_root(),
               f"slot2: refused {rec['refused']}")
        expect(rec["attestations"] == len(atts) and rec["sets"] == 3 + len(atts)
               + rec["changes"], f"slot2: {rec['attestations']} attestations of {len(atts)}, "
               f"{rec['sets']} sets")
        expect(got == want, f"slot2: withdrawals {got[:2]}.. against the sweep's {want[:2]}..")
        expect(all(amount == before[v] - preset.MAX_EFFECTIVE_BALANCE for _, v, _, amount in got),
               "slot2: a withdrawal is not its validator's excess")
        # the sweep starts at the changed validators: each with an excess
        # withdraws, up to the payload's bound
        eligible = [v for v in changed if v < EXCESS_VALIDATORS]
        expect(len(got) == min(len(eligible), preset.MAX_WITHDRAWALS_PER_PAYLOAD) > 0,
               f"slot2: {len(got)} withdrawals for {len(eligible)} eligible validators")
        expect(rec["next_withdrawal_index"] == len(got),
               f"slot2: next_withdrawal_index {rec['next_withdrawal_index']}")
        # the debit: a withdrawn validator that neither proposed nor sat in
        # the sync committee holds MAX_EFFECTIVE_BALANCE exactly
        members = {head.epoch_ctx.pubkey_to_index[bytes(pk)]
                   for pk in head.state.current_sync_committee.pubkeys}
        quiet = [v for _, v, _, _ in got if v not in members and v != block2.proposer_index]
        expect(all(int(head.flat.balances[v]) == preset.MAX_EFFECTIVE_BALANCE for v in quiet),
               "slot2: a withdrawn balance was not debited to MAX_EFFECTIVE_BALANCE")
        rec["debited_checked"] = len(quiet)

        # (d) slot 3: a change carrying another change's signature
        _contributions(chain, factory, config, t, 2, chain.head_root)
        more = changes(order[2 * per_block:])
        for c in more:
            chain.bls_changes_pool.add(c)
        head_root, known = chain.head_root, set(chain.blocks)
        block3, _ = produce(3)
        k = len(block3.body.bls_to_execution_changes)
        expect(k >= 2, f"tampered: the slot-3 block carries {k} changes")
        pre3 = profile_block.BlockFactory.advance(chain.head_state, 3)
        bad = block3.copy()
        bad_changes = bad.body.bls_to_execution_changes
        bad_changes[0].signature = bytes(bad_changes[1].signature)
        tampered = factory.seal(pre3, bad)[0]
        sets = get_block_signature_sets(pre3, t, tampered)
        with step() as rec:
            try:
                chain.process_block(tampered)
                rec["refused"] = None
            except BlockImportError as e:
                rec["refused"] = str(e)
            t1 = time.perf_counter()
            individual = [bool(v) for v in recorder.verify_signature_sets_individual(sets)]
            rec["individual_s"] = time.perf_counter() - t1
        calls_record(rec)
        host = profile_block.host_verdicts(sets)
        rec.update(blamed=[i for i, ok in enumerate(individual) if not ok],
                   host_blamed=[i for i, ok in enumerate(host) if not ok],
                   tampered_set=len(sets) - k)
        steps["tampered"] = rec
        expect(rec["refused"] is not None, "tampered: the block was imported")
        expect(rec["verdicts"][:1] == [[False]], f"tampered: verdicts {rec['verdicts']}")
        expect(rec["blamed"] == rec["host_blamed"] == [rec["tampered_set"]],
               f"tampered: blamed {rec['blamed']}, host tier {rec['host_blamed']}, the "
               f"tampered set {rec['tampered_set']}")
        expect(chain.head_root == head_root and set(chain.blocks) == known,
               "tampered: the head or the blocks changed")

        # (e) slot 3: a payload the engine calls INVALID
        block3e, signed3e = produce(3)
        engine.invalid_hashes.add(bytes(block3e.body.execution_payload.block_hash))
        try:
            rec = import_step("invalid_payload", signed3e, gossip=False)
        finally:
            engine.invalid_hashes.clear()
        expect(rec["refused"] is not None and "payload" in rec["refused"],
               f"invalid_payload: refused {rec['refused']}")
        expect(rec["verdicts"] == [[True]], f"invalid_payload: verdicts {rec['verdicts']}")
        expect(chain.head_root == head_root
               and block3e.hash_tree_root() not in chain.blocks
               and not chain.fork_choice.has_block(block3e.hash_tree_root()),
               "invalid_payload: fork choice took the block")

        # (f) prepare_next_slot, then the prepared block as head
        t0 = time.perf_counter()
        chain.prepare_next_slot.on_slot(2)
        prepare_s = time.perf_counter() - t0
        sessions = len(engine._building)
        prepared = chain.prepare_next_slot.get_prepared(3, chain.head_root)
        t0 = time.perf_counter()
        block3f, signed3f = produce(3)
        produce_s = time.perf_counter() - t0
        rec = import_step("prepare", signed3f)
        rec.update(prepare_s=prepare_s, sessions=sessions, produce_s=produce_s)
        expect(sessions >= 1 and prepared is not None and int(prepared.state.slot) == 3,
               f"prepare: {sessions} building sessions, prepared {prepared is not None}")
        expect(rec["refused"] is None and chain.head_root == block3f.hash_tree_root(),
               f"prepare: refused {rec['refused']}")
        expect(engine.head == bytes(block3f.body.execution_payload.block_hash),
               "prepare: the engine's head did not follow the block")
        for name, r in steps.items():
            expect(not r.get("host_mismatches"),
                   f"{name}: verdicts differ from the host tier's: {r.get('host_mismatches')}")
        out["head"] = chain.head_root.hex()
    finally:
        chain.close()
        factory.close()
    return out


def _contributions(chain, factory, config, t, slot, block_root) -> float:
    """Every sync subcommittee's full contribution on `block_root` at
    `slot` into the chain's pool (a subcommittee's signature by its
    members' summed keys); returns the seconds."""
    from .config.beacon_config import compute_signing_root
    from .params import DOMAIN_SYNC_COMMITTEE, SYNC_COMMITTEE_SUBNET_COUNT

    t0 = time.perf_counter()
    cached = chain.head_state
    root = compute_signing_root(block_root, config.get_domain(
        DOMAIN_SYNC_COMMITTEE, slot, slot // config.preset.SLOTS_PER_EPOCH))
    index = cached.epoch_ctx.pubkey_to_index
    pubkeys = list(cached.state.current_sync_committee.pubkeys)
    size = len(pubkeys) // SYNC_COMMITTEE_SUBNET_COUNT
    groups = [[index[bytes(pk)] for pk in pubkeys[s * size:(s + 1) * size]]
              for s in range(SYNC_COMMITTEE_SUBNET_COUNT)]
    sigs = factory.sign_aggregate([(g, root) for g in groups])
    for sub, sig in enumerate(sigs):
        chain.sync_contribution_pool.add(t.SyncCommitteeContribution(
            slot=slot, beacon_block_root=block_root, subcommittee_index=sub,
            aggregation_bits=[True] * size, signature=sig))
    return time.perf_counter() - t0


def log_steps(out: dict, log=print) -> None:
    """One line per step of `run`'s record (step (a) logs its own)."""
    def common(r):
        return (f"paths {json.dumps(r.get('paths', {}))}, supervisor "
                f"{json.dumps(r.get('supervisor', {}))}, launches {json.dumps(r['launches'])}")

    def spans(r):
        keys = ("pre_state_s", "bls_verify_s", "state_transition_s", "execution_payload_s",
                "fork_choice_s", "import_s", "head_update_s")
        return ", ".join(f"{k[:-2]} {r[k]:.3f} s" for k in keys if k in r)

    for name, r in out["steps"].items():
        if name == "upgrades":
            continue
        if name == "tampered":
            log(f"[capella] tampered: {r['seconds']:.3f} s, {r['sets']} sets, verdicts "
                f"{r['verdicts'][:1]}, blamed {r['blamed']} (host tier {r['host_blamed']}, the "
                f"tampered set {r['tampered_set']}) in {r['individual_s']:.3f} s, refused: "
                f"{r['refused']}; {common(r)}")
            continue
        extra = ""
        if name == "slot2":
            extra = (f", sweep of {r['sweep_validators']} validators {r['sweep_s']:.4f} s, "
                     f"{len(r['withdrawals'])} withdrawals, next_withdrawal_index "
                     f"{r['next_withdrawal_index']}")
        log(f"[capella] {name}: {r['seconds']:.3f} s ("
            + (f"produce {r['produce_s']:.3f} s, " if "produce_s" in r else "")
            + (f"gossip {r['gossip']} {r['gossip_s']:.3f} s, " if "gossip" in r else "")
            + f"process_block {r['process_block_s']:.3f} s: {spans(r)}), {r['sets']} sets, "
            f"verdicts "
            f"{r['verdicts']}, refused {r['refused']}{extra}; {common(r)}")

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--validators", type=int, default=16384)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--preset", choices=("mainnet", "minimal"), default="mainnet")
    ap.add_argument("--verifier", choices=("stack", "host"), default="stack",
                    help="the serving stack on --device, or the C host tier alone")
    ap.add_argument("--out", default="build/lodestar_tpu_torch/profile_capella.json")
    args = ap.parse_args(argv)

    import torch

    from .chain.bls_verifier import CpuBlsVerifier
    from .native import install_ssz_backend
    from .node.bls_stack import build_bls_stack
    from .params import MAINNET, MINIMAL

    install_ssz_backend()
    preset = MINIMAL if args.preset == "minimal" else MAINNET
    if args.verifier == "host":
        out = run(CpuBlsVerifier(), validators=args.validators, preset=preset)
    else:
        stack = build_bls_stack(device=args.device)
        cuda = str(stack.device.device).startswith("cuda")
        try:
            out = run(stack.verifier, validators=args.validators, preset=preset,
                      observer=stack.pipeline, sync=torch.cuda.synchronize if cuda else None)
        finally:
            stack.close()
    log_steps(out)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(json.dumps(out, default=str), flush=True)
    return 0 if not out["failures"] else 1


if __name__ == "__main__":
    raise SystemExit(main())

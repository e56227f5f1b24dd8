"""Block import on the GPU: the port's replay of the JAX package's
`BeaconChain._process_block_spanned` (`chain/chain.py`), with no chain.

    python3 -m lodestar_tpu_torch.profile_block [--validators 16384] [--blocks 3] [--device cuda]

On the mainnet preset, with `MAINNET_CHAIN_CONFIG` moved to Altair at
epoch 1 (Bellatrix and Capella never), it makes an interop genesis of
`--validators` validators and, with `BlockFactory` (interop keys, the C
host tier across threads), full-participation blocks over it:

1. phase0 blocks at slots 1..`--blocks`, each carrying the previous
   slot's aggregates (one per committee);
2. the first block of epoch 1 (Altair, after the empty slots, the phase0
   epoch processing and the Altair upgrade), carrying one aggregate for
   each committee of slots 1..32 and a full sync aggregate;
3. a copy of that block with the signatures of two aggregates swapped,
   re-rooted and signed again by its proposer.

It imports them through the port's serving stack (`build_bls_stack`,
cold) as block import does (`import_block`): the pre-state copied and
advanced to the block's slot, the block's signature sets built from it
and verified on a worker thread with `batchable=False` while the state
transition runs, the import failing unless the verdict is True and the
post-state root is the block's. Before the Altair block it populates the
stack's epoch table with the state's keys, as a node does at an epoch
transition. The tampered block must fail; its per-set verdicts must
blame exactly the two swapped aggregates.

Prints one line per block (sets, the seconds of pre-state, sets, state
transition and verdict, the import wall, the planner path, the
supervisor's host-tier fallbacks, the kernels' launches; for the
tampered block those of its per-set verdicts too), the setup's seconds
and one JSON line (also
written to `--out`, default build/lodestar_tpu_torch/profile_block.json).
Needs a GPU unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

GENESIS_TIME = 1_600_000_000


class BlockImportError(Exception):
    pass


def block_import_config(altair_epoch: int = 1):
    """`MAINNET_CHAIN_CONFIG` with Altair at `altair_epoch`, Bellatrix and
    Capella at FAR_FUTURE_EPOCH."""
    from .config.chain_config import MAINNET_CHAIN_CONFIG
    from .params import FAR_FUTURE_EPOCH

    return MAINNET_CHAIN_CONFIG.with_overrides(
        ALTAIR_FORK_EPOCH=altair_epoch,
        BELLATRIX_FORK_EPOCH=FAR_FUTURE_EPOCH,
        CAPELLA_FORK_EPOCH=FAR_FUTURE_EPOCH,
    )


def interop_chain(chain_config, preset, n_validators: int):
    """(config, genesis CachedBeaconState, seconds by step) of an interop
    genesis of `n_validators`."""
    from .config.beacon_config import BeaconConfig, ChainForkConfig
    from .state_transition import CachedBeaconState
    from .state_transition.genesis import (
        initialize_beacon_state_from_eth1,
        make_interop_deposits,
    )
    from .types import get_types

    phase0 = get_types(preset).phase0
    fork_config = ChainForkConfig(chain_config, preset)
    t0 = time.perf_counter()
    deposits = make_interop_deposits(fork_config, phase0, n_validators)
    t1 = time.perf_counter()
    state = initialize_beacon_state_from_eth1(
        fork_config, phase0, b"\x42" * 32,
        max(0, GENESIS_TIME - fork_config.GENESIS_DELAY), deposits)
    state.genesis_time = GENESIS_TIME
    t2 = time.perf_counter()
    config = BeaconConfig(chain_config, bytes(state.genesis_validators_root), preset)
    cached = CachedBeaconState(config, state, preset)
    t3 = time.perf_counter()
    return config, cached, {"deposits_s": t1 - t0, "genesis_s": t2 - t1, "cache_s": t3 - t2}


class BlockFactory:
    """Full-participation blocks on interop keys, signed by the C host tier
    across `threads` threads. A committee's aggregate signature (the sync
    committee's too) is the signature of its members' secret keys summed
    mod r: Σ skᵢ·H(m) = (Σ skᵢ mod r)·H(m), the same compressed bytes as
    the G2 sum of their signatures, for one signing instead of one per
    member."""

    def __init__(self, config, n_validators: int, threads: int | None = None):
        from .bls.api import interop_secret_key

        self.config = config
        self.preset = config.preset
        self.keys = [interop_secret_key(i).value for i in range(n_validators)]
        self.pool = ThreadPoolExecutor(threads or os.cpu_count() or 1)
        self._aggregates: dict[bytes, bytes] = {}  # attestation data root → signature

    def close(self) -> None:
        self.pool.shutdown()

    def sign(self, pairs) -> list[bytes]:
        """[(validator index or 32-byte secret key, signing root)] → signatures."""
        from . import native
        from .bls.api import DST_G2

        def one(pair):
            sk = pair[0] if isinstance(pair[0], bytes) else self.keys[pair[0]].to_bytes(32, "big")
            rc, sig = native.sign(sk, pair[1], DST_G2)
            if rc:
                raise RuntimeError(f"host tier failed to sign ({rc})")
            return sig

        return list(self.pool.map(one, pairs, chunksize=64))

    def sign_aggregate(self, groups) -> list[bytes]:
        """[(validator indices, signing root)] → the aggregate signature of
        each group's members on its root (an index may repeat)."""
        from .bls.api import CURVE_ORDER, SecretKey

        return self.sign([
            (SecretKey(sum(self.keys[i] for i in indices) % CURVE_ORDER).to_bytes(), root)
            for indices, root in groups])

    @staticmethod
    def advance(parent, slot: int):
        """A copy of `parent` processed to `slot`."""
        from .state_transition.stf import fork_types, process_slots

        pre = parent.copy()
        if slot > pre.state.slot:
            process_slots(pre, fork_types(pre), slot)
        return pre

    def attestations(self, pre, slots) -> list:
        """One full aggregate per committee of each of `slots` (all below
        pre's slot), as `pre` would include them: the head and target roots
        from its block roots, the source its justified checkpoint for the
        target's epoch."""
        from .config.beacon_config import compute_signing_root
        from .params import DOMAIN_BEACON_ATTESTER
        from .state_transition.stf import fork_types

        types, state, p = fork_types(pre), pre.state, self.preset
        spe, hist = p.SLOTS_PER_EPOCH, p.SLOTS_PER_HISTORICAL_ROOT
        made, todo = [], {}
        for slot in slots:
            epoch = slot // spe
            source = (state.current_justified_checkpoint if epoch == pre.current_epoch
                      else state.previous_justified_checkpoint)
            domain = self.config.get_domain(DOMAIN_BEACON_ATTESTER, epoch * spe, epoch)
            for index in range(pre.epoch_ctx.get_committee_count_per_slot(epoch)):
                committee = pre.epoch_ctx.get_beacon_committee(slot, index)
                data = types.AttestationData(
                    slot=slot,
                    index=index,
                    beacon_block_root=bytes(state.block_roots[slot % hist]),
                    source=source.copy(),
                    target=types.Checkpoint(
                        epoch=epoch, root=bytes(state.block_roots[(epoch * spe) % hist])),
                )
                key = data.hash_tree_root()
                made.append((data, len(committee), key))
                if key not in self._aggregates and key not in todo:
                    todo[key] = ([int(v) for v in committee], compute_signing_root(key, domain))
        for key, agg in zip(todo, self.sign_aggregate(todo.values())):
            self._aggregates[key] = agg
        return [types.Attestation(aggregation_bits=[True] * n, data=data,
                                  signature=self._aggregates[key]) for data, n, key in made]

    def sync_aggregate(self, pre, slot: int):
        """Every sync-committee member signs the previous slot's block root."""
        from .config.beacon_config import compute_signing_root
        from .params import DOMAIN_SYNC_COMMITTEE
        from .state_transition.stf import fork_types

        p = self.preset
        prev = max(slot, 1) - 1
        domain = self.config.get_domain(DOMAIN_SYNC_COMMITTEE, prev, prev // p.SLOTS_PER_EPOCH)
        root = compute_signing_root(
            bytes(pre.state.block_roots[prev % p.SLOTS_PER_HISTORICAL_ROOT]), domain)
        index = pre.epoch_ctx.pubkey_to_index
        members = [index[bytes(pk)] for pk in pre.state.current_sync_committee.pubkeys]
        (sig,) = self.sign_aggregate([(members, root)])
        return fork_types(pre).SyncAggregate(
            sync_committee_bits=[True] * len(members), sync_committee_signature=sig)

    def block(self, pre, attestations, sync: bool = False):
        """(signed block at pre's slot, its post-state): the randao reveal
        and the proposer's signature by the slot's proposer, the state
        root from a trial transition."""
        from .params import DOMAIN_RANDAO
        from .state_transition.block import _epoch_signing_root
        from .state_transition.stf import fork_types

        types, slot = fork_types(pre), pre.state.slot
        proposer = pre.epoch_ctx.get_beacon_proposer(slot)
        epoch = slot // self.preset.SLOTS_PER_EPOCH
        (reveal,) = self.sign([(proposer, _epoch_signing_root(
            epoch, self.config.get_domain(DOMAIN_RANDAO, slot)))])
        body = types.BeaconBlockBody(
            randao_reveal=reveal, eth1_data=pre.state.eth1_data.copy(), attestations=attestations)
        if sync:
            body.sync_aggregate = self.sync_aggregate(pre, slot)
        block = types.BeaconBlock(
            slot=slot, proposer_index=proposer,
            parent_root=pre.state.latest_block_header.hash_tree_root(),
            state_root=b"\x00" * 32, body=body)
        return self.seal(pre, block)

    def seal(self, pre, block):
        """Set the block's state root from a trial transition of `pre` and
        sign it: (signed block, post-state)."""
        from .config.beacon_config import compute_signing_root
        from .params import DOMAIN_BEACON_PROPOSER
        from .state_transition import state_transition
        from .state_transition.stf import fork_types

        types = fork_types(pre)
        post = pre.copy()
        state_transition(post, types, types.SignedBeaconBlock(message=block.copy(),
                                                              signature=b"\x00" * 96),
                         verify_state_root=False, verify_signatures=False)
        block.state_root = post.hash_tree_root()
        domain = self.config.get_domain(DOMAIN_BEACON_PROPOSER, block.slot)
        (sig,) = self.sign([(block.proposer_index,
                             compute_signing_root(block.hash_tree_root(), domain))])
        return types.SignedBeaconBlock(message=block, signature=sig), post

    def swapped(self, pre, signed, i: int, j: int):
        """A copy of `signed` with the signatures of attestations i and j
        swapped, re-rooted and signed again by its proposer."""
        block = signed.message.copy()
        atts = block.body.attestations
        atts[i].signature, atts[j].signature = bytes(atts[j].signature), bytes(atts[i].signature)
        return self.seal(pre, block)[0]


def _verify_now(verifier, sets) -> bool:
    """verify_signature_sets with batchable=False where the verifier takes
    it (the JAX `chain._verify_now`): block import does not wait out a
    gossip batching window."""
    params = inspect.signature(verifier.verify_signature_sets).parameters
    if "batchable" in params or any(p.kind is p.VAR_KEYWORD for p in params.values()):
        return verifier.verify_signature_sets(sets, batchable=False)
    return verifier.verify_signature_sets(sets)


SUPERVISOR_COUNTS = ("retries", "deadline_exceeded", "verdict_mismatches", "both_tiers_failed")


def _snapshot(observer, probe=None) -> dict:
    """Counters read around a verdict, by group: the observer's planner
    decisions by path ("paths"), its epoch-table hits and misses
    ("epoch_table"), its supervisor's host-tier fallbacks by reason and
    retries, deadlines, overturned verdicts and double failures
    ("supervisor"; each empty for an observer without them) and
    `probe()`'s counts ("probe")."""
    out = {"paths": {}, "epoch_table": {}, "supervisor": {},
           "probe": dict(probe()) if probe is not None else {}}
    if hasattr(observer, "planner_snapshot"):
        out["paths"] = dict(observer.planner_snapshot()["decisions"])
        out["epoch_table"] = {"hit": int(observer.epoch_table_hits.value()),
                              "miss": int(observer.epoch_table_misses.value())}
    if hasattr(observer, "supervisor_snapshot"):
        snap = observer.supervisor_snapshot()
        out["supervisor"] = {**{f"fallback_{k}": v for k, v in snap["fallbacks"].items()},
                             **{k: snap[k] for k in SUPERVISOR_COUNTS}}
    return out


def _moved(before: dict, after: dict) -> dict:
    """What each counter of `_snapshot` moved by: epoch-table and probe
    counts all, paths and supervisor counts only where they moved."""
    moved = {g: {k: v - before[g].get(k, 0) for k, v in counts.items()}
             for g, counts in after.items()}
    for g in ("paths", "supervisor"):
        moved[g] = {k: v for k, v in moved[g].items() if v}
    return moved


def import_block(parent, signed, verifier, pool, observer=None, sync=None, probe=None):
    """Import `signed` onto `parent` as `_process_block_spanned` does:
    (post-state, record). The record holds the sets, their verdict, the
    seconds of each step and the import wall, what the verdict moved in
    `observer`'s and `probe()`'s counts (`_snapshot`: its planner paths,
    epoch-table hits and misses, the supervisor's host-tier fallbacks)
    and the kernels' launches (counted from zero). `sync` (called before and
    after the verdict, e.g. a device synchronise) makes the verdict's
    clock the device's. Raises `BlockImportError` unless the verdict is
    True; a state transition that fails raises its own error."""
    from .parallel.mesh_pool import launch_counts
    from .state_transition import state_transition
    from .state_transition.signature_sets import get_block_signature_sets
    from .state_transition.stf import fork_types, process_slots

    block = signed.message
    t0 = time.perf_counter()
    pre = parent.copy()
    if block.slot > pre.state.slot:
        process_slots(pre, fork_types(pre), block.slot)
    t1 = time.perf_counter()
    sets = get_block_signature_sets(pre, fork_types(pre), signed)
    t2 = time.perf_counter()
    before = _snapshot(observer, probe)
    launch_counts(reset=True)

    def verdict():
        if sync is not None:
            sync()
        ts = time.perf_counter()
        ok = bool(_verify_now(verifier, sets))
        if sync is not None:
            sync()
        return ok, time.perf_counter() - ts

    fut = pool.submit(verdict)
    try:
        state_transition(pre, fork_types(pre), signed, verify_state_root=True,
                         verify_signatures=False)
    except BaseException:
        fut.result()
        raise
    t3 = time.perf_counter()
    ok, verdict_s = fut.result()
    t4 = time.perf_counter()
    moved = _moved(before, _snapshot(observer, probe))
    record = {
        "slot": int(block.slot),
        "sets": len(sets),
        "verdict": ok,
        "pre_state_s": t1 - t0,
        "sets_s": t2 - t1,
        "stf_s": t3 - t2,
        "verdict_s": verdict_s,
        "import_s": t4 - t0,
        **moved,
        "launches": launch_counts(),
        "signature_sets": sets,
    }
    if not ok:
        raise BlockImportError(f"block {block.slot}: signature sets failed", record)
    return pre, record


def make_blocks(factory, genesis, phase0_blocks: int, swap=(5, 77)):
    """The scenario's blocks: (phase0 blocks, the Altair block, its
    tampered copy, the two swapped attestation indices, seconds). Each
    phase0 block at slot s carries slot s−1's aggregates; the Altair block
    at the first slot of epoch 1 carries one per committee of slots
    1..32 (the whole previous epoch and its last slot) and a full sync
    aggregate."""
    t0 = time.perf_counter()
    spe = factory.preset.SLOTS_PER_EPOCH
    altair_slot = factory.config.ALTAIR_FORK_EPOCH * spe + 1
    if not 0 < phase0_blocks < spe:
        raise ValueError(f"--blocks must be in 1..{spe - 1}")
    state, blocks = genesis, []
    for slot in range(1, phase0_blocks + 1):
        pre = factory.advance(state, slot)
        signed, state = factory.block(pre, factory.attestations(pre, [slot - 1]))
        blocks.append(signed)
    pre = factory.advance(state, altair_slot)
    atts = factory.attestations(pre, range(altair_slot - spe, altair_slot))
    altair, _ = factory.block(pre, atts, sync=True)
    i, j = swap
    if not 0 <= i < j < len(atts):
        raise ValueError(f"swap {swap}: the Altair block carries {len(atts)} attestations")
    tampered = factory.swapped(pre, altair, i, j)
    return blocks, altair, tampered, (i, j), time.perf_counter() - t0


def light_client_chain(n_validators: int = 16, slots: int = 24,
                       genesis_time: int = GENESIS_TIME, threads: int | None = None):
    """(config, Altair genesis state, signed blocks) of the light client's
    chain, as the JAX package's light-client tests build it: the minimal
    preset and `MINIMAL_CHAIN_CONFIG` (its Altair epoch far in the
    future), an interop genesis of `n_validators` upgraded to Altair at
    slot 0, and a block at each slot 1..`slots` carrying the previous
    slot's aggregates and a full sync aggregate (`BlockFactory`)."""
    from .config.beacon_config import BeaconConfig, ChainForkConfig
    from .config.chain_config import MINIMAL_CHAIN_CONFIG
    from .params import MINIMAL
    from .state_transition import CachedBeaconState, interop_genesis_state
    from .state_transition.altair import upgrade_state_to_altair
    from .types import get_types

    t = get_types(MINIMAL)
    pre = interop_genesis_state(ChainForkConfig(MINIMAL_CHAIN_CONFIG, MINIMAL), t.phase0,
                                n_validators, genesis_time=genesis_time)
    config = BeaconConfig(MINIMAL_CHAIN_CONFIG, bytes(pre.genesis_validators_root), MINIMAL)
    genesis = upgrade_state_to_altair(config, MINIMAL, pre, t.altair)
    factory = BlockFactory(config, n_validators, threads)
    try:
        state, blocks = CachedBeaconState(config, genesis.copy(), MINIMAL), []
        for slot in range(1, slots + 1):
            pre_state = factory.advance(state, slot)
            atts = factory.attestations(pre_state, [slot - 1]) if slot > 1 else []
            signed, state = factory.block(pre_state, atts, sync=True)
            blocks.append(signed)
    finally:
        factory.close()
    return config, genesis, blocks


def host_verdicts(sets, threads: int | None = None) -> list[bool]:
    """The C host tier's per-set verdicts."""
    from . import native
    from .bls.api import DST_G2

    return native.verify_sets(
        b"".join(s.pubkey.to_bytes() for s in sets), [bytes(s.message) for s in sets],
        b"".join(bytes(s.signature) for s in sets), DST_G2,
        threads=threads or os.cpu_count() or 1)


def make_scenario(*, validators: int, blocks: int, preset=None, swap=(5, 77),
                  log=print) -> dict:
    """The scenario's genesis and blocks, made once: a dict of the config,
    the genesis `CachedBeaconState`, the phase0 blocks, the Altair block,
    its tampered copy, the swapped indices and the seconds of each step
    ("setup"). `run` and `profile_chain.run` take it, so that a script
    running both makes one genesis."""
    from .params import MAINNET

    preset = preset or MAINNET
    t0 = time.perf_counter()
    config, genesis, genesis_s = interop_chain(block_import_config(), preset, validators)
    t1 = time.perf_counter()
    factory = BlockFactory(config, validators)
    try:
        t2 = time.perf_counter()
        phase0, altair, tampered, swap, make_s = make_blocks(factory, genesis, blocks, swap)
    finally:
        factory.close()
    setup = {**genesis_s, "genesis_total_s": t1 - t0, "keys_s": t2 - t1,
             "blocks_s": make_s, "total_s": time.perf_counter() - t0}
    log(f"[block] setup {validators} validators ({preset.PRESET_BASE}): "
        + ", ".join(f"{k} {v:.3f}" for k, v in setup.items()))
    return {"validators": validators, "preset": preset, "config": config, "genesis": genesis,
            "phase0": phase0, "altair": altair, "tampered": tampered, "swap": swap,
            "setup": setup}


def run(stack_verifier, *, validators: int, blocks: int, preset=None, swap=(5, 77),
        populate=None, observer=None, sync=None, probe=None, scenario=None,
        log=print) -> dict:
    """The whole scenario through `stack_verifier`: genesis, the blocks
    (`scenario`, made by `make_scenario` when not given), their import in
    order (`populate(epoch, pubkeys)` at the Altair boundary, if given)
    and the tampered block. Returns the records and the checks' inputs,
    the scenario under "scenario"; raises if a valid block fails to
    import or the tampered one does not fail. `swap` names the Altair
    block's two attestations whose signatures the tampered copy swaps;
    the verifier's `verify_signature_sets_individual` gives its per-set
    verdicts, with what they moved in `observer`'s and `probe()`'s counts
    and their launches under "individual_*"."""
    from .parallel.mesh_pool import launch_counts
    from .state_transition import state_transition
    from .state_transition.block import BlockProcessingError
    from .state_transition.stf import fork_types

    if scenario is None:
        scenario = make_scenario(validators=validators, blocks=blocks, preset=preset,
                                 swap=swap, log=log)
    genesis, phase0, altair = scenario["genesis"], scenario["phase0"], scenario["altair"]
    tampered, swap, config = scenario["tampered"], scenario["swap"], scenario["config"]
    out: dict = {"validators": scenario["validators"],
                 "preset": scenario["preset"].PRESET_BASE, "blocks": [],
                 "setup": scenario["setup"], "scenario": scenario}

    pool = ThreadPoolExecutor(1)
    try:
        state = genesis
        for signed in phase0 + [altair]:
            if signed is altair and populate is not None:
                keys = [bytes(pk) for pk in state.flat.pubkeys]
                out["populate"] = populate(config.ALTAIR_FORK_EPOCH, keys)
                log(f"[block] epoch table populated at the boundary: {out['populate']}")
            parent = state
            state, rec = import_block(parent, signed, stack_verifier, pool, observer, sync, probe)
            rec["host"] = host_verdicts(rec["signature_sets"])
            rec["state_root_ok"] = state.hash_tree_root() == bytes(signed.message.state_root)
            out["blocks"].append(rec)
            log(f"[block] slot {rec['slot']}: {rec['sets']} sets, pre-state "
                f"{rec['pre_state_s']:.3f} s, sets {rec['sets_s']:.3f} s, state transition "
                f"{rec['stf_s']:.3f} s, verdict {rec['verdict_s']:.3f} s ({rec['verdict']}, host "
                f"tier {all(rec['host'])}), import {rec['import_s']:.3f} s, paths "
                f"{json.dumps(rec['paths'])}, epoch table {json.dumps(rec['epoch_table'])}, "
                f"supervisor {json.dumps(rec['supervisor'])}, launches "
                f"{json.dumps(rec['launches'])}")
        # the tampered block, onto the Altair block's parent
        try:
            import_block(parent, tampered, stack_verifier, pool, observer, sync, probe)
        except BlockImportError as e:
            rec = e.args[1]
        else:
            raise AssertionError("the tampered block was imported")
        sets = rec["signature_sets"]
        rec["host"] = host_verdicts(sets)
        before = _snapshot(observer, probe)
        if sync is not None:
            sync()
        launch_counts(reset=True)
        ts = time.perf_counter()
        rec["individual"] = list(stack_verifier.verify_signature_sets_individual(sets))
        if sync is not None:
            sync()
        rec["individual_s"] = time.perf_counter() - ts
        rec["individual_launches"] = launch_counts()
        rec.update({f"individual_{g}": v
                    for g, v in _moved(before, _snapshot(observer, probe)).items()})
        rec["swapped_sets"] = [2 + swap[0], 2 + swap[1]]  # after the proposer and randao sets
        pre = BlockFactory.advance(parent, tampered.message.slot)
        try:
            state_transition(pre, fork_types(pre), tampered, verify_state_root=True,
                             verify_signatures=True)
        except BlockProcessingError as e:
            rec["host_stf_error"] = str(e)
        else:
            rec["host_stf_error"] = None
        rec["tampered"] = True
        out["blocks"].append(rec)
        log(f"[block] tampered slot {rec['slot']}: verdict {rec['verdict']} (host tier "
            f"{all(rec['host'])}), blamed "
            f"{[k for k, v in enumerate(rec['individual']) if not v]} (swapped "
            f"{rec['swapped_sets']}) in {rec['individual_s']:.3f} s (paths "
            f"{json.dumps(rec['individual_paths'])}, supervisor "
            f"{json.dumps(rec['individual_supervisor'])}, launches "
            f"{json.dumps(rec['individual_launches'])}), host-tier state transition: "
            f"{rec['host_stf_error']}; the verdict's supervisor {json.dumps(rec['supervisor'])}, "
            f"launches {json.dumps(rec['launches'])}")
    finally:
        pool.shutdown()
    return out


def stack_populate(stack, timeout: float | None = None):
    """`run`'s `populate` over a `BlsStack`: the epoch table filled on the
    stack's thread, waited for; returns the stack's `last_populate` with
    the wall seconds."""
    def populate(epoch, keys):
        t0 = time.perf_counter()
        if not stack.populate_epoch_async(epoch, keys) or not stack.wait_populated(timeout):
            raise RuntimeError("epoch table population did not run to its end")
        return {**(stack.last_populate or {}), "wall_s": time.perf_counter() - t0}

    return populate


def summary(out: dict) -> dict:
    """The run's records without the sets and the scenario, for JSON."""
    return {**{k: v for k, v in out.items() if k != "scenario"},
            "blocks": [{k: v for k, v in rec.items() if k != "signature_sets"}
                       for rec in out["blocks"]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--validators", type=int, default=16384)
    ap.add_argument("--blocks", type=int, default=3, help="phase0 blocks at slots 1..N")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="build/lodestar_tpu_torch/profile_block.json")
    args = ap.parse_args(argv)

    import torch

    from .native import install_ssz_backend
    from .node.bls_stack import build_bls_stack

    install_ssz_backend()
    stack = build_bls_stack(device=args.device)
    cuda = str(stack.device.device).startswith("cuda")
    try:
        out = run(stack.verifier, validators=args.validators, blocks=args.blocks,
                  populate=stack_populate(stack), observer=stack.pipeline,
                  sync=torch.cuda.synchronize if cuda else None)
    finally:
        stack.close()
    doc = summary(out)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print(json.dumps(doc), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

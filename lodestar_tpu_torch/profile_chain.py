"""One slot of the chain on the GPU: the port's `BeaconChain`, its fork
choice and its gossip validators over the port's serving stack.

    python3 -m lodestar_tpu_torch.profile_chain [--validators 16384] [--blocks 3] [--device cuda]
        [--preset mainnet|minimal] [--verifier stack|host]

On `profile_block`'s scenario (the mainnet preset, Altair at epoch 1,
`--validators` interop validators; its genesis, phase0 blocks at slots
1..`--blocks`, the first Altair block and its tampered copy) it builds a
`BeaconChain` on the genesis with a `ManualClock` and, with every
signature verdict given by the verifier (`run`):

(a) imports the phase0 blocks with `process_block_segment` (one verdict);
(b) refuses the tampered Altair block (`BlockImportError`, head and
    blocks unchanged);
(c) validates the Altair block as gossip (ACCEPT) and imports it;
(d) sends one single-bit attestation from every member of the Altair
    slot's committees through `validate_gossip_attestation` (the
    attestation lane) from `gossip_threads` threads, the accepted ones
    to `on_gossip_attestation`, with four more mixed in: two signed by
    another validator (REJECT "invalid signature"), a replay (IGNORE
    "already seen") and one on the wrong subnet (REJECT "wrong subnet");
(e) sends a `SignedAggregateAndProof` from every aggregator of those
    committees (by selection proof) through
    `validate_gossip_aggregate_and_proof` (the aggregate lane, three
    sets each) from `aggregate_threads` threads, the accepted ones to
    `on_aggregated_attestation`, and one more whose selection proof is
    another aggregator's (REJECT "invalid signatures"); then the head
    must be the Altair block, its weight the committees' votes and the
    proposer boost;
(f) moves the clock one slot on, produces a block from the pools
    (`produce_block`), signs it with its proposer's key, validates it as
    gossip (ACCEPT) and imports it: its body carries the aggregates, and
    it becomes the head.

A message whose expected outcome depends on another's (the bad
signatures before their sender's valid attestation, the replay after
it, the bad aggregate before its aggregator's valid one) is sent on the
same thread after or before it, so every action is deterministic; those
threads start first, the rest in a seeded shuffle. Each
aggregator's aggregate leaves out one committee member, a different one
for each aggregator: the spec's superset rule ignores an aggregate whose
bits an accepted one covers, so copies of one full aggregate would be
accepted or ignored by thread timing.

Prints one line per step and one JSON line (also written to `--out`,
default build/lodestar_tpu_torch/profile_chain.json); exits 1 if a
check failed. The verdicts come from the port's serving stack on
`--device` (a GPU unless `--device cpu`), with the epoch table populated
at the Altair boundary, or with `--verifier host` from the C host tier
alone (no stack, no device). On the CPU: `--preset minimal --validators
64 --verifier host` runs in seconds.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from . import profile_block

GOSSIP_THREADS = 64
AGGREGATE_THREADS = 16
TARGET_AGGREGATORS_PER_COMMITTEE = 16
SEED = 17


class RecordingVerifier:
    """A pass-through verifier that records each call's sets, lane and
    verdict (for the host tier's check). It forwards `batchable` and
    `lane` where the wrapped verifier takes them, and takes any keyword
    itself, so the chain's `_verify_now` and `_verify_lane` hand it
    theirs."""

    def __init__(self, inner):
        self.inner = inner
        params = inspect.signature(inner.verify_signature_sets).parameters
        if any(p.kind is p.VAR_KEYWORD for p in params.values()):
            self._takes = {"batchable", "lane"}
        else:
            self._takes = {k for k in ("batchable", "lane") if k in params}
        self.calls: list[dict] = []
        self._lock = threading.Lock()

    def verify_signature_sets(self, sets, **kwargs) -> bool:
        sets = list(sets)
        ok = bool(self.inner.verify_signature_sets(
            sets, **{k: v for k, v in kwargs.items() if k in self._takes}))
        with self._lock:
            self.calls.append({"kind": "batch", "lane": kwargs.get("lane"),
                               "batchable": kwargs.get("batchable", True), "sets": sets,
                               "verdicts": [ok]})
        return ok

    def verify_signature_sets_individual(self, sets) -> list[bool]:
        sets = list(sets)
        out = [bool(v) for v in self.inner.verify_signature_sets_individual(sets)]
        with self._lock:
            self.calls.append({"kind": "individual", "lane": None, "batchable": False,
                               "sets": sets, "verdicts": out})
        return out

    def take(self) -> list[dict]:
        with self._lock:
            calls, self.calls = self.calls, []
        return calls


def host_mismatches(calls, threads: int | None = None) -> list[dict]:
    """The recorded calls whose verdicts differ from the C host tier's on
    the same sets (one native call over all of them)."""
    sets = [s for c in calls for s in c["sets"]]
    if not sets:
        return []
    host = profile_block.host_verdicts(sets, threads)
    bad, pos = [], 0
    for c in calls:
        share = host[pos: pos + len(c["sets"])]
        pos += len(c["sets"])
        want = [all(share)] if c["kind"] == "batch" else list(share)
        if want != c["verdicts"]:
            bad.append({"kind": c["kind"], "lane": c["lane"], "sets": len(c["sets"]),
                        "verdicts": c["verdicts"], "host": want})
    return bad


class _BatchSpy:
    """Records the size and reason of every batch a `BlsLaneDispatcher`
    dispatches while entered (nothing for another verifier), and the
    sizes of those whose verdict was False (each then took a per-set
    pass)."""

    def __init__(self, verifier):
        self.verifier = verifier
        self.batches: list[tuple[int, str]] = []
        self.failed: list[int] = []

    def __enter__(self):
        real = getattr(self.verifier, "_dispatch_batch", None)
        if real is not None:
            def spy(entries, n_sets, reason, overlapped):
                self.batches.append((int(n_sets), str(reason)))
                out = real(entries, n_sets, reason, overlapped)
                if not all(holder[0] for _, _, holder, _, _ in entries):
                    self.failed.append(int(n_sets))
                return out

            self.verifier._dispatch_batch = spy
        return self

    def __exit__(self, *exc):
        self.verifier.__dict__.pop("_dispatch_batch", None)
        return False


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))] if xs else None


def _trace_breakdown(tracer, name: str) -> dict:
    """Seconds by span of the newest trace named `name` (the chain's own
    lifecycle spans: pre-state, verdict, state transition, fork choice,
    import, head update), summed over repeats."""
    for doc in tracer.traces(limit=tracer.capacity):
        if doc["name"] == name:
            out: dict = {}
            for span in doc["spans"]:
                key = span["name"].split("/", 1)[-1] + "_s"
                out[key] = out.get(key, 0.0) + span["duration_s"]
            return out
    return {}


class _Step:
    """What one step moved: seconds, the observer's and probe's counts
    (`profile_block._snapshot`) and the kernels' launches (from zero)."""

    def __init__(self, observer, probe, sync):
        self.observer, self.probe, self.sync = observer, probe, sync

    def __enter__(self):
        from .parallel.mesh_pool import launch_counts

        if self.sync is not None:
            self.sync()
        self.before = profile_block._snapshot(self.observer, self.probe)
        launch_counts(reset=True)
        self.t0 = time.perf_counter()
        self.record: dict = {}
        return self.record

    def __exit__(self, exc_type, *exc):
        from .parallel.mesh_pool import launch_counts

        if self.sync is not None and exc_type is None:
            self.sync()
        self.record["seconds"] = time.perf_counter() - self.t0
        self.record.update(profile_block._moved(
            self.before, profile_block._snapshot(self.observer, self.probe)))
        self.record["launches"] = launch_counts()
        return False


def _flood(tasks, threads: int, validate, accept):
    """Run `tasks` (lists of (message, expected action, expected reason,
    arguments)) from `threads` threads, each task's messages in order:
    `validate(message, *arguments)` gives the `ValidationResult`, an
    ACCEPT goes to `accept(message, result)`. Returns the outcomes (one
    per message, in task order), the validations' latencies and the
    makespan."""
    outcomes: list = [None] * len(tasks)

    def one(i):
        got = []
        for msg, action, reason, args in tasks[i]:
            t0 = time.perf_counter()
            res = validate(msg, *args)
            lat = time.perf_counter() - t0
            if res.action.value == "ACCEPT":
                accept(msg, res)
            got.append({"want": [action, reason], "got": [res.action.value, res.reason],
                        "latency_s": lat})
        outcomes[i] = got

    t0 = time.perf_counter()
    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(one, range(len(tasks))))
    makespan = time.perf_counter() - t0
    flat = [o for got in outcomes for o in got]
    return flat, [o["latency_s"] for o in flat], makespan


def _flood_record(rec: dict, flat, lats, makespan, spy) -> None:
    rec.update({
        "calls": len(flat), "makespan_s": makespan,
        "validations_per_s": len(flat) / makespan if makespan else None,
        "latency_p50_s": _pct(lats, 0.5), "latency_p99_s": _pct(lats, 0.99),
        "latency_max_s": max(lats) if lats else None,
        "batches": len(spy.batches), "batch_sizes": [n for n, _ in spy.batches],
        "batch_reasons": sorted({r for _, r in spy.batches}),
        "actions": _count(o["got"][0] for o in flat),
        "unexpected": [o for o in flat if o["got"] != o["want"]],
    })


def _chains_first(tasks, seed: int) -> list:
    """The tasks in a seeded shuffle, those of more than one message
    first: a message sent after another's verdict then joins the flood
    instead of trailing it as a batch of its own."""
    random.Random(seed).shuffle(tasks)
    return [t for t in tasks if len(t) > 1] + [t for t in tasks if len(t) == 1]


def _count(xs) -> dict:
    out: dict = {}
    for x in xs:
        out[x] = out.get(x, 0) + 1
    return out


def run(verifier, *, validators: int = 16384, blocks: int = 3, preset=None, swap=(5, 77),
        scenario=None, observer=None, probe=None, sync=None,
        gossip_threads: int = GOSSIP_THREADS, aggregate_threads: int = AGGREGATE_THREADS,
        flood_committees: int | None = None, keep: bool = False, log=print) -> dict:
    """Steps (a)–(f) of the module's docstring through `verifier` on
    `scenario` (`profile_block.make_scenario`'s; made here when not
    given). Returns the records by step ("steps"), each with its seconds,
    what it moved in `observer`'s and `probe()`'s counts and the kernels'
    launches; the verifier's calls whose verdicts differ from the host
    tier's ("host_mismatches"); and every failed check ("failures",
    empty when all pass). `sync` (e.g. a device synchronise) runs around
    each step.

    `flood_committees` cuts (d) and (e) to the slot's first committees
    (the four mixed-in messages among their members, and only their
    aggregates; None: every committee). With `keep` the chain is not
    closed: it is returned as "chain" (the caller closes it), with the
    whole slot's messages as "gossip" (every committee's attestation
    tasks, aggregates and the produced block) for `profile_network`."""
    from .chain.chain import BeaconChain, BlockImportError
    from .chain.clock import ManualClock
    from .chain.validation import (
        validate_gossip_aggregate_and_proof,
        validate_gossip_attestation,
        validate_gossip_block,
    )
    from .config.beacon_config import compute_signing_root
    from .observability import spans
    from .params import (
        ATTESTATION_SUBNET_COUNT,
        DOMAIN_AGGREGATE_AND_PROOF,
        DOMAIN_BEACON_ATTESTER,
        DOMAIN_BEACON_PROPOSER,
        DOMAIN_RANDAO,
        DOMAIN_SELECTION_PROOF,
    )
    from .ssz import uint64
    from .ssz.hashing import sha256
    from .state_transition.block import _epoch_signing_root
    from .state_transition.stf import fork_types
    from .types import get_types

    if scenario is None:
        scenario = profile_block.make_scenario(validators=validators, blocks=blocks,
                                               preset=preset, swap=swap, log=log)
    config, genesis, p = scenario["config"], scenario["genesis"], scenario["preset"]
    phase0, altair, tampered = scenario["phase0"], scenario["altair"], scenario["tampered"]
    n = scenario["validators"]
    spe = p.SLOTS_PER_EPOCH
    types = get_types(p).phase0
    failures: list[str] = []
    steps: dict = {}
    out = {"validators": n, "preset": p.PRESET_BASE, "steps": steps, "failures": failures}

    def expect(cond, what):
        if not cond:
            failures.append(what)

    recorder = RecordingVerifier(verifier)
    factory = profile_block.BlockFactory(config, n)
    t0 = time.perf_counter()
    chain = BeaconChain(config, types, genesis.state, verifier=recorder,
                        clock=ManualClock(genesis.state.genesis_time, config.SECONDS_PER_SLOT, spe))
    out["chain_init_s"] = time.perf_counter() - t0
    step = lambda: _Step(observer, probe, sync)  # noqa: E731
    try:
        # (a) the phase0 blocks as one segment
        chain.clock.set_slot(int(phase0[-1].message.slot))
        with step() as rec:
            roots = chain.process_block_segment(phase0)
        rec.update(_trace_breakdown(spans.tracer, "chain/process_segment"))
        calls = recorder.take()
        rec.update(sets=sum(len(c["sets"]) for c in calls), verdicts=len(calls),
                   host_mismatches=host_mismatches(calls))
        steps["segment"] = rec
        want = [b.message.hash_tree_root() for b in phase0]
        expect(roots == want and chain.head_root == want[-1],
               f"segment: roots {len(roots)} imported, head is the last block "
               f"{chain.head_root == want[-1]}")
        expect(len(calls) == 1 and calls[0]["verdicts"] == [True],
               f"segment: {len(calls)} verdicts {[c['verdicts'] for c in calls]}")

        # (b) the tampered Altair block is refused
        altair_slot = int(altair.message.slot)
        chain.clock.set_slot(altair_slot)
        head, known = chain.head_root, set(chain.blocks)
        with step() as rec:
            try:
                chain.process_block(tampered)
                rec["refused"] = None
            except BlockImportError as e:
                rec["refused"] = str(e)
        rec.update(_trace_breakdown(spans.tracer, "chain/process_block"))
        calls = recorder.take()
        rec.update(sets=sum(len(c["sets"]) for c in calls), verdicts=len(calls),
                   host_mismatches=host_mismatches(calls))
        steps["tampered"] = rec
        expect(rec["refused"] is not None, "tampered: the block was imported")
        expect(chain.head_root == head and set(chain.blocks) == known,
               "tampered: the head or the blocks changed")

        # (c) the Altair block: gossip, then import
        altair_root = altair.message.hash_tree_root()
        with step() as rec:
            t1 = time.perf_counter()
            res = validate_gossip_block(chain, types, altair)
            rec["gossip_s"] = time.perf_counter() - t1
            rec["gossip"] = [res.action.value, res.reason]
            chain.process_block(altair)
        rec.update(_trace_breakdown(spans.tracer, "chain/process_block"))
        calls = recorder.take()
        rec.update(sets=sum(len(c["sets"]) for c in calls), verdicts=len(calls),
                   host_mismatches=host_mismatches(calls))
        steps["altair"] = rec
        expect(rec["gossip"] == ["ACCEPT", ""], f"altair: gossip {rec['gossip']}")
        expect(chain.head_root == altair_root, "altair: not the head")
        expect(chain.head_state.hash_tree_root() == bytes(altair.message.state_root),
               "altair: the head state's root is not the block's")

        # (d) the slot's attestations as gossip
        slot, epoch = altair_slot, altair_slot // spe
        ctx = chain.head_state.epoch_ctx
        cps = ctx.get_committee_count_per_slot(epoch)
        committees = [[int(v) for v in ctx.get_beacon_committee(slot, i)] for i in range(cps)]
        target_root = chain.fork_choice.get_ancestor(altair_root, epoch * spe)
        source = chain.head_state.state.current_justified_checkpoint
        datas = [types.AttestationData(
            slot=slot, index=i, beacon_block_root=altair_root, source=source.copy(),
            target=types.Checkpoint(epoch=epoch, root=target_root)) for i in range(cps)]
        att_domain = config.get_domain(DOMAIN_BEACON_ATTESTER, slot, epoch)
        signing = [compute_signing_root(d.hash_tree_root(), att_domain) for d in datas]
        members = [(i, pos, v) for i, c in enumerate(committees) for pos, v in enumerate(c)]
        flooded = cps if flood_committees is None else min(flood_committees, cps)
        used = [m for m in members if m[0] < flooded]
        # a donor outside these committees signs the two bad messages
        donors = [int(v) for v in ctx.get_beacon_committee(slot + 1, 0)[:2]]
        bad_at = [used[1], used[len(committees[0]) + 1 if flooded > 1 else 2]]
        replay_at, wrong_at = used[-1], used[-2]
        t1 = time.perf_counter()
        sigs = factory.sign([(v, signing[i]) for i, _, v in members]
                            + [(d, signing[m[0]]) for d, m in zip(donors, bad_at)])
        sign_s = time.perf_counter() - t1

        def attestation(i, pos, sig):
            return types.Attestation(
                aggregation_bits=[k == pos for k in range(len(committees[i]))],
                data=datas[i].copy(), signature=sig)

        def subnet(i):
            return (cps * (slot % spe) + i) % ATTESTATION_SUBNET_COUNT

        all_tasks = []  # (committee, task) for the whole slot
        for k, (i, pos, v) in enumerate(members):
            att = attestation(i, pos, sigs[k])
            task = [(att, "ACCEPT", "", (subnet(i),))]
            if (i, pos, v) in bad_at:
                j = bad_at.index((i, pos, v))
                bad = attestation(i, pos, sigs[len(members) + j])
                task.insert(0, (bad, "REJECT", "invalid signature", (subnet(i),)))
            if (i, pos, v) == replay_at:
                task.append((att, "IGNORE", "already seen", (subnet(i),)))
            all_tasks.append((i, task))
            if (i, pos, v) == wrong_at:
                all_tasks.append((i, [(att, "REJECT", "wrong subnet",
                                       ((subnet(i) + 1) % ATTESTATION_SUBNET_COUNT,))]))
        tasks = _chains_first([t for i, t in all_tasks if i < flooded], SEED)
        with step() as rec:
            t1 = time.perf_counter()
            chain.regen.get_checkpoint_state(epoch, target_root)
            rec["checkpoint_regen_s"] = time.perf_counter() - t1
            with _BatchSpy(verifier) as spy:
                flat, lats, makespan = _flood(
                    tasks, gossip_threads,
                    lambda att, sn: validate_gossip_attestation(chain, types, att, sn),
                    lambda att, res: chain.on_gossip_attestation(att, res.data_root))
        calls = recorder.take()
        _flood_record(rec, flat, lats, makespan, spy)
        rec.update(sign_s=sign_s, committees=cps, flooded=flooded, members=len(used),
                   sets=sum(len(c["sets"]) for c in calls), verdicts=len(calls),
                   lanes=sorted({str(c["lane"]) for c in calls}),
                   host_mismatches=host_mismatches(calls))
        steps["attestations"] = rec
        expect(not rec["unexpected"], f"attestations: unexpected {rec['unexpected'][:4]}")
        expect(rec["lanes"] == ["attestation"], f"attestations: lanes {rec['lanes']}")
        pooled = [chain.attestation_pool.get_aggregate(slot, d.hash_tree_root())
                  for d in datas[:flooded]]
        expect(all(g is not None and all(g[1]) for g in pooled),
               "attestations: the pool does not hold every committee's full aggregate")

        # (e) the aggregates
        sel_root = compute_signing_root(uint64.hash_tree_root(slot),
                                        config.get_domain(DOMAIN_SELECTION_PROOF, slot))
        env_domain = config.get_domain(DOMAIN_AGGREGATE_AND_PROOF, slot)
        t1 = time.perf_counter()
        proofs = factory.sign([(v, sel_root) for _, _, v in members])
        aggregators = []  # (committee, position, validator, proof)
        for (i, pos, v), proof in zip(members, proofs):
            modulo = max(1, len(committees[i]) // TARGET_AGGREGATORS_PER_COMMITTEE)
            if int.from_bytes(sha256(proof)[:8], "little") % modulo == 0:
                aggregators.append((i, pos, v, proof))
        per_committee = _count(a[0] for a in aggregators)
        expect(len(per_committee) == cps and min(per_committee.values()) >= 2,
               f"aggregates: aggregators by committee {per_committee}")
        left_out = [(a[1] + 1) % len(committees[a[0]]) for a in aggregators]
        agg_sigs = factory.sign_aggregate([
            ([v for pos, v in enumerate(committees[a[0]]) if pos != out_pos], signing[a[0]])
            for a, out_pos in zip(aggregators, left_out)])
        msgs = []
        for a, out_pos, sig in zip(aggregators, left_out, agg_sigs):
            i, _, v, proof = a
            att = types.Attestation(
                aggregation_bits=[k != out_pos for k in range(len(committees[i]))],
                data=datas[i].copy(), signature=sig)
            msgs.append(types.AggregateAndProof(aggregator_index=v, aggregate=att,
                                                selection_proof=proof))
        # the bad one: the first aggregator's aggregate with the proof of
        # an aggregator of another committee (it passes the modulo test)
        other = next(a for a in aggregators if a[0] != aggregators[0][0]) \
            if cps > 1 else aggregators[1]
        bad_msg = msgs[0].copy()
        bad_msg.selection_proof = other[3]
        env = factory.sign([(m.aggregator_index, compute_signing_root(m.hash_tree_root(),
                                                                      env_domain))
                            for m in msgs + [bad_msg]])
        sign_s = time.perf_counter() - t1
        signed = [types.SignedAggregateAndProof(message=m, signature=s)
                  for m, s in zip(msgs + [bad_msg], env)]
        tasks = [[(s, "ACCEPT", "", ())] for s in signed[:-1]]
        tasks[0].insert(0, (signed[-1], "REJECT", "invalid signatures", ()))
        all_aggregates = [(a[0], t) for a, t in zip(aggregators, tasks)]
        tasks = _chains_first([t for i, t in all_aggregates if i < flooded], SEED + 1)
        with step() as rec:
            with _BatchSpy(verifier) as spy:
                flat, lats, makespan = _flood(
                    tasks, aggregate_threads,
                    lambda s: validate_gossip_aggregate_and_proof(chain, types, s),
                    lambda s, res: chain.on_aggregated_attestation(s.message.aggregate,
                                                                   res.data_root))
            chain.update_head()
        calls = recorder.take()
        _flood_record(rec, flat, lats, makespan, spy)
        rec.update(sign_s=sign_s, aggregators=len(aggregators),
                   aggregators_by_committee=per_committee,
                   sets=sum(len(c["sets"]) for c in calls), verdicts=len(calls),
                   lanes=sorted({str(c["lane"]) for c in calls}),
                   host_mismatches=host_mismatches(calls))
        fc = chain.fork_choice
        weight = int(fc.proto.weights[fc.proto.indices[altair_root]])
        votes = int(chain.head_state.flat.effective_balance[[v for _, _, v in used]].sum())
        boost = fc._compute_proposer_boost_score() if fc.proposer_boost_root == altair_root else 0
        rec.update(weight=weight, votes=votes, boost=boost)
        steps["aggregates"] = rec
        expect(not rec["unexpected"], f"aggregates: unexpected {rec['unexpected'][:4]}")
        expect(rec["lanes"] == ["aggregate"], f"aggregates: lanes {rec['lanes']}")
        expect(chain.head_root == altair_root, "aggregates: the head moved off the Altair block")
        expect(weight == votes + boost,
               f"aggregates: the Altair block's weight {weight}, votes {votes} + boost {boost}")

        # (f) a block produced from the pools, then gossip and import
        slot2 = slot + 1
        chain.clock.set_slot(slot2)
        proposer = chain.head_state.epoch_ctx.get_beacon_proposer(slot2)
        with step() as rec:
            t1 = time.perf_counter()
            (reveal,) = factory.sign([(proposer, _epoch_signing_root(
                slot2 // spe, config.get_domain(DOMAIN_RANDAO, slot2)))])
            block = chain.produce_block(slot2, reveal)
            rec["produce_s"] = time.perf_counter() - t1
            (sig,) = factory.sign([(block.proposer_index, compute_signing_root(
                block.hash_tree_root(), config.get_domain(DOMAIN_BEACON_PROPOSER, slot2)))])
            produced = fork_types(chain.head_state).SignedBeaconBlock(message=block, signature=sig)
            t1 = time.perf_counter()
            res = validate_gossip_block(chain, types, produced)
            rec["gossip_s"] = time.perf_counter() - t1
            rec["gossip"] = [res.action.value, res.reason]
            root = chain.process_block(produced)
        rec.update(_trace_breakdown(spans.tracer, "chain/process_block"))
        calls = recorder.take()
        carried = [a for a in block.body.attestations if int(a.data.slot) == slot]
        rec.update(slot=slot2, attestations=len(block.body.attestations),
                   carried=sorted(int(a.data.index) for a in carried),
                   carried_bits=[sum(a.aggregation_bits) for a in carried],
                   sets=sum(len(c["sets"]) for c in calls), verdicts=len(calls),
                   host_mismatches=host_mismatches(calls))
        steps["produce"] = rec
        expect(block.proposer_index == proposer, "produce: wrong proposer")
        expect(rec["gossip"] == ["ACCEPT", ""], f"produce: gossip {rec['gossip']}")
        expect(root == block.hash_tree_root() and chain.head_root == root,
               "produce: the produced block is not the head")
        expect(rec["carried"] == list(range(flooded)),
               f"produce: the block carries the aggregates of committees {rec['carried']}")
        for name, r in steps.items():
            expect(not r["host_mismatches"],
                   f"{name}: verdicts differ from the host tier's: {r['host_mismatches'][:2]}")
        out["head"] = chain.head_root.hex()
        out["justified"] = [chain.justified_checkpoint[0], chain.justified_checkpoint[1].hex()]
        if keep:
            out["gossip"] = {"slot": slot, "block_root": altair_root, "subnets":
                             [subnet(i) for i in range(cps)], "attestations": all_tasks,
                             "aggregates": all_aggregates, "produced": produced}
    finally:
        factory.close()
        if keep:
            out["chain"] = chain
        else:
            chain.close()
    return out


def log_steps(out: dict, log=print) -> None:
    """One line per step of `run`'s record."""
    def blocks(r):
        keys = ("pre_state_s", "bls_verify_s", "state_transition_s", "fork_choice_s",
                "import_s", "head_update_s")
        return ", ".join(f"{k[:-2]} {r[k]:.3f} s" for k in keys if k in r)

    def common(r):
        return (f"paths {json.dumps(r.get('paths', {}))}, epoch table "
                f"{json.dumps(r.get('epoch_table', {}))}, supervisor "
                f"{json.dumps(r.get('supervisor', {}))}, launches {json.dumps(r['launches'])}")

    s = out["steps"]
    for name in ("segment", "tampered", "altair"):
        if name in s:
            r = s[name]
            log(f"[chain] {name}: {r['seconds']:.3f} s, {r['sets']} sets in {r['verdicts']} "
                f"verdicts ({blocks(r)})"
                + (f", gossip {r['gossip']} {r['gossip_s']:.3f} s" if "gossip" in r else "")
                + (f", refused: {r['refused']}" if name == "tampered" else "")
                + f"; {common(r)}")
    for name in ("attestations", "aggregates"):
        if name in s:
            r = s[name]
            log(f"[chain] {name}: {r['calls']} calls, makespan {r['makespan_s']:.3f} s, "
                f"{r['validations_per_s']:.1f} validations/s, latency p50 "
                f"{r['latency_p50_s']:.4f} p99 {r['latency_p99_s']:.4f} max "
                f"{r['latency_max_s']:.4f} s, actions {json.dumps(r['actions'])}, "
                f"{r['batches']} coalesced batches (sizes {r['batch_sizes']}, "
                f"{r['batch_reasons']}), {r['sets']} sets in {r['verdicts']} verdicts"
                + (f", first checkpoint-state regen {r['checkpoint_regen_s']:.3f} s"
                   if "checkpoint_regen_s" in r else "")
                + (f", weight {r['weight']} = votes {r['votes']} + boost {r['boost']}"
                   if "weight" in r else "")
                + f"; {common(r)}")
    if "produce" in s:
        r = s["produce"]
        log(f"[chain] produce slot {r['slot']}: {r['seconds']:.3f} s (produce_block "
            f"{r['produce_s']:.3f} s, gossip {r['gossip']} {r['gossip_s']:.3f} s, "
            f"{blocks(r)}), {r['attestations']} attestations (committees {r['carried']}, "
            f"bits {r['carried_bits']}); {common(r)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--validators", type=int, default=16384)
    ap.add_argument("--blocks", type=int, default=3, help="phase0 blocks at slots 1..N")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--preset", choices=("mainnet", "minimal"), default="mainnet")
    ap.add_argument("--verifier", choices=("stack", "host"), default="stack",
                    help="the serving stack on --device, or the C host tier alone")
    ap.add_argument("--out", default="build/lodestar_tpu_torch/profile_chain.json")
    args = ap.parse_args(argv)

    import torch

    from .chain.bls_verifier import CpuBlsVerifier
    from .native import install_ssz_backend
    from .node.bls_stack import build_bls_stack
    from .params import MAINNET, MINIMAL

    install_ssz_backend()
    preset = MINIMAL if args.preset == "minimal" else MAINNET
    # the Altair block carries an aggregate per committee of the previous
    # epoch: two of them are swapped in its tampered copy
    swap = (1, 3) if args.preset == "minimal" else (5, 77)
    scenario = profile_block.make_scenario(validators=args.validators, blocks=args.blocks,
                                           preset=preset, swap=swap)
    if args.verifier == "host":
        out = run(CpuBlsVerifier(), scenario=scenario)
    else:
        stack = build_bls_stack(device=args.device)
        cuda = str(stack.device.device).startswith("cuda")
        try:
            keys = [bytes(pk) for pk in scenario["genesis"].flat.pubkeys]
            profile_block.stack_populate(stack)(scenario["config"].ALTAIR_FORK_EPOCH, keys)
            out = run(stack.verifier, scenario=scenario, observer=stack.pipeline,
                      sync=torch.cuda.synchronize if cuda else None)
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

"""One slot of the network on the GPU: a node that range-syncs its first
blocks from a peer, then validates one slot of gossip that arrives from
32 peers over the port's transport, every verdict given by the port's
serving stack.

    python3 -m lodestar_tpu_torch.profile_network [--validators 16384] [--peers 32]
        [--device cuda] [--preset mainnet|minimal] [--verifier stack|host]

On `profile_chain`'s result (`profile_chain.run(..., keep=True)`: its
chain P holds blocks 1-3, the Altair block of the next epoch and the
block produced a slot later, and its "gossip" the whole slot's
attestation tasks, aggregates and that produced block), `run` builds, on
loopback in one process and one event loop:

- P: a `Network` over that chain, which serves status and
  `beacon_blocks_by_range` and answers discovery; it leaves every gossip
  topic, so no message is forwarded to it and it validates nothing;
- R, the node under test: a new `BeaconChain` on the same genesis and
  verifier (`RecordingVerifier` around it), a `ManualClock`, and a
  `Network` with `subscribe_all_subnets=True`; its router's clock is a
  manual one too, so no score decays during the run;
- Q1..Q`peers`: each a `Transport`, `GossipsubService` and `Gossipsub`
  with its own identity and no subscriptions: they publish to R and R
  forwards nothing to them.

and then, each step timed, with the verifier's counts before and after:

(a) R finds P through discovery (UDP) from P's record and dials it (the
    handshake both ways, then status); Q1..Q`peers` dial R. Logs each
    dial's seconds and the host µs of each primitive.
(b) R asks P for `beacon_blocks_by_range` over slots 1..Altair slot and
    imports what comes (the phase0 blocks and the Altair block) with
    `process_block_segment`: one verdict; R's head is then P's Altair
    block.
(c) the slot's attestations (one per committee member) published by
    Q1..Q`peers` round-robin on their subnets' topics, with the chain
    phase's two bad signatures (REJECT), its wrong-subnet attestation
    (REJECT), a second vote of one attester on another head (IGNORE),
    and after the flood a byte-identical replay from a second peer, which
    R's router counts as a duplicate and never validates; every other
    message ACCEPT. Each sender's gossipsub score on R must be the one
    `score.py` gives for the deliveries and REJECTs it was sent.
(d) every aggregator's aggregate of the slot, the same way, one carrying
    another aggregator's selection proof (REJECT); then R's head is the
    Altair block.
(e) the produced block published by Q1 a slot later: ACCEPT, imported;
    R's head and its weight are then P's.

A message whose action depends on another (a bad signature before its
sender's valid attestation, the second vote after it, the bad aggregate
before its aggregator's valid one) goes to the same peer after or before
it: R's gossipsub validates one peer's stream one message at a time, as
the JAX package's does, so every action is deterministic.

Behind a `BlsLaneDispatcher`, each flood runs with the lane flushing at
its cohort, or after `COHORT_WAIT_S`: the messages in flight (one per
peer, at most the topic's queue concurrency: 64 attestations, 16
aggregates) times the sets of one (one for an attestation, three for an
aggregate); each round is then one batch (the dispatcher's own flush is
restored after).

The nodes' SSZ types are the Altair types with `SignedBeaconBlock`
decoded by its slot's fork: the `Network` decodes every block with the
one namespace it is given (as in the JAX package), and R's range sync
crosses the fork. The validations run on the event loop's default
executor, given `threads` threads (the JAX handlers' executor holds
min(32, cores + 4)).

Prints one line per step and one JSON line (also written to `--out`);
exits 1 if a check failed. On the CPU: `--preset minimal --validators 64
--verifier host` runs in seconds.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import os
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

from . import profile_block, profile_chain

PEERS = 32
VALIDATION_THREADS = 64
SEED = 19
WAIT_S = 600.0  # the bound on one flood's verdicts
# a flood's lane flush: the peers' cohort (one message each in flight)
# and a wait past the spread of their next arrivals after a verdict (over
# 100 ms on the card's host: at the chain's 64 sets or 100 ms the cohort
# split into batches of 28 and 4 that took turns on the lane's one worker)
COHORT_WAIT_S = 1.0


class _Family:
    """One metric family of `Counters`: inc, set and observe by labels."""

    def __init__(self):
        self.values: dict = {}

    def inc(self, n=1, **labels):
        key = tuple(sorted(labels.items()))
        self.values[key] = self.values.get(key, 0) + n

    def set(self, value, **labels):
        self.values[tuple(sorted(labels.items()))] = value

    def observe(self, value, **labels):
        self.values.setdefault(tuple(sorted(labels.items())), []).append(value)

    def total(self) -> float:
        return sum(v for v in self.values.values() if not isinstance(v, list))


class Counters:
    """A duck-typed `metrics=` for `Network`: every family the network
    touches, recorded by name and labels."""

    def __init__(self):
        self.families: dict[str, _Family] = {}

    def __getattr__(self, name: str) -> _Family:
        if name.startswith("_"):
            raise AttributeError(name)
        return self.families.setdefault(name, _Family())

    def by_label(self, name: str, label: str) -> dict:
        out: dict = {}
        for key, v in self.families.get(name, _Family()).values.items():
            out[dict(key).get(label)] = out.get(dict(key).get(label), 0) + v
        return out


class ManualTime:
    """A router clock that moves only when told."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


class _ForkBlocks:
    """`SignedBeaconBlock` of every fork: a block is decoded with its
    slot's fork's type (the slot is the message's first field)."""

    def __init__(self, config, by_fork):
        self.config, self.by_fork = config, by_fork

    def deserialize(self, data: bytes):
        offset = int.from_bytes(data[:4], "little")
        slot = int.from_bytes(data[offset:offset + 8], "little")
        fork = self.config.get_fork_name_at_slot(slot)
        return self.by_fork[fork].SignedBeaconBlock.deserialize(data)


def node_types(config):
    """The Altair namespace with blocks decoded by their slot's fork."""
    from .types import get_types

    t = get_types(config.preset)
    return SimpleNamespace(**{**vars(t.altair), "SignedBeaconBlock":
                              _ForkBlocks(config, t.by_fork)})


@contextlib.contextmanager
def _cohort_flush(verifier, max_sigs: int, max_wait_s: float = COHORT_WAIT_S):
    """Flush `verifier`'s lanes (a `BlsLaneDispatcher`) at `max_sigs` sets
    or `max_wait_s` while entered; another verifier is left as it is."""
    if not hasattr(verifier, "max_wait"):
        yield
        return
    saved = verifier.max_sigs, verifier.max_wait
    verifier.max_sigs, verifier.max_wait = max_sigs, max_wait_s
    try:
        yield
    finally:
        verifier.max_sigs, verifier.max_wait = saved


def _sockets() -> int:
    """The process's open sockets (−1 where /proc is not there)."""
    try:
        fds = os.listdir("/proc/self/fd")
    except OSError:
        return -1
    n = 0
    for fd in fds:
        try:
            n += os.readlink(f"/proc/self/fd/{fd}").startswith("socket:")
        except OSError:
            pass  # the listing's own descriptor, closed since
    return n


def primitive_us(reps: int = 20) -> dict:
    """Host µs of each primitive the transport and discovery run."""
    from . import native
    from .network import crypto

    key, nonce, frame = bytes(range(32)), bytes(12), bytes(1024)
    ex = crypto._expand(key)
    sig = crypto.ed25519_sign(key, b"transcript", ex)
    pub = crypto.x25519_public(key)
    cases = {
        "ed25519_sign": lambda: crypto.ed25519_sign(key, b"transcript", ex),
        "ed25519_verify": lambda: crypto.ed25519_verify(ex[2], sig, b"transcript"),
        "x25519": lambda: crypto.x25519(key, pub),
        "hkdf_sha256": lambda: crypto.hkdf_sha256(key, b"salt", b"i2r"),
        "aead_seal_1KiB": lambda: native.aead_seal(key, nonce, frame),
        "snappy_compress_1KiB": lambda: native.snappy_compress(frame),
    }
    out = {}
    for name, fn in cases.items():
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[name] = (time.perf_counter() - t0) / reps * 1e6
    return out


def run(verifier, *, scenario, chain_out, observer=None, probe=None, sync=None,
        peers: int = PEERS, threads: int = VALIDATION_THREADS, log=print) -> dict:
    """Steps (a)–(e) of the module's docstring through `verifier` (the
    stack's lane dispatcher, or any `IBlsVerifier`) on `scenario` and
    `chain_out` (`profile_chain.run(..., keep=True)`'s result, whose chain
    this closes). Returns the records by step ("steps") with their
    seconds, what each moved in `observer`'s and `probe()`'s counts and
    the kernels' launches, the verifier's calls whose verdicts differ from
    the host tier's, and every failed check ("failures")."""
    threads_before = {t.ident for t in threading.enumerate()}
    sockets_before = _sockets()
    out = {"peers": peers, "validators": scenario["validators"], "steps": {}, "failures": []}
    try:
        asyncio.run(asyncio.wait_for(
            _run(verifier, scenario, chain_out, observer, probe, sync, peers, threads, out),
            5 * WAIT_S))
    except Exception as e:  # noqa: BLE001 — a failed phase is reported, not raised
        out["failures"].append(f"run: {type(e).__name__}: {e}")
    finally:
        chain_out["chain"].close()
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        left = [t.name for t in threading.enumerate()
                if t.ident not in threads_before and t.is_alive()]
        if not left:
            break
        time.sleep(0.05)
    out["threads_left"] = left
    out["sockets"] = [sockets_before, _sockets()]
    if left:
        out["failures"].append(f"threads left: {left}")
    if out["sockets"][1] > out["sockets"][0]:
        out["failures"].append(f"sockets left: {out['sockets']}")
    return out


async def _wait_for(cond, timeout_s: float, step_s: float = 0.01) -> bool:
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            return False
        await asyncio.sleep(step_s)
    return True


async def _run(verifier, scenario, chain_out, observer, probe, sync, peers, threads, out):
    from .chain.chain import BeaconChain
    from .chain.clock import ManualClock
    from .config.beacon_config import compute_signing_root
    from .network.gossip.encoding import compute_msg_id, encode_message
    from .network.gossip.gossipsub import Gossipsub, GossipsubService
    from .network.gossip.score import PeerScore
    from .network.gossip.topic import GossipTopic, GossipType, stringify_topic
    from .network.network import Network
    from .network.transport import NodeIdentity, Transport
    from .params import DOMAIN_BEACON_ATTESTER
    from .types import get_types
    from .bls.api import DST_G2, interop_secret_key
    from . import native

    loop = asyncio.get_running_loop()
    loop.set_default_executor(ThreadPoolExecutor(threads, thread_name_prefix="network-validate"))
    config, genesis, p = scenario["config"], scenario["genesis"], scenario["preset"]
    p_chain, gossip = chain_out["chain"], chain_out["gossip"]
    slot, spe = gossip["slot"], p.SLOTS_PER_EPOCH
    steps, failures = out["steps"], out["failures"]

    def expect(cond, what):
        if not cond:
            failures.append(what)

    types = node_types(config)
    digest = config.fork_digest(config.get_fork_name_at_slot(slot))
    recorder = profile_chain.RecordingVerifier(verifier)
    r_chain = BeaconChain(config, get_types(p).phase0, genesis.state, verifier=recorder,
                          clock=ManualClock(genesis.state.genesis_time,
                                            config.SECONDS_PER_SLOT, spe))
    p_net = Network(config, types, p_chain, identity=NodeIdentity.from_seed(b"P"),
                    metrics=Counters())
    r_metrics = Counters()
    r_net = Network(config, types, r_chain, identity=NodeIdentity.from_seed(b"R"),
                    subscribe_all_subnets=True, metrics=r_metrics)
    clock = ManualTime(time.monotonic())
    for obj in (r_net.gossip, r_net.gossip.score, r_net.gossip.seen):
        obj._time = clock
    r_net.gossip._last_decay = clock()
    # what R's router validated: message id -> (result, seconds)
    validated: dict[bytes, tuple[str, float]] = {}
    inner = r_net.gossip.validators["/eth2/"]

    async def tap(topic, data):
        res = await inner(topic, data)
        validated[compute_msg_id(topic, data)] = (res.value, time.perf_counter())
        return res

    r_net.gossip.validators["/eth2/"] = tap
    qs: list = []
    step = lambda: profile_chain._Step(observer, probe, sync)  # noqa: E731
    try:
        # (a) discovery, the handshakes and status
        with step() as rec:
            t0 = time.perf_counter()
            await p_net.start(discovery=True)
            for topic in sorted(p_net.gossip.subscriptions):
                await p_net.gossip.unsubscribe(topic)
            r_chain.clock.set_slot(slot)
            r_addr = await r_net.start(discovery=True, bootnodes=[p_net.discovery.local_enr])
            found = await _wait_for(lambda: p_net.peer_id in r_net.transport.connections
                                    and getattr(r_net.peer_manager.peers.get(p_net.peer_id),
                                                "status", None) is not None, 30.0)
            rec["discover_dial_status_s"] = time.perf_counter() - t0
            expect(found, "discovery: R did not find, dial and status P")
            rec["discovered"] = [e.node_id for e in r_net.discovery.table.all()]
            expect(p_net.peer_id in rec["discovered"], "discovery: P is not in R's table")
            status = r_net.peer_manager.peers[p_net.peer_id].status if found else None
            rec["status_head_slot"] = int(status.head_slot) if status is not None else None
            expect(rec["status_head_slot"] == p_chain.head_state.state.slot,
                   f"status: P's head slot {rec['status_head_slot']}")
            dials = []
            for i in range(peers):
                t = Transport(NodeIdentity.from_seed(f"Q{i + 1}".encode()))
                svc = GossipsubService(t, Gossipsub())
                t1 = time.perf_counter()
                await t.dial(*r_addr)
                dials.append(time.perf_counter() - t1)
                qs.append(svc)
            att_topic = stringify_topic(GossipTopic(GossipType.beacon_attestation, digest,
                                                    gossip["subnets"][0]))
            ready = await _wait_for(lambda: all(
                att_topic in getattr(q.router.peers.get(r_net.peer_id), "topics", ())
                for q in qs) and len(r_net.gossip.peers) == peers + 1, 30.0)
            expect(ready, "connect: not every peer knows R's topics")
            rec.update(dials=len(dials), dial_p50_ms=profile_chain._pct(dials, 0.5) * 1e3,
                       dial_max_ms=max(dials) * 1e3, primitive_us=primitive_us(),
                       connections=len(r_net.transport.connections))
        steps["connect"] = rec

        # (b) range sync from P
        blocks_at = [b.message.hash_tree_root() for b in scenario["phase0"]] \
            + [gossip["block_root"]]
        with step() as rec:
            t0 = time.perf_counter()
            got = await r_net.reqresp.beacon_blocks_by_range(p_net.peer_id, 1, slot)
            rec["request_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            roots = await loop.run_in_executor(None, r_chain.process_block_segment, got)
            rec["segment_s"] = time.perf_counter() - t0
        rec.update(profile_chain._trace_breakdown(_tracer(), "chain/process_segment"))
        calls = recorder.take()
        rec.update(blocks=[int(b.message.slot) for b in got],
                   sets=sum(len(c["sets"]) for c in calls), verdicts=len(calls),
                   call_sets=[len(c["sets"]) for c in calls],
                   host_mismatches=profile_chain.host_mismatches(calls))
        steps["range_sync"] = rec
        expect([b.message.hash_tree_root() for b in got] == blocks_at and roots == blocks_at,
               f"range sync: blocks at slots {rec['blocks']}")
        expect(r_chain.head_root == gossip["block_root"], "range sync: R's head is not P's block")
        expect(len(calls) == 1 and calls[0]["verdicts"] == [True],
               f"range sync: verdicts {[c['verdicts'] for c in calls]}")

        # what R's router should have seen from each peer: a PeerScore fed
        # the same deliveries and REJECTs
        want_score = PeerScore(r_net.gossip.score.params, clock)
        for q in qs:
            want_score.add_peer(q.transport.peer_id)

        async def flood(plan, name):
            """plan: per peer, [(topic, wire, expected action)] in order."""
            sent: dict[bytes, tuple[str, float]] = {}
            before = set(validated)

            async def one(q, msgs):
                for topic, wire, action in msgs:
                    mid = compute_msg_id(topic, wire)
                    sent[mid] = (action, time.perf_counter())
                    n = await q.router.publish(topic, wire)
                    expect(n == 1, f"{name}: a publish reached {n} peers")
                    want_score.deliver_message(q.transport.peer_id, topic, first=True)
                    if action == "REJECT":
                        want_score.reject_message(q.transport.peer_id, topic)

            t0 = time.perf_counter()
            await asyncio.gather(*(one(q, msgs) for q, msgs in zip(qs, plan)))
            done = await _wait_for(lambda: all(m in validated for m in sent), WAIT_S, 0.05)
            expect(done, f"{name}: {sum(m in validated for m in sent)} of {len(sent)} validated")
            ends = [validated[m][1] for m in sent if m in validated]
            makespan = (max(ends) if ends else time.perf_counter()) - t0
            flat = [{"want": [a, ""], "got": [validated.get(m, ("none",))[0], ""]}
                    for m, (a, _) in sent.items()]
            lats = [validated[m][1] - t for m, (_, t) in sent.items() if m in validated]
            expect(set(validated) - before == set(sent),
                   f"{name}: R validated {len(set(validated) - before)} new messages for "
                   f"{len(sent)} sent")
            return flat, lats, makespan

        def spread(tasks, topic_of, seed):
            """Round-robin over the peers, each task's messages in order."""
            tasks = list(tasks)
            random.Random(seed).shuffle(tasks)
            plan = [[] for _ in qs]
            for k, task in enumerate(tasks):
                plan[k % len(qs)].extend(
                    (topic_of(m, args), encode_message(m.serialize()), a)
                    for m, a, _, args in task)
            return plan

        def cohort(gtype, sets_per_message):
            """The sets in flight in a round of a flood on `gtype`'s topics."""
            conc = r_net.gossip_handlers.queues[gtype].max_concurrency
            return min(len(qs), conc) * sets_per_message

        def check_scores(name):
            got = {q.transport.peer_id: r_net.gossip.score.score(q.transport.peer_id)
                   for q in qs}
            want = {pid: want_score.score(pid) for pid in got}
            bad = {pid[:8]: (got[pid], want[pid]) for pid in got
                   if abs(got[pid] - want[pid]) > 1e-9 * max(1.0, abs(want[pid]))}
            expect(not bad, f"{name}: scores on R differ from score.py's: {bad}")
            return sorted(set(round(v, 6) for v in got.values()))

        # (c) the attestations, with the second vote and, after, the replay
        replay = None
        tasks = []
        for _, task in gossip["attestations"]:
            if task[-1][1] == "IGNORE":
                replay, task = task[-1], task[:-1]
            tasks.append(task)
        lone = next(t for t in tasks if len(t) == 1 and t[0][1] == "ACCEPT")
        att = lone[0][0]
        second = att.copy()
        second.data.beacon_block_root = bytes(p_chain.blocks[gossip["block_root"]]
                                              .message.parent_root)
        v = int(r_chain.head_state.epoch_ctx.get_beacon_committee(
            slot, int(att.data.index))[list(att.aggregation_bits).index(True)])
        root = compute_signing_root(second.data.hash_tree_root(), config.get_domain(
            DOMAIN_BEACON_ATTESTER, slot, slot // spe))
        rc, second.signature = native.sign(interop_secret_key(v).to_bytes(), root, DST_G2)
        expect(rc == 0, f"attestations: the host tier failed to sign the second vote ({rc})")
        lone.append((second, "IGNORE", "already seen", lone[0][3]))

        def att_topic_of(m, args):
            return stringify_topic(GossipTopic(GossipType.beacon_attestation, digest, args[0]))

        plan = spread(tasks, att_topic_of, SEED)
        with step() as rec:
            t0 = time.perf_counter()
            r_chain.regen.get_checkpoint_state(slot // spe, bytes(att.data.target.root))
            rec["checkpoint_regen_s"] = time.perf_counter() - t0
            with profile_chain._BatchSpy(verifier) as spy, \
                    _cohort_flush(verifier, cohort(GossipType.beacon_attestation, 1)):
                flat, lats, makespan = await flood(plan, "attestations")
            # the replay, byte for byte, from another peer than its sender
            owner = next(k for k, msgs in enumerate(plan)
                         if any(w == encode_message(replay[0].serialize()) for _, w, _ in msgs))
            q = qs[(owner + 1) % len(qs)]
            dups = r_metrics.gossip_duplicates_total.total()
            topic = att_topic_of(replay[0], replay[3])
            wire = encode_message(replay[0].serialize())
            n = await q.router.publish(topic, wire)
            want_score.deliver_message(q.transport.peer_id, topic, first=False)
            counted = await _wait_for(
                lambda: r_metrics.gossip_duplicates_total.total() == dups + 1, 30.0)
            rec["replay"] = {"published_to": n, "duplicates": r_metrics
                             .gossip_duplicates_total.total() - dups}
            expect(counted and n == 1, f"attestations: the replay {rec['replay']}")
        calls = recorder.take()
        profile_chain._flood_record(rec, flat, lats, makespan, spy)
        rec.update(_batch_jobs(spy), sets=sum(len(c["sets"]) for c in calls),
                   verdicts=len(calls), lanes=sorted({str(c["lane"]) for c in calls}),
                   host_mismatches=profile_chain.host_mismatches(calls),
                   validated=len(flat), scores=check_scores("attestations"))
        steps["attestations"] = rec
        expect(not rec["unexpected"], f"attestations: unexpected {rec['unexpected'][:4]}")
        expect(rec["lanes"] == ["attestation"], f"attestations: lanes {rec['lanes']}")

        # (d) the aggregates
        def agg_topic_of(m, args):
            return stringify_topic(GossipTopic(GossipType.beacon_aggregate_and_proof, digest))

        plan = spread([t for _, t in gossip["aggregates"]], agg_topic_of, SEED + 1)
        with step() as rec:
            with profile_chain._BatchSpy(verifier) as spy, \
                    _cohort_flush(verifier, cohort(GossipType.beacon_aggregate_and_proof, 3)):
                flat, lats, makespan = await flood(plan, "aggregates")
            r_chain.update_head()
        calls = recorder.take()
        profile_chain._flood_record(rec, flat, lats, makespan, spy)
        rec.update(_batch_jobs(spy), sets=sum(len(c["sets"]) for c in calls),
                   verdicts=len(calls), lanes=sorted({str(c["lane"]) for c in calls}),
                   host_mismatches=profile_chain.host_mismatches(calls),
                   validated=len(flat), scores=check_scores("aggregates"))
        steps["aggregates"] = rec
        expect(not rec["unexpected"], f"aggregates: unexpected {rec['unexpected'][:4]}")
        expect(rec["lanes"] == ["aggregate"], f"aggregates: lanes {rec['lanes']}")
        expect(r_chain.head_root == gossip["block_root"], "aggregates: R's head moved")

        # (e) the produced block, from Q1, a slot later
        produced = gossip["produced"]
        root = produced.message.hash_tree_root()
        topic = stringify_topic(GossipTopic(GossipType.beacon_block, digest))
        r_chain.clock.set_slot(slot + 1)
        with step() as rec:
            t0 = time.perf_counter()
            wire = encode_message(produced.serialize())
            await qs[0].router.publish(topic, wire)
            want_score.deliver_message(qs[0].transport.peer_id, topic, first=True)
            mid = compute_msg_id(topic, wire)
            ok = await _wait_for(lambda: mid in validated and r_chain.head_root == root, 120.0)
            rec["gossip"] = validated.get(mid, ("none",))[0]
            rec["to_head_s"] = time.perf_counter() - t0
        rec.update(profile_chain._trace_breakdown(_tracer(), "chain/process_block"))
        calls = recorder.take()
        fc_r, fc_p = r_chain.fork_choice, p_chain.fork_choice
        weight = [int(fc.proto.weights[fc.proto.indices[root]]) if root in fc.proto.indices
                  else None for fc in (fc_r, fc_p)]
        rec.update(slot=slot + 1, weight=weight, call_sets=[len(c["sets"]) for c in calls],
                   sets=sum(len(c["sets"]) for c in calls), verdicts=len(calls),
                   host_mismatches=profile_chain.host_mismatches(calls),
                   scores=check_scores("block"))
        steps["block"] = rec
        expect(ok and rec["gossip"] == "ACCEPT", f"block: {rec['gossip']}, head "
               f"{r_chain.head_root == root}")
        expect(r_chain.head_root == p_chain.head_root == root and weight[0] == weight[1],
               f"block: R's head and weight {weight[0]} are not P's ({weight[1]})")
        for name, r in steps.items():
            if r.get("host_mismatches"):
                failures.append(f"{name}: verdicts differ from the host tier's: "
                                f"{r['host_mismatches'][:2]}")
        out["head"] = r_chain.head_root.hex()
        out["rx"] = r_metrics.by_label("gossip_rx_total", "outcome")
        out["duplicates"] = r_metrics.gossip_duplicates_total.total()
    finally:
        for q in qs:
            await q.router.stop()
            await q.transport.close()
        await r_net.stop()
        await p_net.stop()
        r_chain.close()
        await asyncio.sleep(0)
    left = [len(n.transport.connections) for n in (p_net, r_net)] \
        + [len(q.transport.connections) for q in qs]
    expect(not any(left), f"connections left open: {left}")


def _tracer():
    from .observability import spans

    return spans.tracer


def _batch_jobs(spy) -> dict:
    """The coalesced batches' set counts: each is one batch verdict, and
    each that failed ("failed_batch_sets") one per-set pass."""
    return {"batch_sets": [n for n, _ in spy.batches], "failed_batch_sets": list(spy.failed)}


def log_steps(out: dict, log=print) -> None:
    """One line per step of `run`'s record."""
    def common(r):
        return (f"paths {json.dumps(r.get('paths', {}))}, epoch table "
                f"{json.dumps(r.get('epoch_table', {}))}, supervisor "
                f"{json.dumps(r.get('supervisor', {}))}, launches {json.dumps(r['launches'])}")

    s = out["steps"]
    if "connect" in s:
        r = s["connect"]
        log(f"[network] connect: {r['seconds']:.3f} s (discovery, dial and status "
            f"{r['discover_dial_status_s']:.3f} s; {r['dials']} peers dialled R, dial p50 "
            f"{r['dial_p50_ms']:.1f} max {r['dial_max_ms']:.1f} ms; host us "
            + ", ".join(f"{k} {v:.1f}" for k, v in r["primitive_us"].items()) + ")")
    if "range_sync" in s:
        r = s["range_sync"]
        spans = ", ".join(f"{k[:-2]} {r[k]:.3f} s" for k in (
            "pre_state_s", "bls_verify_s", "state_transition_s", "fork_choice_s", "import_s",
            "head_update_s") if k in r)
        log(f"[network] range sync: {r['seconds']:.3f} s, blocks at slots {r['blocks']} "
            f"(request {r['request_s']:.3f} s, process_block_segment {r['segment_s']:.3f} s: "
            f"{spans}), {r['sets']} sets in {r['verdicts']} verdicts; {common(r)}")
    for name in ("attestations", "aggregates"):
        if name in s:
            r = s[name]
            log(f"[network] {name}: {r['calls']} validated, makespan {r['makespan_s']:.3f} s, "
                f"{r['validations_per_s']:.1f} validations/s, publish to result p50 "
                f"{r['latency_p50_s']:.4f} p99 {r['latency_p99_s']:.4f} max "
                f"{r['latency_max_s']:.4f} s, actions {json.dumps(r['actions'])}, "
                f"{r['batches']} coalesced batches (sizes {r['batch_sizes']}, "
                f"{r['batch_reasons']}), {r['sets']} sets in {r['verdicts']} verdicts"
                + (f", replay {json.dumps(r['replay'])}" if "replay" in r else "")
                + (f", first checkpoint-state regen {r['checkpoint_regen_s']:.3f} s"
                   if "checkpoint_regen_s" in r else "")
                + f", peer scores {r['scores']}; {common(r)}")
    if "block" in s:
        r = s["block"]
        log(f"[network] block slot {r['slot']}: {r['seconds']:.3f} s, gossip {r['gossip']}, "
            f"to head {r['to_head_s']:.3f} s, weight on R and P {r['weight']}, {r['sets']} sets "
            f"in {r['verdicts']} verdicts; {common(r)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--validators", type=int, default=16384)
    ap.add_argument("--blocks", type=int, default=3, help="phase0 blocks at slots 1..N")
    ap.add_argument("--peers", type=int, default=PEERS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--preset", choices=("mainnet", "minimal"), default="mainnet")
    ap.add_argument("--verifier", choices=("stack", "host"), default="stack",
                    help="the serving stack on --device, or the C host tier alone")
    ap.add_argument("--out", default="build/lodestar_tpu_torch/profile_network.json")
    args = ap.parse_args(argv)

    import torch

    from .chain.bls_verifier import CpuBlsVerifier
    from .native import install_ssz_backend
    from .node.bls_stack import build_bls_stack
    from .params import MAINNET, MINIMAL

    install_ssz_backend()
    preset = MINIMAL if args.preset == "minimal" else MAINNET
    swap = (1, 3) if args.preset == "minimal" else (5, 77)
    scenario = profile_block.make_scenario(validators=args.validators, blocks=args.blocks,
                                           preset=preset, swap=swap)
    stack = None
    if args.verifier == "host":
        verifier, observer, sync = CpuBlsVerifier(), None, None
    else:
        stack = build_bls_stack(device=args.device,
                                dispatcher_args={"workers": 1, "max_sigs": 64})
        cuda = str(stack.device.device).startswith("cuda")
        keys = [bytes(pk) for pk in scenario["genesis"].flat.pubkeys]
        profile_block.stack_populate(stack)(scenario["config"].ALTAIR_FORK_EPOCH, keys)
        verifier, observer = stack.verifier, stack.pipeline
        sync = torch.cuda.synchronize if cuda else None
    try:
        chain_out = profile_chain.run(verifier, scenario=scenario, observer=observer, sync=sync,
                                      flood_committees=1, keep=True)
        profile_chain.log_steps(chain_out)
        if "gossip" not in chain_out:
            chain_out.get("chain") and chain_out["chain"].close()
            out = {"failures": ["chain: " + "; ".join(chain_out["failures"])], "steps": {}}
        else:
            out = run(verifier, scenario=scenario, chain_out=chain_out, observer=observer,
                      sync=sync, peers=args.peers)
            out["failures"] = chain_out["failures"] + out["failures"]
    finally:
        if stack is not None:
            stack.close()
    log_steps(out)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(json.dumps(out, default=str), flush=True)
    return 0 if not out["failures"] else 1


if __name__ == "__main__":
    raise SystemExit(main())

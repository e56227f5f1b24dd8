"""The network's codecs and bookkeeping, held byte for byte to the JAX
package on seeded inputs: the snappy block codec (`native`), xxh64,
CRC32C and the snappy frames, gossip topics and both message ids, the
gossipsub RPC encoding, the req/resp chunks and error codes, the subnet
services over seeded node ids, the gossip score (`score.py`) and the peer
score over scripted sequences on a fake clock, and the job queue."""

import asyncio
import random

import pytest

from lodestar_tpu import native as jnative
from lodestar_tpu.network import peers as jpeers
from lodestar_tpu.network import subnets as jsubnets
from lodestar_tpu.network.gossip import encoding as jenc
from lodestar_tpu.network.gossip import rpc as jrpc
from lodestar_tpu.network.gossip import score as jscore
from lodestar_tpu.network.gossip import topic as jtopic
from lodestar_tpu.network.reqresp import codec as jcodec
from lodestar_tpu.network.reqresp import protocols as jprot
from lodestar_tpu.network.reqresp import snappy_frames as jframes
from lodestar_tpu.utils import queue as jqueue
from lodestar_tpu_torch import native
from lodestar_tpu_torch.network import peers, subnets
from lodestar_tpu_torch.network.gossip import encoding, rpc, score, topic
from lodestar_tpu_torch.network.reqresp import codec, protocols, snappy_frames
from lodestar_tpu_torch.utils import queue


def _payloads(seed: int):
    rng = random.Random(seed)
    out = [b"", b"a", bytes(15), bytes(16), b"ab" * 40]
    for n in (100, 1000, 65_535, 65_536, 65_537, 200_000):
        # compressible runs and random bytes mixed, as SSZ is
        out.append(bytes(rng.getrandbits(8) if rng.random() < 0.4 else 0 for _ in range(n)))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_snappy_block_codec_equals_the_jax_native(seed):
    for data in _payloads(seed):
        wire = native.snappy_compress(data)
        assert wire == jnative.snappy_compress(data)
        assert native.snappy_uncompress(wire) == data
        assert jnative.snappy_uncompress(wire) == data


def test_snappy_refuses_a_corrupt_stream():
    wire = native.snappy_compress(b"hello world" * 20)
    for bad in (wire[:-1], b"\xff\xff\xff\xff\xff\xff", b"\x05\x00", wire[:1] + b"\xfe" + wire[2:]):
        with pytest.raises(ValueError):
            native.snappy_uncompress(bad)
        with pytest.raises(ValueError):
            jnative.snappy_uncompress(bad)


@pytest.mark.parametrize("seed", range(3))
def test_xxh64_crc32c_and_frames_equal_the_jax_package(seed):
    rng = random.Random(seed)
    for data in _payloads(seed):
        s = rng.getrandbits(64)
        assert native.xxh64(data) == jnative.xxh64(data)
        assert native.xxh64(data, s) == jnative.xxh64(data, s)
        assert snappy_frames.crc32c(data) == jframes.crc32c(data)
        frames = snappy_frames.compress_frames(data)
        assert frames == jframes.compress_frames(data)
        assert snappy_frames.decompress_frames(frames) == data
    # the CRC32C check value of "123456789"
    assert snappy_frames.crc32c(b"123456789") == 0xE3069283
    frames = bytearray(snappy_frames.compress_frames(b"x" * 1000))
    frames[len(snappy_frames.STREAM_IDENTIFIER) + 4] ^= 1  # the frame's checksum
    with pytest.raises(ValueError):
        snappy_frames.decompress_frames(bytes(frames))
    with pytest.raises(ValueError):
        jframes.decompress_frames(bytes(frames))


@pytest.mark.parametrize("seed", range(3))
def test_topics_and_message_ids_equal_the_jax_package(seed):
    rng = random.Random(seed)
    digest = bytes(rng.getrandbits(8) for _ in range(4))
    for t in topic.GossipType:
        subnet = rng.randrange(64) if t in topic.SUBNET_TYPES else None
        s = topic.stringify_topic(topic.GossipTopic(t, digest, subnet))
        assert s == jtopic.stringify_topic(jtopic.GossipTopic(jtopic.GossipType(t.value),
                                                              digest, subnet))
        parsed = topic.parse_topic(s)
        assert (parsed.type.value, parsed.fork_digest, parsed.subnet) == (t.value, digest, subnet)
        for data in _payloads(seed)[:8]:
            wire = encoding.encode_message(data)
            assert wire == jenc.encode_message(data)
            assert encoding.decode_message(wire) == data
            assert encoding.compute_msg_id(s, wire) == jenc.compute_msg_id(s, wire)
            assert encoding.fast_msg_id(wire) == jenc.fast_msg_id(wire)
            # an undecodable payload takes the invalid-snappy domain
            junk = b"\xff" + data
            assert encoding.compute_msg_id(s, junk) == jenc.compute_msg_id(s, junk)
    for bad in ("/eth2/00/beacon_block", "/eth3/00000000/beacon_block/ssz_snappy",
                "/eth2/00000000/nope/ssz_snappy"):
        with pytest.raises(ValueError):
            topic.parse_topic(bad)
    assert topic.parse_topic("/eth2/00000000/sync_committee_contribution_and_proof/ssz_snappy") \
        .subnet is None


def _rpcs(seed: int):
    rng = random.Random(seed)

    def rb(n):
        return bytes(rng.getrandbits(8) for _ in range(n))

    return [
        dict(subscriptions=[(True, "/eth2/aa/t1/ssz_snappy"), (False, "/eth2/aa/t2/ssz_snappy")]),
        dict(messages=[("/eth2/aa/beacon_block/ssz_snappy", rb(300)), ("t", b"")]),
        dict(ihave=[("t1", [rb(20) for _ in range(5)]), ("t2", [])], iwant=[rb(20), rb(20)]),
        dict(graft=["t1", "t2"], prune=[("t3", 60), ("t4", 0), ("t5", 300)]),
        dict(subscriptions=[(True, "x")], messages=[("y", rb(5000))], graft=["z"],
             prune=[("w", 7)], ihave=[("v", [rb(20)])], iwant=[rb(20)]),
    ]


def _build(mod, spec):
    return mod.RPC(
        subscriptions=list(spec.get("subscriptions", [])),
        messages=list(spec.get("messages", [])),
        ihave=[mod.ControlIHave(t, ids) for t, ids in spec.get("ihave", [])],
        iwant=list(spec.get("iwant", [])),
        graft=list(spec.get("graft", [])),
        prune=[mod.ControlPrune(t, b) for t, b in spec.get("prune", [])],
    )


@pytest.mark.parametrize("seed", range(2))
def test_gossip_rpc_encoding_equals_the_jax_package(seed):
    for spec in _rpcs(seed):
        ours, theirs = _build(rpc, spec), _build(jrpc, spec)
        wire = rpc.encode_rpc(ours)
        assert wire == jrpc.encode_rpc(theirs)
        back, jback = rpc.decode_rpc(wire), jrpc.decode_rpc(wire)
        assert back.subscriptions == jback.subscriptions == ours.subscriptions
        assert back.messages == jback.messages == ours.messages
        assert [(i.topic, i.msg_ids) for i in back.ihave] == \
            [(i.topic, i.msg_ids) for i in jback.ihave]
        assert back.iwant == jback.iwant and back.graft == jback.graft
        assert [(p.topic, p.backoff_sec) for p in back.prune] == \
            [(p.topic, p.backoff_sec) for p in jback.prune]
    for bad in (b"\x09", b"\x01\x05ab", b"\x03\xff\xff\xff\xff\xff\x01"):
        with pytest.raises(ValueError):
            rpc.decode_rpc(bad)
        with pytest.raises(ValueError):
            jrpc.decode_rpc(bad)


@pytest.mark.parametrize("seed", range(2))
def test_reqresp_chunks_and_error_codes_equal_the_jax_package(seed):
    payloads = _payloads(seed)[:9]
    for data in payloads:
        assert codec.encode_request(data) == jcodec.encode_request(data)
        assert codec.decode_request(codec.encode_request(data)) == data
    stream, jstream = b"", b""
    for k, data in enumerate(payloads):
        stream += codec.encode_response_chunk(data)
        jstream += jcodec.encode_response_chunk(data)
    for rc in codec.RespCode:
        if rc:
            stream += codec.encode_error_chunk(rc, f"error {rc.name} " * 30)
            jstream += jcodec.encode_error_chunk(jcodec.RespCode(int(rc)), f"error {rc.name} " * 30)
    assert stream == jstream
    ours, theirs = codec.decode_response_chunks(stream), jcodec.decode_response_chunks(stream)
    assert [(int(c), p) for c, p in ours] == [(int(c), p) for c, p in theirs]
    assert [p for c, p in ours if c == codec.RespCode.SUCCESS] == payloads
    assert [int(c) for c in codec.RespCode] == [int(c) for c in jcodec.RespCode]
    with pytest.raises(ValueError):
        codec.decode_request(codec.encode_request(b"abc")[:-1])
    for p in protocols.PROTOCOLS:
        pid = protocols.protocol_id(p.protocol, p.version)
        assert pid == jprot.protocol_id(jprot.Protocol(p.protocol.value), p.version)
        assert protocols.parse_protocol_id(pid) == (p.protocol, p.version)
    assert [(p.protocol.value, p.version, p.has_request, p.multiple_responses)
            for p in protocols.PROTOCOLS] == \
        [(p.protocol.value, p.version, p.has_request, p.multiple_responses)
         for p in jprot.PROTOCOLS]


@pytest.mark.parametrize("seed", range(4))
def test_subnets_equal_the_jax_package_over_seeded_node_ids(seed):
    rng = random.Random(seed)
    node_id = bytes(rng.getrandbits(8) for _ in range(20))
    ours, theirs = subnets.AttnetsService(node_id, 32), jsubnets.AttnetsService(node_id, 32)
    for epoch, validators in ((0, 1), (255, 3), (256, 8), (1000, 0), (70_000, 2)):
        for s in (ours, theirs):
            s.rotate(epoch, validators)
            s.subscribe_committee(rng.randrange(64) if s is ours else ours.short_lived[-1].subnet,
                                  epoch + 2)
        assert [(x.subnet, x.until_epoch) for x in ours.long_lived] == \
            [(x.subnet, x.until_epoch) for x in theirs.long_lived]
        assert ours.active_subnets(epoch) == theirs.active_subnets(epoch)
        assert ours.enr_attnets(epoch) == theirs.enr_attnets(epoch)
    sy, jsy = subnets.SyncnetsService(32), jsubnets.SyncnetsService(32)
    for s in (sy, jsy):
        s.subscribe_committee_member(1, 10)
        s.subscribe_committee_member(3, 5)
        s.prune(6)
    assert sy.active_subnets(6) == jsy.active_subnets(6) == {1}
    assert sy.enr_syncnets(6) == jsy.enr_syncnets(6)


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _script(seed: int):
    rng = random.Random(seed)
    peer_ids = [f"peer{i}" for i in range(5)]
    topics = ["/eth2/aa/beacon_block/ssz_snappy", "/eth2/aa/beacon_attestation_3/ssz_snappy",
              "/eth2/aa/beacon_aggregate_and_proof/ssz_snappy", "/eth2/aa/unknown/ssz_snappy"]
    ops = []
    for _ in range(300):
        op = rng.choice(["deliver", "deliver", "reject", "graft", "prune", "penalty", "tick",
                         "decay", "app", "remove", "add"])
        ops.append((op, rng.choice(peer_ids), rng.choice(topics), rng.random()))
    return peer_ids, topics, ops


@pytest.mark.parametrize("seed", range(3))
def test_gossip_score_equals_the_jax_package_on_a_script(seed):
    peer_ids, topics, ops = _script(seed)
    clocks = FakeClock(), FakeClock()

    def params(mod):
        p = mod.PeerScoreParams()
        for t in topics[:3]:
            kind = t.split("/")[3]
            p.topics[t] = mod.ethereum_topic_params(
                "beacon_attestation" if kind.startswith("beacon_attestation") else kind)
        p.topics[topics[0]].mesh_message_deliveries_weight = -1.0
        p.topics[topics[0]].mesh_failure_penalty_weight = -2.0
        return p

    ours = score.PeerScore(params(score), clocks[0])
    theirs = jscore.PeerScore(params(jscore), clocks[1])
    for pid in peer_ids:
        ours.add_peer(pid, "10.0.0.1" if pid < "peer3" else None)
        theirs.add_peer(pid, "10.0.0.1" if pid < "peer3" else None)
    for op, pid, t, x in ops:
        for s in (ours, theirs):
            if op == "deliver":
                s.deliver_message(pid, t, first=x < 0.7)
            elif op == "reject":
                s.reject_message(pid, t)
            elif op == "graft":
                s.graft(pid, t)
            elif op == "prune":
                s.prune(pid, t)
            elif op == "penalty":
                s.add_behaviour_penalty(pid, 1 + x)
            elif op == "decay":
                s.decay()
            elif op == "app":
                s.set_app_score(pid, x * 10 - 5)
            elif op == "remove":
                s.remove_peer(pid)
            elif op == "add":
                s.add_peer(pid, None)
        if op == "tick":
            for c in clocks:
                c.t += 20 * x
        assert [ours.score(p) for p in peer_ids] == [theirs.score(p) for p in peer_ids]
    assert (score.GOSSIP_THRESHOLD, score.PUBLISH_THRESHOLD, score.GRAYLIST_THRESHOLD) == \
        (jscore.GOSSIP_THRESHOLD, jscore.PUBLISH_THRESHOLD, jscore.GRAYLIST_THRESHOLD)


@pytest.mark.parametrize("seed", range(2))
def test_peer_scores_and_manager_equal_the_jax_package(seed):
    rng = random.Random(seed)
    clocks = FakeClock(), FakeClock()
    ours, theirs = peers.PeerManager(target_peers=4, time_fn=clocks[0]), \
        jpeers.PeerManager(target_peers=4, time_fn=clocks[1])
    actions = list(peers.PeerAction)
    for step in range(200):
        pid = f"p{rng.randrange(8)}"
        r = rng.random()
        if r < 0.3:
            got = (ours.on_connect(pid), theirs.on_connect(pid))
            assert got[0] == got[1]
        elif r < 0.7:
            a = rng.choice(actions)
            ours.report_peer(pid, a)
            theirs.report_peer(pid, jpeers.PeerAction(a.value))
        elif r < 0.8:
            dt = rng.random() * 600
            for c in clocks:
                c.t += dt
        else:
            assert ours.heartbeat() == theirs.heartbeat()
        assert sorted(ours.peers) == sorted(theirs.peers)
        assert [ours.scores.score(f"p{i}") for i in range(8)] == \
            [theirs.scores.score(f"p{i}") for i in range(8)]
        assert [ours.scores.state(f"p{i}").value for i in range(8)] == \
            [theirs.scores.state(f"p{i}").value for i in range(8)]


@pytest.mark.parametrize("kind", ["FIFO", "LIFO"])
def test_job_queue_equals_the_jax_package(kind):
    """Order of processing, the drop on overflow (the oldest pending for
    LIFO, the new item for FIFO) and close, in both packages."""

    async def drive(mod):
        order, gate = [], asyncio.Event()

        async def process(x):
            await gate.wait()
            order.append(x)
            return x * 2

        q = mod.JobItemQueue(process, max_length=3, max_concurrency=1,
                             queue_type=mod.QueueType(kind))
        futs = [asyncio.ensure_future(q.push(i)) for i in range(6)]
        await asyncio.sleep(0)
        await asyncio.sleep(0)
        gate.set()
        results = []
        for f in futs:
            try:
                results.append(await f)
            except Exception as e:  # noqa: BLE001
                results.append(type(e).__name__)
        q.close()
        try:
            await q.push(9)
        except Exception as e:  # noqa: BLE001
            results.append(type(e).__name__)
        return order, results, q.metrics.dropped_jobs, q.metrics.jobs_done

    ours = asyncio.run(asyncio.wait_for(drive(queue), 10))
    theirs = asyncio.run(asyncio.wait_for(drive(jqueue), 10))
    assert ours == theirs

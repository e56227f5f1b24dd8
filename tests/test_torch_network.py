"""The port's network against the JAX package's, live on loopback at the
minimal preset with 64 validators: gossip from a JAX `Network` to a port
`Network` over a port `BeaconChain` (each message's `ValidationResult`
equal to what the JAX handlers give the same bytes on a JAX chain),
`beacon_blocks_by_range` and `_by_root` and status between the packages
in both directions, a block carried two hops by three port nodes,
discovery records and lookups across the packages, and the serial
validation of one peer's gossip stream in both packages. Every test binds
port 0 and runs under one `asyncio.wait_for` bound."""

import asyncio
import os
import sys
import time

import pytest
import torch

pytest.importorskip("cryptography")  # the JAX transport's primitives

sys.path.insert(0, os.path.dirname(__file__))

import test_torch_validation as tv  # noqa: E402
import torch_chain  # noqa: E402

from lodestar_tpu.chain.bls_verifier import CpuBlsVerifier as JCpuBlsVerifier  # noqa: E402
from lodestar_tpu.chain.chain import BeaconChain as JBeaconChain  # noqa: E402
from lodestar_tpu.network import discovery as jdisc  # noqa: E402
from lodestar_tpu.network import transport as jtransport  # noqa: E402
from lodestar_tpu.network.gossip import gossipsub as jgossipsub  # noqa: E402
from lodestar_tpu.network.gossip.handlers import GossipHandlers as JGossipHandlers  # noqa: E402
from lodestar_tpu.network.gossip.topic import parse_topic as jparse_topic  # noqa: E402
from lodestar_tpu.network.network import Network as JNetwork  # noqa: E402
from lodestar_tpu.params.presets import MINIMAL as JMINIMAL  # noqa: E402
from lodestar_tpu.types import get_types as jget_types  # noqa: E402
from lodestar_tpu_torch.chain.bls_verifier import CpuBlsVerifier  # noqa: E402
from lodestar_tpu_torch.chain.chain import BeaconChain  # noqa: E402
from lodestar_tpu_torch.network import discovery as pdisc  # noqa: E402
from lodestar_tpu_torch.network import transport as ptransport  # noqa: E402
from lodestar_tpu_torch.network.gossip import gossipsub as pgossipsub  # noqa: E402
from lodestar_tpu_torch.network.gossip.encoding import compute_msg_id, encode_message  # noqa: E402
from lodestar_tpu_torch.network.gossip.topic import (  # noqa: E402
    GossipTopic,
    GossipType,
    stringify_topic,
)
from lodestar_tpu_torch.network.network import Network  # noqa: E402
from lodestar_tpu_torch.params.presets import MINIMAL  # noqa: E402
from lodestar_tpu_torch.profile_network import _ForkBlocks, node_types  # noqa: E402
from lodestar_tpu_torch.types import get_types  # noqa: E402

torch.set_num_threads(1)

PT, T = get_types(MINIMAL).phase0, get_types(MINIMAL).altair
JT = jget_types(JMINIMAL).altair
LADDERS = {"attestation": GossipType.beacon_attestation,
           "aggregate": GossipType.beacon_aggregate_and_proof,
           "block": GossipType.beacon_block}


def run(coro, bound: float = 120.0):
    return asyncio.run(asyncio.wait_for(coro, bound))


async def _until(cond, timeout_s: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            return False
        await asyncio.sleep(0.01)
    return True


def _port_chain(plan, n_blocks: int, types=PT):
    chain = BeaconChain(plan.config, types, plan.genesis.state.copy(), verifier=CpuBlsVerifier())
    for signed in plan.blocks[:n_blocks]:
        chain.clock.set_slot(int(signed.message.slot))
        chain.process_block(signed)
    return chain


def _jax_chain(plan, n_blocks: int):
    jconfig, jgen = torch_chain.jax_genesis()
    chain = JBeaconChain(jconfig, jget_types(JMINIMAL).phase0, jgen.state.copy(),
                         verifier=JCpuBlsVerifier())
    for signed in plan.blocks[:n_blocks]:
        chain.clock.set_slot(int(signed.message.slot))
        chain.process_block(torch_chain.to_jax(signed, "SignedBeaconBlock"))
    return jconfig, chain


@pytest.fixture(scope="module")
def plan():
    p = torch_chain.port_chain()
    yield p
    p.factory.close()


@pytest.fixture(scope="module")
def gossip_rows(plan):
    """Every attestation, aggregate and block message of the validation
    table (in its order, its clock set on both chains) published by a JAX
    node to a port node whose chain imported PLAN's first five blocks; the
    port node's result over the wire and the JAX handlers' on a JAX chain
    that imported the same blocks."""
    port = _port_chain(plan, 5)
    jconfig, jax = _jax_chain(plan, 5)
    _, sender = _jax_chain(plan, 0)
    rows = []

    async def main():
        handlers = JGossipHandlers(jconfig, JT, jax)
        for c in (port, sender):
            c.clock.set_slot(tv.HEAD_SLOT)
        pn = Network(plan.config, T, port, identity=ptransport.NodeIdentity.from_seed(b"pn"),
                     subscribe_all_subnets=True)
        jn = JNetwork(jconfig, JT, sender, identity=jtransport.NodeIdentity.from_seed(b"jn"))
        validated = {}
        inner = pn.gossip.validators["/eth2/"]

        async def tap(topic, data):
            res = await inner(topic, data)
            validated[compute_msg_id(topic, data)] = res.value
            return res

        pn.gossip.validators["/eth2/"] = tap
        try:
            await pn.start()
            await jn.start()
            await jn.connect(*pn.transport.listen_addr)
            assert await _until(lambda: sum(
                "beacon_attestation" in t
                for t in getattr(jn.gossip.peers.get(pn.peer_id), "topics", ())) >= 64)
            sent = set()
            for name, ladder, clock, msg, _, args, action, reason in tv.messages(port, plan):
                if ladder not in LADDERS or (ladder == "attestation" and args[0] is None):
                    continue
                for c in (port, jax):
                    c.clock.set_slot(clock)
                digest = plan.config.fork_digest(plan.config.get_fork_name_at_slot(clock))
                topic = stringify_topic(GossipTopic(LADDERS[ladder], digest,
                                                    args[0] if args else None))
                wire = encode_message(msg.serialize())
                mid = compute_msg_id(topic, wire)
                if mid in sent:  # byte for byte a message already published
                    n = await jn.gossip.publish(topic, wire)
                    rows.append((name, action, "duplicate", "duplicate", n))
                    continue
                sent.add(mid)
                want = (await handlers._process((jparse_topic(topic), wire))).value
                n = await jn.gossip.publish(topic, wire)
                assert await _until(lambda: mid in validated, 30.0), name
                rows.append((name, action, validated[mid], want, n))
            rows.append(("heads", port.head_root, jax.head_root))
        finally:
            await jn.stop()
            await pn.stop()
            for q in handlers.queues.values():
                q.close()

    try:
        run(main())
    finally:
        port.close()
    return rows


N_GOSSIP = 31


def test_every_gossip_message_was_sent(gossip_rows):
    assert len(gossip_rows) == N_GOSSIP + 1
    names = [r[0] for r in gossip_rows[:-1]]
    assert {"att valid", "agg valid", "block valid", "att replay"} <= set(names)
    assert gossip_rows[-1][1] == gossip_rows[-1][2]  # both chains imported the gossip block


@pytest.mark.parametrize("k", range(N_GOSSIP))
def test_gossip_result_over_the_wire_equals_the_jax_handlers(gossip_rows, k):
    name, action, got, want, receivers = gossip_rows[k]
    if got == "duplicate":
        # the sender's router drops a message it has seen; the table's
        # replay is IGNOREd by both ladders
        assert receivers == 0 and action == "IGNORE", name
        return
    assert receivers == 1, name
    assert got == want == action, name


@pytest.fixture(scope="module")
def reqresp_nodes(plan):
    """A port and a JAX node on chains that imported PLAN's first five
    blocks (slots 1-3, 9, 10: across the Altair fork), connected; each
    decodes blocks by their slot's fork."""
    port = _port_chain(plan, 5)
    jconfig, jax = _jax_chain(plan, 5)
    jtypes = jget_types(JMINIMAL)
    jnode_types = type(JT)(**{**vars(jtypes.altair), "SignedBeaconBlock":
                              _ForkBlocks(jconfig, jtypes.by_fork)})
    out = {}

    async def main():
        pn = Network(plan.config, node_types(plan.config), port,
                     identity=ptransport.NodeIdentity.from_seed(b"pn"))
        jn = JNetwork(jconfig, jnode_types, jax, identity=jtransport.NodeIdentity.from_seed(b"jn"))
        try:
            await pn.start()
            await jn.start()
            await pn.connect(*jn.transport.listen_addr)
            assert await _until(lambda: pn.peer_id in jn.transport.connections)
            roots = [plan.blocks[i].message.hash_tree_root() for i in (0, 2, 4)] + [bytes(32)]
            for tag, net, peer in (("port", pn, jn.peer_id), ("jax", jn, pn.peer_id)):
                out[tag] = {
                    "range": [b.serialize() for b in
                              await net.reqresp.beacon_blocks_by_range(peer, 1, 10)],
                    "range_mid": [b.serialize() for b in
                                  await net.reqresp.beacon_blocks_by_range(peer, 3, 7)],
                    "root": [b.serialize() for b in
                             await net.reqresp.beacon_blocks_by_root(peer, roots)],
                    "status": (await net.reqresp.status(peer)).serialize(),
                    "ping": await net.reqresp.ping(peer, 7),
                }
            out["local_status"] = (pn.reqresp_handlers.local_status().serialize(),
                                   jn.reqresp_handlers.local_status().serialize())
        finally:
            await pn.stop()
            await jn.stop()

    try:
        run(main())
    finally:
        port.close()
    return out


@pytest.mark.parametrize("direction", ["port", "jax"])
def test_blocks_by_range_and_root_are_byte_equal_both_ways(plan, reqresp_nodes, direction):
    got = reqresp_nodes[direction]
    blocks = [b.serialize() for b in plan.blocks[:5]]
    assert got["range"] == blocks
    assert got["range_mid"] == blocks[2:4]  # slots 3 and 9 of [3, 10)
    assert got["root"] == [blocks[0], blocks[2], blocks[4]]


@pytest.mark.parametrize("direction", ["port", "jax"])
def test_status_and_ping_match_both_ways(reqresp_nodes, direction):
    port_status, jax_status = reqresp_nodes["local_status"]
    assert port_status == jax_status
    got = reqresp_nodes[direction]
    # each asked the other for its status: the same bytes either way
    assert got["status"] == port_status
    assert got["ping"] == 0


def test_three_port_nodes_carry_a_block_two_hops(plan):
    chains = [_port_chain(plan, 0) for _ in range(3)]
    signed = plan.blocks[0]
    root = signed.message.hash_tree_root()

    async def main():
        nets = [Network(plan.config, PT, c, identity=ptransport.NodeIdentity.from_seed(bytes([i])))
                for i, c in enumerate(chains)]
        try:
            for net in nets:
                await net.start()
            for a, b in zip(nets, nets[1:]):  # a line: 0-1-2
                await a.connect(*b.transport.listen_addr)
            for _ in range(3):
                await asyncio.sleep(0.05)
                for net in nets:
                    await net.gossip.heartbeat()
            assert nets[2].peer_id not in nets[0].transport.connections
            for c in chains:
                c.clock.set_slot(1)
            chains[0].process_block(signed)
            assert await nets[0].publish_block(signed) >= 1
            assert await _until(lambda: all(c.head_root == root for c in chains), 30.0)
        finally:
            for net in nets:
                await net.stop()

    try:
        run(main())
        for c in chains:
            assert c.fork_choice.has_block(root) and c.head_root == root
    finally:
        for c in chains:
            c.close()


def _enr(mod, identity, port: int):
    return mod.ENR(node_id=identity.peer_id, pubkey=identity.public_bytes, ip="127.0.0.1",
                   tcp_port=9000 + port, udp_port=port, seq=3, fork_digest=b"\x01\x02\x03\x04",
                   attnets=(1 << 5) | (1 << 63))


def test_discovery_records_equal_the_jax_package():
    for seed in (b"a", b"b", b"c"):
        pid, jid = ptransport.NodeIdentity.from_seed(seed), jtransport.NodeIdentity.from_seed(seed)
        ours, theirs = _enr(pdisc, pid, 30303).sign(pid), _enr(jdisc, jid, 30303).sign(jid)
        assert ours.encode() == theirs.encode()
        assert pdisc.enr_to_text(ours) == jdisc.enr_to_text(theirs)
        back = pdisc.enr_from_text(jdisc.enr_to_text(theirs))
        assert back.verify() and back.encode() == theirs.encode()
        assert jdisc.enr_from_text(pdisc.enr_to_text(ours)).verify()
        assert back.has_attnet(5) and back.has_attnet(63) and not back.has_attnet(6)
        tampered = pdisc.ENR.decode(ours.encode())[0]
        tampered.tcp_port += 1
        assert not tampered.verify()
    a, b = ("%040x" % 5), ("%040x" % 9)
    assert pdisc._distance(a, b) == jdisc._distance(a, b)


def test_each_package_discovers_the_other():
    async def main():
        nodes = []
        for mod, tmod, seed in ((pdisc, ptransport, b"p1"), (jdisc, jtransport, b"j"),
                                (pdisc, ptransport, b"p2")):
            ident = tmod.NodeIdentity.from_seed(seed)
            d = mod.Discovery(ident, mod.ENR(node_id=ident.peer_id, pubkey=ident.public_bytes,
                                             ip="127.0.0.1", tcp_port=1, udp_port=0))
            await d.start()
            nodes.append(d)
        p1, j, p2 = nodes
        try:
            # the JAX node bootstraps from the first port node, the second
            # port node from the JAX node, and finds the first through it
            await j.bootstrap([jdisc.ENR.decode(p1.local_enr.encode())[0]])
            assert p1.local_enr.node_id in {e.node_id for e in j.table.all()}
            assert await _until(lambda: j.local_enr.node_id in
                                {e.node_id for e in p1.table.all()})
            await p2.bootstrap([pdisc.ENR.decode(j.local_enr.encode())[0]])
            found = await p2.lookup(p1.local_enr.node_id)
            assert p1.local_enr.node_id in {e.node_id for e in found}
            assert await p2.ping(pdisc.ENR.decode(p1.local_enr.encode())[0])
        finally:
            for d in nodes:
                d.stop()

    run(main(), 60.0)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_one_peer_stream_is_validated_one_message_at_a_time(package):
    """A router validates one peer's gossip stream serially: five messages
    from one peer never overlap, five from five peers do (the
    `GossipsubService._on_stream` loop awaits each message's verdict)."""
    tmod, gmod = (ptransport, pgossipsub) if package == "port" else (jtransport, jgossipsub)

    async def main():
        receiver = tmod.Transport(tmod.NodeIdentity.from_seed(b"r"))
        router = gmod.Gossipsub()
        gmod.GossipsubService(receiver, router)
        await router.subscribe("/eth2/00000000/beacon_block/ssz_snappy")
        live, peak = [0], [0]

        async def slow(topic, data):
            live[0] += 1
            peak[0] = max(peak[0], live[0])
            await asyncio.sleep(0.05)
            live[0] -= 1
            return gmod.ValidationResult.ACCEPT

        router.validators["/eth2/"] = slow
        host, port = await receiver.listen()
        senders = []
        for i in range(5):
            t = tmod.Transport(tmod.NodeIdentity.from_seed(bytes([i + 1])))
            svc = gmod.GossipsubService(t, gmod.Gossipsub())
            await t.dial(host, port)
            senders.append((t, svc.router))
        topic = "/eth2/00000000/beacon_block/ssz_snappy"
        assert await _until(lambda: all(topic in getattr(r.peers.get(receiver.peer_id), "topics",
                                                          ()) for _, r in senders))
        try:
            results = {}
            for label, pubs in (("one peer", [(senders[0][1], i) for i in range(5)]),
                                ("five peers", [(r, 10 + i) for i, (_, r) in enumerate(senders)])):
                peak[0] = 0
                t0 = time.perf_counter()
                for r, i in pubs:
                    assert await r.publish(topic, encode_message(bytes([i]) * 40)) == 1
                assert await _until(lambda: len(router.seen._items) >= 5 * (1 + len(results))
                                    and live[0] == 0)
                results[label] = (peak[0], time.perf_counter() - t0)
            return results
        finally:
            for t, r in senders:
                await t.close()
            await receiver.close()

    results = run(main(), 60.0)
    assert results["one peer"][0] == 1 and results["one peer"][1] >= 5 * 0.05
    assert results["five peers"][0] == 5

"""The port's transport (`lodestar_tpu_torch/network/transport.py`) against
the JAX one: a port node and a JAX node complete the handshake in both
directions, open streams, echo, close and reset; a tampered frame breaks
the connection; and two port nodes talk with `cryptography` absent.
Every test binds port 0 on loopback and runs under one `wait_for` bound."""

import asyncio
import json
import os
import subprocess
import sys

import pytest

from lodestar_tpu_torch.network import transport as pt

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def run(coro, bound: float = 30.0):
    return asyncio.run(asyncio.wait_for(coro, bound))


def _jax_transport():
    pytest.importorskip("cryptography")
    from lodestar_tpu.network import transport as jt

    return jt


async def _wait(cond, steps: int = 200):
    for _ in range(steps):
        if cond():
            return True
        await asyncio.sleep(0.01)
    return cond()


def test_identity_matches_the_jax_package():
    jt = _jax_transport()
    for seed in (b"a", b"node-7", bytes(range(40))):
        port, ref = pt.NodeIdentity.from_seed(seed), jt.NodeIdentity.from_seed(seed)
        assert port.public_bytes == ref.public_bytes and port.peer_id == ref.peer_id
        assert port.sign(b"transcript") == ref.sign(b"transcript")
        assert jt.verify_identity(port.public_bytes, port.sign(b"x"), b"x")
        assert pt.verify_identity(ref.public_bytes, ref.sign(b"x"), b"x")
        assert not pt.verify_identity(ref.public_bytes, ref.sign(b"x"), b"y")
    assert pt.NodeIdentity().private_key != pt.NodeIdentity().private_key


@pytest.mark.parametrize("port_dials", [True, False])
def test_port_and_jax_nodes_handshake_echo_close_and_reset(port_dials):
    jt = _jax_transport()

    async def main():
        p = pt.Transport(pt.NodeIdentity.from_seed(b"port"))
        j = jt.Transport(jt.NodeIdentity.from_seed(b"jax"))
        dialer, listener = (p, j) if port_dials else (j, p)
        try:
            async def echo(stream):
                data = await stream.read_all(timeout=5)
                await stream.write(data[::-1])
                await stream.close()

            async def hold(stream):
                await stream.read(timeout=5)

            for t in (p, j):
                t.set_stream_handler("/test/echo/1", echo)
                t.set_stream_handler("/test/hold/1", hold)
            host, port = await listener.listen()
            conn = await dialer.dial(host, port)
            assert conn.peer_id == listener.peer_id
            assert await _wait(lambda: dialer.peer_id in listener.connections)
            back = listener.connections[dialer.peer_id]
            assert back.remote_pubkey == dialer.identity.public_bytes
            # streams both ways over the one connection
            for c in (conn, back):
                s = await c.open_stream("/test/echo/1")
                payload = os.urandom(3000) + b"end"
                await s.write(payload)
                await s.close()
                assert await s.read_all(timeout=5) == payload[::-1]
            # an unknown protocol is reset by the receiver
            s = await conn.open_stream("/test/none/1")
            with pytest.raises(pt.StreamReset if port_dials else jt.StreamReset):
                await s.read(timeout=5)
            # a reset from the opener reaches the handler's side
            s = await conn.open_stream("/test/hold/1")
            await s.reset()
            assert await _wait(lambda: not any(k[0] == s.stream_id for k in back.streams))
        finally:
            await dialer.close()
            await listener.close()

    run(main())


def test_a_tampered_frame_breaks_the_connection():
    jt = _jax_transport()

    async def main():
        p = pt.Transport(pt.NodeIdentity.from_seed(b"port"))
        j = jt.Transport(jt.NodeIdentity.from_seed(b"jax"))
        try:
            host, port = await j.listen()
            conn = await p.dial(host, port)
            assert await _wait(lambda: p.peer_id in j.connections)
            back = j.connections[p.peer_id]
            # a frame whose ciphertext is flipped fails the AEAD: the JAX
            # reader closes the connection, and the port side sees the close
            frame = bytearray(conn._channel.encrypt(b"\x00\x00"))
            frame[0] ^= 0x80
            conn._writer.write(len(frame).to_bytes(4, "big") + bytes(frame))
            await conn._writer.drain()
            assert await _wait(lambda: back._closed)
            assert await _wait(lambda: conn._closed)
            assert p.peer_id not in j.connections and j.peer_id not in p.connections
            with pytest.raises(pt.TransportError):
                await conn.open_stream("/test/echo/1")
        finally:
            await p.close()
            await j.close()

    run(main())


def test_the_port_channel_refuses_a_tampered_frame():
    key_a, key_b = os.urandom(32), os.urandom(32)
    a, b = pt._SecureChannel(key_a, key_b), pt._SecureChannel(key_b, key_a)
    assert b.decrypt(a.encrypt(b"one")) == b"one"
    bad = bytearray(a.encrypt(b"two"))
    bad[-1] ^= 1
    with pytest.raises(Exception):
        b.decrypt(bytes(bad))


PORT_ONLY = r"""
import asyncio, json, os, sys
sys.modules["cryptography"] = None  # any import of it raises
from lodestar_tpu_torch.network.transport import NodeIdentity, Transport

async def main():
    a, b = Transport(NodeIdentity.from_seed(b"a")), Transport(NodeIdentity())
    async def echo(stream):
        data = await stream.read_all(timeout=5)
        await stream.write(data[::-1])
        await stream.close()
    b.set_stream_handler("/echo/1", echo)
    host, port = await b.listen()
    conn = await a.dial(host, port)
    s = await conn.open_stream("/echo/1")
    await s.write(b"hello")
    await s.close()
    got = await s.read_all(timeout=5)
    await a.close()
    await b.close()
    bad = sorted(m for m in sys.modules if m.startswith(("cryptography", "jax", "lodestar_tpu."))
                 and sys.modules[m] is not None)
    return {"echo": got.decode(), "peer": conn.peer_id == b.peer_id, "bad": bad}

print(json.dumps(asyncio.run(asyncio.wait_for(main(), 30))))
"""


def test_port_to_port_runs_without_cryptography():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PORT_ONLY], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True, timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "echo": "olleh", "peer": True, "bad": []}

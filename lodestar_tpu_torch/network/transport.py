"""Secure, multiplexed TCP transport — the libp2p-bundle equivalent.

Reference: `beacon-node/src/network/nodejs/bundle.ts` composes libp2p from
TCP transport + noise channel encryption + mplex stream muxing + an
ed25519 peer-id. This module provides the same three layers natively on
asyncio:

- **Identity**: ed25519 keypair; peer id = hex of SHA-256(pubkey)[:20]
  (the role of libp2p's multihash PeerId).
- **Encryption**: a Noise-XX-shaped handshake (X25519 ephemerals, HKDF-
  SHA256, ChaCha20Poly1305) in which each side authenticates by signing
  the handshake transcript with its ed25519 identity key — the same
  authentication structure as libp2p-noise, where the static key is
  bound to the PeerId by signature.
- **Muxing**: mplex-style frames (varint<<3|flag header) carrying
  independent bidirectional streams; NewStream data carries the
  protocol id (collapsing multistream-select's negotiation round-trip
  into stream open, which Req/Resp can do because every protocol is
  known up front).

All wire I/O is on the host (the card plays no role here); frames are
length-prefixed ciphertexts so the reader never blocks mid-record.

The primitives are the port's own (`crypto.py`): the same bytes as the
`cryptography` wheel the JAX transport uses, so the two interoperate.
The prologue and signing context keep the JAX package's bytes for that
reason.

(The port's copy of the JAX package's `network/transport.py`.)
"""

from __future__ import annotations

import logging
import asyncio
import struct
from typing import Awaitable, Callable

import secrets

from ..ssz.hashing import sha256
from . import crypto
from .crypto import ChaCha20Poly1305

MAX_FRAME = 1 << 20  # 1 MiB plaintext per mux frame
NOISE_PROLOGUE = b"lodestar-tpu-noise-xx"
SIG_CONTEXT = b"lodestar-tpu-transport-identity:"

log = logging.getLogger(__name__)


class TransportError(Exception):
    pass


class HandshakeError(TransportError):
    pass


class StreamReset(TransportError):
    pass


# ---------------------------------------------------------------------------
# identity


class NodeIdentity:
    """ed25519 identity; signs handshake transcripts (libp2p PeerId role).
    `private_key` is the 32-byte RFC 8032 private key; without one it is
    drawn from `secrets`."""

    def __init__(self, private_key: bytes | None = None):
        self.private_key = bytes(private_key) if private_key is not None \
            else secrets.token_bytes(32)
        self._expanded = crypto._expand(self.private_key)
        self.public_bytes = self._expanded[2]
        self.peer_id = peer_id_from_pubkey(self.public_bytes)

    @classmethod
    def from_seed(cls, seed: bytes) -> "NodeIdentity":
        return cls(sha256(seed))

    def sign(self, data: bytes) -> bytes:
        return crypto.ed25519_sign(self.private_key, SIG_CONTEXT + data, self._expanded)


def peer_id_from_pubkey(pubkey: bytes) -> str:
    return sha256(pubkey)[:20].hex()


def verify_identity(pubkey: bytes, sig: bytes, data: bytes) -> bool:
    return crypto.ed25519_verify(bytes(pubkey), bytes(sig), SIG_CONTEXT + data)


# ---------------------------------------------------------------------------
# noise-style secure channel


def _hkdf(secret: bytes, salt: bytes, info: bytes, n: int = 32) -> bytes:
    return crypto.hkdf_sha256(secret, salt, info, n)


class _SecureChannel:
    """Per-direction ChaCha20Poly1305 with 64-bit counter nonces."""

    def __init__(self, send_key: bytes, recv_key: bytes):
        self._send = ChaCha20Poly1305(send_key)
        self._recv = ChaCha20Poly1305(recv_key)
        self._send_n = 0
        self._recv_n = 0

    @staticmethod
    def _nonce(counter: int) -> bytes:
        return b"\x00\x00\x00\x00" + struct.pack("<Q", counter)

    def encrypt(self, plaintext: bytes) -> bytes:
        ct = self._send.encrypt(self._nonce(self._send_n), plaintext, b"")
        self._send_n += 1
        return ct

    def decrypt(self, ciphertext: bytes) -> bytes:
        pt = self._recv.decrypt(self._nonce(self._recv_n), ciphertext, b"")
        self._recv_n += 1
        return pt


async def _read_frame(reader: asyncio.StreamReader) -> bytes:
    header = await reader.readexactly(4)
    (length,) = struct.unpack(">I", header)
    if length > MAX_FRAME + 16:
        raise TransportError(f"oversized frame: {length}")
    return await reader.readexactly(length)


def _write_frame(writer: asyncio.StreamWriter, data: bytes) -> None:
    writer.write(struct.pack(">I", len(data)) + data)


async def perform_handshake(
    identity: NodeIdentity,
    reader: asyncio.StreamReader,
    writer: asyncio.StreamWriter,
    initiator: bool,
) -> tuple[_SecureChannel, str, bytes]:
    """XX-pattern handshake; returns (channel, remote peer id, remote pubkey).

    msg1  i→r : e_i
    msg2  r→i : e_r || Enc(k_hs, n=0, s_pub_r || Sig_r(transcript || "resp"))
    msg3  i→r : Enc(k_hs, n=1, s_pub_i || Sig_i(transcript || "init"))
    keys: HKDF(dh(e_i, e_r)) — handshake key then directional transport keys
    salted by the transcript hash, so the channel is bound to both
    authenticated identities.
    """
    eph = secrets.token_bytes(32)
    eph_pub = crypto.x25519_public(eph)

    if initiator:
        _write_frame(writer, eph_pub)
        await writer.drain()
        msg2 = await _read_frame(reader)
        if len(msg2) < 32:
            raise HandshakeError("short handshake msg2")
        remote_eph, enc = msg2[:32], msg2[32:]
    else:
        remote_eph = await _read_frame(reader)
        if len(remote_eph) != 32:
            raise HandshakeError("bad ephemeral size")

    shared = crypto.x25519(eph, remote_eph)
    transcript = NOISE_PROLOGUE + (
        eph_pub + remote_eph if initiator else remote_eph + eph_pub
    )
    hs_key = _hkdf(shared, salt=b"", info=b"handshake")
    hs = ChaCha20Poly1305(hs_key)

    def _auth_payload(role: bytes) -> bytes:
        return identity.public_bytes + identity.sign(transcript + role)

    def _verify_auth(plain: bytes, role: bytes) -> bytes:
        pub, sig = plain[:32], plain[32:]
        if not verify_identity(pub, sig, transcript + role):
            raise HandshakeError("identity signature invalid")
        return pub

    try:
        if initiator:
            remote_pub = _verify_auth(
                hs.decrypt(_SecureChannel._nonce(0), enc, b""), b"resp"
            )
            _write_frame(
                writer,
                hs.encrypt(_SecureChannel._nonce(1), _auth_payload(b"init"), b""),
            )
            await writer.drain()
        else:
            _write_frame(
                writer,
                eph_pub
                + hs.encrypt(_SecureChannel._nonce(0), _auth_payload(b"resp"), b""),
            )
            await writer.drain()
            msg3 = await _read_frame(reader)
            remote_pub = _verify_auth(
                hs.decrypt(_SecureChannel._nonce(1), msg3, b""), b"init"
            )
    except HandshakeError:
        raise
    except Exception as e:  # AEAD failures, truncation
        raise HandshakeError(f"handshake failed: {e}") from e

    salt = sha256(transcript)
    k_i2r = _hkdf(shared, salt=salt, info=b"i2r")
    k_r2i = _hkdf(shared, salt=salt, info=b"r2i")
    channel = (
        _SecureChannel(k_i2r, k_r2i) if initiator else _SecureChannel(k_r2i, k_i2r)
    )
    return channel, peer_id_from_pubkey(remote_pub), remote_pub


# ---------------------------------------------------------------------------
# mplex-style muxer

_NEW_STREAM = 0
_MSG_RECEIVER = 1
_MSG_INITIATOR = 2
_CLOSE_RECEIVER = 3
_CLOSE_INITIATOR = 4
_RESET_RECEIVER = 5
_RESET_INITIATOR = 6


def _encode_varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _decode_varint(data: bytes, i: int) -> tuple[int, int]:
    value = 0
    shift = 0
    while i < len(data):
        b = data[i]
        i += 1
        value |= (b & 0x7F) << shift
        if not (b & 0x80):
            return value, i
        shift += 7
        if shift > 63:
            break
    raise TransportError("bad varint in mux frame")


class Stream:
    """One bidirectional substream over a Connection."""

    def __init__(self, conn: "Connection", stream_id: int, initiator: bool, protocol: str):
        self.conn = conn
        self.stream_id = stream_id
        self.initiator = initiator
        self.protocol = protocol
        self._inbox: asyncio.Queue[bytes | None] = asyncio.Queue()
        self._reset = False
        self._remote_closed = False
        self._local_closed = False

    async def write(self, data: bytes) -> None:
        if self._reset:
            raise StreamReset(f"stream {self.stream_id} reset")
        if self._local_closed:
            raise TransportError("write after close")
        flag = _MSG_INITIATOR if self.initiator else _MSG_RECEIVER
        for off in range(0, len(data), MAX_FRAME - 64):
            await self.conn._send_mux(self.stream_id, flag, data[off : off + MAX_FRAME - 64])
        if not data:
            await self.conn._send_mux(self.stream_id, flag, b"")

    async def read(self, timeout: float | None = None) -> bytes | None:
        """Next data chunk, or None on remote close/EOF."""
        if self._reset:
            raise StreamReset(f"stream {self.stream_id} reset")
        if self._remote_closed and self._inbox.empty():
            return None
        try:
            if timeout is None:
                item = await self._inbox.get()
            else:
                item = await asyncio.wait_for(self._inbox.get(), timeout)
        except asyncio.TimeoutError:
            raise TimeoutError(f"stream {self.stream_id} read timeout") from None
        if item is None and self._reset:
            raise StreamReset(f"stream {self.stream_id} reset")
        return item

    async def read_all(self, timeout: float | None = None) -> bytes:
        """Drain until remote close; returns concatenated bytes."""
        chunks = []
        while True:
            chunk = await self.read(timeout)
            if chunk is None:
                return b"".join(chunks)
            chunks.append(chunk)

    async def close(self) -> None:
        """Half-close our write side."""
        if self._local_closed or self._reset:
            return
        self._local_closed = True
        flag = _CLOSE_INITIATOR if self.initiator else _CLOSE_RECEIVER
        try:
            await self.conn._send_mux(self.stream_id, flag, b"")
        except TransportError:
            pass
        if self._remote_closed:
            self._forget()

    async def reset(self) -> None:
        if self._reset:
            return
        self._mark_reset()
        self._forget()
        flag = _RESET_INITIATOR if self.initiator else _RESET_RECEIVER
        try:
            await self.conn._send_mux(self.stream_id, flag, b"")
        except TransportError:
            pass

    def _forget(self) -> None:
        """Drop the connection's registry entry (both fully-closed and
        reset streams) so long-lived connections don't accumulate streams."""
        self.conn.streams.pop((self.stream_id, self.initiator), None)

    def _mark_reset(self) -> None:
        self._reset = True
        self._inbox.put_nowait(None)

    def _on_data(self, data: bytes) -> None:
        self._inbox.put_nowait(data)

    def _on_remote_close(self) -> None:
        self._remote_closed = True
        self._inbox.put_nowait(None)
        if self._local_closed:
            self._forget()


StreamHandler = Callable[[Stream], Awaitable[None]]


class Connection:
    """An authenticated, multiplexed session with one remote peer."""

    def __init__(
        self,
        transport: "Transport",
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        channel: _SecureChannel,
        peer_id: str,
        remote_pubkey: bytes,
        initiator: bool,
    ):
        self.transport = transport
        self._reader = reader
        self._writer = writer
        self._channel = channel
        self.peer_id = peer_id
        self.remote_pubkey = remote_pubkey
        self.initiator = initiator
        self.streams: dict[tuple[int, bool], Stream] = {}
        self._next_stream_id = 0 if initiator else 1  # odd/even split avoids collision
        self._closed = False
        self._write_lock = asyncio.Lock()
        self._reader_task: asyncio.Task | None = None
        self.on_close: list[Callable[[], None]] = []

    # -- outgoing ------------------------------------------------------------

    async def open_stream(self, protocol: str) -> Stream:
        if self._closed:
            raise TransportError("connection closed")
        stream_id = self._next_stream_id
        self._next_stream_id += 2
        stream = Stream(self, stream_id, initiator=True, protocol=protocol)
        self.streams[(stream_id, True)] = stream
        await self._send_mux(stream_id, _NEW_STREAM, protocol.encode())
        return stream

    async def _send_mux(self, stream_id: int, flag: int, data: bytes) -> None:
        if self._closed:
            raise TransportError("connection closed")
        header = _encode_varint((stream_id << 3) | flag) + _encode_varint(len(data))
        async with self._write_lock:
            _write_frame(self._writer, self._channel.encrypt(header + data))
            await self._writer.drain()

    # -- incoming ------------------------------------------------------------

    def _start(self) -> None:
        self._reader_task = asyncio.get_running_loop().create_task(self._read_loop())

    async def _read_loop(self) -> None:
        try:
            while not self._closed:
                frame = await _read_frame(self._reader)
                plain = self._channel.decrypt(frame)
                await self._dispatch(plain)
        except (asyncio.IncompleteReadError, ConnectionError, TransportError):
            pass
        except Exception as e:  # AEAD failure = peer misbehaving
            log.debug(f"connection {self.peer_id[:8]} read error: {e}")
        finally:
            await self.close()

    async def _dispatch(self, plain: bytes) -> None:
        header, i = _decode_varint(plain, 0)
        length, i = _decode_varint(plain, i)
        data = plain[i : i + length]
        stream_id, flag = header >> 3, header & 0x7
        # A frame from the remote INITIATOR targets our receiver-side entry.
        if flag == _NEW_STREAM:
            protocol = data.decode(errors="replace")
            stream = Stream(self, stream_id, initiator=False, protocol=protocol)
            self.streams[(stream_id, False)] = stream
            handler = self.transport._resolve_handler(protocol)
            if handler is None:
                await stream.reset()
                return
            asyncio.get_running_loop().create_task(self._run_handler(handler, stream))
            return

        from_initiator = flag in (_MSG_INITIATOR, _CLOSE_INITIATOR, _RESET_INITIATOR)
        key = (stream_id, not from_initiator)
        stream = self.streams.get(key)
        if stream is None:
            return
        if flag in (_MSG_INITIATOR, _MSG_RECEIVER):
            stream._on_data(data)
        elif flag in (_CLOSE_INITIATOR, _CLOSE_RECEIVER):
            stream._on_remote_close()
        elif flag in (_RESET_INITIATOR, _RESET_RECEIVER):
            stream._mark_reset()
            self.streams.pop(key, None)

    async def _run_handler(self, handler: StreamHandler, stream: Stream) -> None:
        try:
            await handler(stream)
        except StreamReset:
            pass
        except Exception as e:  # noqa: BLE001 — a handler bug must not kill the conn
            log.debug(f"stream handler error ({stream.protocol}): {e}")
            await stream.reset()

    async def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for stream in list(self.streams.values()):
            stream._mark_reset()
        self.streams.clear()
        try:
            self._writer.close()
        except Exception as e:
            log.debug("writer close raced the transport teardown: %s", e)
        self.transport._forget(self)
        for cb in self.on_close:
            cb()


class Transport:
    """Listens, dials, and owns live connections (one per peer)."""

    def __init__(self, identity: NodeIdentity | None = None):
        self.identity = identity or NodeIdentity()
        self.peer_id = self.identity.peer_id
        self.connections: dict[str, Connection] = {}
        self._handlers: dict[str, StreamHandler] = {}
        self._prefix_handlers: list[tuple[str, StreamHandler]] = []
        self._server: asyncio.AbstractServer | None = None
        self.listen_addr: tuple[str, int] | None = None
        self.on_connection: list[Callable[[Connection], None]] = []

    # -- protocol registry ---------------------------------------------------

    def set_stream_handler(self, protocol: str, handler: StreamHandler) -> None:
        self._handlers[protocol] = handler

    def set_prefix_handler(self, prefix: str, handler: StreamHandler) -> None:
        """Match any protocol id starting with `prefix` (req/resp family)."""
        self._prefix_handlers.append((prefix, handler))

    def _resolve_handler(self, protocol: str) -> StreamHandler | None:
        handler = self._handlers.get(protocol)
        if handler is not None:
            return handler
        for prefix, h in self._prefix_handlers:
            if protocol.startswith(prefix):
                return h
        return None

    # -- lifecycle -----------------------------------------------------------

    async def listen(self, host: str = "127.0.0.1", port: int = 0) -> tuple[str, int]:
        self._server = await asyncio.start_server(self._accept, host, port)
        sock = self._server.sockets[0]
        self.listen_addr = sock.getsockname()[:2]
        return self.listen_addr

    async def _accept(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            channel, peer_id, pub = await asyncio.wait_for(
                perform_handshake(self.identity, reader, writer, initiator=False),
                timeout=10.0,
            )
        except (HandshakeError, asyncio.TimeoutError, ConnectionError, asyncio.IncompleteReadError):
            writer.close()
            return
        self._adopt(Connection(self, reader, writer, channel, peer_id, pub, False))

    async def dial(self, host: str, port: int) -> Connection:
        reader, writer = await asyncio.open_connection(host, port)
        try:
            channel, peer_id, pub = await asyncio.wait_for(
                perform_handshake(self.identity, reader, writer, initiator=True),
                timeout=10.0,
            )
        except (
            HandshakeError,
            asyncio.TimeoutError,
            ConnectionError,
            asyncio.IncompleteReadError,
        ) as e:
            writer.close()
            raise HandshakeError(str(e)) from e
        return self._adopt(Connection(self, reader, writer, channel, peer_id, pub, True))

    def _adopt(self, conn: Connection) -> Connection:
        old = self.connections.get(conn.peer_id)
        if old is not None and not old._closed:
            # simultaneous open: both sides dialed each other, and each
            # would otherwise keep the TCP stream the other discarded.
            # Deterministic tiebreak — BOTH ends keep the connection whose
            # initiator has the smaller peer id — picks one shared stream.
            if old.initiator != conn.initiator:
                keep_old = old.initiator == (self.peer_id < conn.peer_id)
                if keep_old:
                    asyncio.get_running_loop().create_task(conn.close())
                    return old
            asyncio.get_running_loop().create_task(old.close())
        self.connections[conn.peer_id] = conn
        conn._start()
        for cb in self.on_connection:
            cb(conn)
        return conn

    def _forget(self, conn: Connection) -> None:
        if self.connections.get(conn.peer_id) is conn:
            self.connections.pop(conn.peer_id, None)

    async def close(self) -> None:
        # stop accepting, THEN close connections, THEN wait: since 3.12
        # Server.wait_closed() also waits for accepted client connections,
        # so any other order can hang on a connection that slips in (or on
        # connections waiting for the server)
        if self._server is not None:
            self._server.close()
        for conn in list(self.connections.values()):
            await conn.close()
        if self._server is not None:
            await self._server.wait_closed()

"""Gossipsub RPC wire codec.

Reference: gossipsub v1.1 RPCs (`@chainsafe/libp2p-gossipsub` message.ts /
protobuf RPC). Ethereum gossip is *anonymous* (no from/seqno/signature —
StrictNoSign, message id is content-derived: `gossip/encoding.ts`), so the
RPC here carries exactly: subscriptions, published messages (topic+data),
and control (IHAVE/IWANT/GRAFT/PRUNE). Encoding is tag-length-value with
varints — one self-contained frame per RPC on the gossip stream.

(The port's copy of the JAX package's `network/gossip/rpc.py`.)
"""

from __future__ import annotations

from dataclasses import dataclass, field

_TAG_SUB = 1
_TAG_UNSUB = 2
_TAG_MSG = 3
_TAG_IHAVE = 4
_TAG_IWANT = 5
_TAG_GRAFT = 6
_TAG_PRUNE = 7

MAX_RPC_SIZE = 10 * 2**20


@dataclass
class ControlIHave:
    topic: str
    msg_ids: list[bytes] = field(default_factory=list)


@dataclass
class ControlPrune:
    topic: str
    backoff_sec: int = 60


@dataclass
class RPC:
    subscriptions: list[tuple[bool, str]] = field(default_factory=list)
    messages: list[tuple[str, bytes]] = field(default_factory=list)  # (topic, wire data)
    ihave: list[ControlIHave] = field(default_factory=list)
    iwant: list[bytes] = field(default_factory=list)  # msg ids
    graft: list[str] = field(default_factory=list)  # topics
    prune: list[ControlPrune] = field(default_factory=list)

    def is_empty(self) -> bool:
        return not (
            self.subscriptions or self.messages or self.ihave or self.iwant
            or self.graft or self.prune
        )


def _varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _read_varint(data: bytes, i: int) -> tuple[int, int]:
    value, shift = 0, 0
    while i < len(data):
        b = data[i]
        i += 1
        value |= (b & 0x7F) << shift
        if not (b & 0x80):
            if value > MAX_RPC_SIZE:
                raise ValueError("varint exceeds RPC bound")
            return value, i
        shift += 7
        if shift > 35:
            break
    raise ValueError("bad varint in gossip RPC")


def _lv(data: bytes) -> bytes:
    return _varint(len(data)) + data


def _read_lv(data: bytes, i: int) -> tuple[bytes, int]:
    n, i = _read_varint(data, i)
    if i + n > len(data):
        raise ValueError("truncated RPC field")
    return data[i : i + n], i + n


def encode_rpc(rpc: RPC) -> bytes:
    out = bytearray()
    for subscribe, topic in rpc.subscriptions:
        out.append(_TAG_SUB if subscribe else _TAG_UNSUB)
        out += _lv(topic.encode())
    for topic, data in rpc.messages:
        out.append(_TAG_MSG)
        out += _lv(_lv(topic.encode()) + data)
    for ih in rpc.ihave:
        out.append(_TAG_IHAVE)
        body = _lv(ih.topic.encode()) + _varint(len(ih.msg_ids)) + b"".join(
            _lv(m) for m in ih.msg_ids
        )
        out += _lv(body)
    if rpc.iwant:
        out.append(_TAG_IWANT)
        body = _varint(len(rpc.iwant)) + b"".join(_lv(m) for m in rpc.iwant)
        out += _lv(body)
    for topic in rpc.graft:
        out.append(_TAG_GRAFT)
        out += _lv(topic.encode())
    for pr in rpc.prune:
        out.append(_TAG_PRUNE)
        out += _lv(_lv(pr.topic.encode()) + _varint(pr.backoff_sec))
    return bytes(out)


def decode_rpc(wire: bytes) -> RPC:
    if len(wire) > MAX_RPC_SIZE:
        raise ValueError("RPC too large")
    rpc = RPC()
    i = 0
    while i < len(wire):
        tag = wire[i]
        i += 1
        if tag in (_TAG_SUB, _TAG_UNSUB):
            topic, i = _read_lv(wire, i)
            rpc.subscriptions.append((tag == _TAG_SUB, topic.decode(errors="replace")))
        elif tag == _TAG_MSG:
            body, i = _read_lv(wire, i)
            topic, j = _read_lv(body, 0)
            rpc.messages.append((topic.decode(errors="replace"), body[j:]))
        elif tag == _TAG_IHAVE:
            body, i = _read_lv(wire, i)
            topic, j = _read_lv(body, 0)
            count, j = _read_varint(body, j)
            ids = []
            for _ in range(min(count, 5000)):
                mid, j = _read_lv(body, j)
                ids.append(mid)
            rpc.ihave.append(ControlIHave(topic.decode(errors="replace"), ids))
        elif tag == _TAG_IWANT:
            body, i = _read_lv(wire, i)
            count, j = _read_varint(body, 0)
            for _ in range(min(count, 5000)):
                mid, j = _read_lv(body, j)
                rpc.iwant.append(mid)
        elif tag == _TAG_GRAFT:
            topic, i = _read_lv(wire, i)
            rpc.graft.append(topic.decode(errors="replace"))
        elif tag == _TAG_PRUNE:
            body, i = _read_lv(wire, i)
            topic, j = _read_lv(body, 0)
            backoff, j = _read_varint(body, j)
            rpc.prune.append(ControlPrune(topic.decode(errors="replace"), backoff))
        else:
            raise ValueError(f"unknown RPC tag {tag}")
    return rpc

"""Peer scoring + peer manager bookkeeping.

Reference: `network/peers/score.ts` (PeerRpcScoreStore — actioned score
bands, exponential decay, ban thresholds) and `peerManager.ts` (target
peer maintenance, status handshake bookkeeping). The transport-level
dial/disconnect side arrives with the live transport; scoring and the
keep/prune decision logic are transport-independent.

(The port's copy of the JAX package's `network/peers.py`.)
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum


class PeerAction(str, Enum):
    # reference score.ts action weights
    Fatal = "Fatal"
    LowToleranceError = "LowToleranceError"
    MidToleranceError = "MidToleranceError"
    HighToleranceError = "HighToleranceError"


ACTION_SCORES = {
    PeerAction.Fatal: -(2**10),
    PeerAction.LowToleranceError: -10.0,
    PeerAction.MidToleranceError: -5.0,
    PeerAction.HighToleranceError: -1.0,
}

MIN_SCORE = -100.0
MAX_SCORE = 100.0
BAN_THRESHOLD = -50.0
DISCONNECT_THRESHOLD = -20.0
SCORE_HALFLIFE_SEC = 600.0


class ScoreState(str, Enum):
    Healthy = "Healthy"
    Disconnected = "Disconnected"
    Banned = "Banned"


@dataclass
class _PeerScore:
    score: float = 0.0
    last_update: float = field(default_factory=time.time)


class PeerRpcScoreStore:
    def __init__(self, time_fn=time.time):
        self._scores: dict[str, _PeerScore] = {}
        self._time = time_fn

    def apply_action(self, peer_id: str, action: PeerAction) -> None:
        rec = self._scores.setdefault(peer_id, _PeerScore(last_update=self._time()))
        self._decay(rec)
        rec.score = max(MIN_SCORE, min(MAX_SCORE, rec.score + ACTION_SCORES[action]))

    def _decay(self, rec: _PeerScore) -> None:
        now = self._time()
        dt = now - rec.last_update
        if dt > 0:
            rec.score *= 0.5 ** (dt / SCORE_HALFLIFE_SEC)
            rec.last_update = now

    def score(self, peer_id: str) -> float:
        rec = self._scores.get(peer_id)
        if rec is None:
            return 0.0
        self._decay(rec)
        return rec.score

    def state(self, peer_id: str) -> ScoreState:
        s = self.score(peer_id)
        if s <= BAN_THRESHOLD:
            return ScoreState.Banned
        if s <= DISCONNECT_THRESHOLD:
            return ScoreState.Disconnected
        return ScoreState.Healthy


@dataclass
class PeerInfo:
    peer_id: str
    status: object | None = None  # last Status handshake
    connected_at: float = 0.0
    direction: str = "outbound"


class PeerManager:
    """Connected-peer bookkeeping + prune decisions (reference
    peerManager.ts heartbeat: keep target_peers, prune worst-scored,
    never keep banned)."""

    def __init__(self, target_peers: int = 50, time_fn=time.time):
        self.target_peers = target_peers
        self.peers: dict[str, PeerInfo] = {}
        self.scores = PeerRpcScoreStore(time_fn)
        self._time = time_fn

    def on_connect(self, peer_id: str, direction: str = "outbound") -> bool:
        if self.scores.state(peer_id) == ScoreState.Banned:
            return False
        self.peers[peer_id] = PeerInfo(
            peer_id=peer_id, connected_at=self._time(), direction=direction
        )
        return True

    def on_disconnect(self, peer_id: str) -> None:
        self.peers.pop(peer_id, None)

    def on_status(self, peer_id: str, status) -> None:
        info = self.peers.get(peer_id)
        if info is not None:
            info.status = status

    def report_peer(self, peer_id: str, action: PeerAction) -> None:
        self.scores.apply_action(peer_id, action)

    def heartbeat(self) -> list[str]:
        """Returns peer ids to disconnect: banned/bad-scored first, then
        excess above target (worst score first)."""
        to_drop = [
            pid
            for pid in self.peers
            if self.scores.state(pid) != ScoreState.Healthy
        ]
        remaining = [p for p in self.peers if p not in to_drop]
        excess = len(remaining) - self.target_peers
        if excess > 0:
            remaining.sort(key=lambda p: self.scores.score(p))
            to_drop.extend(remaining[:excess])
        for pid in to_drop:
            self.on_disconnect(pid)
        return to_drop

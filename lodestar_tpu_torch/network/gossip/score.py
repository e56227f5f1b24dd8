"""Gossipsub v1.1 peer scoring with Ethereum-shaped parameters.

Reference: `network/gossip/scoringParameters.ts` (315 LoC) computes
per-topic score params from the chain spec; thresholds come from the
consensus p2p scoring note (gossip -4000 / publish -8000 / graylist
-16000). The score function follows the gossipsub v1.1 spec:

    score(p) = Σ_topic w_t · (P1·w1 + P2·w2 + P3·w3 + P3b·w3b + P4·w4)
               + P5·w5 + P6·w6 + P7·w7

P1 time-in-mesh, P2 first-message-deliveries, P3 mesh-delivery deficit,
P3b mesh-failure penalty, P4 invalid messages, P5 application score,
P6 IP colocation, P7 behaviour penalty. Decay is applied per
decay-interval tick by the heartbeat.

(The port's copy of the JAX package's `network/gossip/score.py`.)
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


# Thresholds (reference scoringParameters.ts gossipScoreThresholds)
GOSSIP_THRESHOLD = -4000.0
PUBLISH_THRESHOLD = -8000.0
GRAYLIST_THRESHOLD = -16000.0
ACCEPT_PX_THRESHOLD = 100.0
OPPORTUNISTIC_GRAFT_THRESHOLD = 5.0

MAX_POSITIVE_SCORE = 3600.0  # maxPositiveScore in the reference derivation
DECAY_INTERVAL = 12.0  # one slot
DECAY_TO_ZERO = 0.01


def _score_decay(decay_time_sec: float) -> float:
    """Per-interval decay factor so a counter reaches DECAY_TO_ZERO after
    `decay_time_sec` (reference scoreParameterDecay)."""
    ticks = max(decay_time_sec / DECAY_INTERVAL, 1.0)
    return DECAY_TO_ZERO ** (1.0 / ticks)


@dataclass
class TopicScoreParams:
    topic_weight: float = 0.5
    time_in_mesh_weight: float = 0.0324
    time_in_mesh_quantum: float = 12.0  # seconds per quantum (one slot)
    time_in_mesh_cap: float = 300.0
    first_message_deliveries_weight: float = 1.0
    first_message_deliveries_decay: float = 0.5
    first_message_deliveries_cap: float = 100.0
    mesh_message_deliveries_weight: float = 0.0  # ≤0; 0 disables P3
    mesh_message_deliveries_decay: float = 0.5
    mesh_message_deliveries_threshold: float = 10.0
    mesh_message_deliveries_cap: float = 100.0
    mesh_message_deliveries_activation: float = 60.0  # seconds in mesh
    mesh_failure_penalty_weight: float = 0.0  # ≤0
    mesh_failure_penalty_decay: float = 0.5
    invalid_message_deliveries_weight: float = -100.0
    invalid_message_deliveries_decay: float = _score_decay(50 * 12)


def ethereum_topic_params(topic_kind: str, slots_per_epoch: int = 32) -> TopicScoreParams:
    """Per-topic params shaped like the reference derivation: one expected
    block per slot, ~an aggregate per slot per peer, lighter subnets."""
    slot = 12.0
    epoch = slot * slots_per_epoch
    if topic_kind == "beacon_block":
        return TopicScoreParams(
            topic_weight=0.5,
            time_in_mesh_quantum=slot,
            first_message_deliveries_weight=1.14,
            first_message_deliveries_decay=_score_decay(20 * epoch),
            first_message_deliveries_cap=34.86,
            invalid_message_deliveries_weight=-214.99,
            invalid_message_deliveries_decay=_score_decay(50 * epoch),
        )
    if topic_kind == "beacon_aggregate_and_proof":
        return TopicScoreParams(
            topic_weight=0.5,
            time_in_mesh_quantum=slot,
            first_message_deliveries_weight=0.128,
            first_message_deliveries_decay=_score_decay(1 * epoch),
            first_message_deliveries_cap=179.3,
            invalid_message_deliveries_weight=-214.99,
            invalid_message_deliveries_decay=_score_decay(50 * epoch),
        )
    # attestation subnets & everything else: light weight, same invalid cost
    return TopicScoreParams(
        topic_weight=0.015,
        time_in_mesh_quantum=slot,
        first_message_deliveries_weight=0.956,
        first_message_deliveries_decay=_score_decay(1 * epoch),
        first_message_deliveries_cap=24.0,
        invalid_message_deliveries_weight=-4544.0,
        invalid_message_deliveries_decay=_score_decay(50 * epoch),
    )


@dataclass
class PeerScoreParams:
    topics: dict[str, TopicScoreParams] = field(default_factory=dict)
    topic_score_cap: float = MAX_POSITIVE_SCORE / 2
    app_specific_weight: float = 1.0
    ip_colocation_factor_weight: float = -35.11
    ip_colocation_factor_threshold: int = 3
    behaviour_penalty_weight: float = -15.92
    behaviour_penalty_threshold: float = 6.0
    behaviour_penalty_decay: float = _score_decay(10 * 12 * 32)
    retain_score_sec: float = 100 * 12 * 32


@dataclass
class _TopicStats:
    in_mesh: bool = False
    graft_time: float = 0.0
    mesh_time: float = 0.0
    first_message_deliveries: float = 0.0
    mesh_message_deliveries: float = 0.0
    mesh_message_deliveries_active: bool = False
    mesh_failure_penalty: float = 0.0
    invalid_message_deliveries: float = 0.0


@dataclass
class _PeerStats:
    topics: dict[str, _TopicStats] = field(default_factory=dict)
    app_score: float = 0.0
    behaviour_penalty: float = 0.0
    ip: str | None = None
    connected: bool = True
    disconnected_at: float = 0.0


class PeerScore:
    """Tracks and computes gossipsub scores for all known peers."""

    def __init__(self, params: PeerScoreParams | None = None, time_fn=time.monotonic):
        self.params = params or PeerScoreParams()
        self.peers: dict[str, _PeerStats] = {}
        self._time = time_fn

    # -- events reported by the router ---------------------------------------

    def _peer(self, peer_id: str) -> _PeerStats:
        return self.peers.setdefault(peer_id, _PeerStats())

    def _topic(self, peer_id: str, topic: str) -> _TopicStats:
        return self._peer(peer_id).topics.setdefault(topic, _TopicStats())

    def add_peer(self, peer_id: str, ip: str | None = None) -> None:
        stats = self._peer(peer_id)
        stats.connected = True
        stats.ip = ip

    def remove_peer(self, peer_id: str) -> None:
        stats = self.peers.get(peer_id)
        if stats is None:
            return
        # retain negative scores for retain_score_sec (spec: no whitewashing
        # by reconnecting); positive scores reset
        if self.score(peer_id) > 0:
            self.peers.pop(peer_id, None)
            return
        stats.connected = False
        stats.disconnected_at = self._time()
        for t in stats.topics.values():
            t.in_mesh = False

    def graft(self, peer_id: str, topic: str) -> None:
        t = self._topic(peer_id, topic)
        t.in_mesh = True
        t.graft_time = self._time()
        t.mesh_time = 0.0
        t.mesh_message_deliveries_active = False

    def prune(self, peer_id: str, topic: str) -> None:
        t = self._topic(peer_id, topic)
        tp = self.params.topics.get(topic)
        # mesh failure penalty: deficit square at prune time (spec P3b)
        if tp is not None and tp.mesh_failure_penalty_weight < 0 and t.mesh_message_deliveries_active:
            deficit = max(
                0.0, tp.mesh_message_deliveries_threshold - t.mesh_message_deliveries
            )
            t.mesh_failure_penalty += deficit * deficit
        t.in_mesh = False

    def deliver_message(self, peer_id: str, topic: str, first: bool) -> None:
        t = self._topic(peer_id, topic)
        tp = self.params.topics.get(topic, TopicScoreParams())
        if first:
            t.first_message_deliveries = min(
                tp.first_message_deliveries_cap, t.first_message_deliveries + 1
            )
        if t.in_mesh:
            t.mesh_message_deliveries = min(
                tp.mesh_message_deliveries_cap, t.mesh_message_deliveries + 1
            )

    def reject_message(self, peer_id: str, topic: str) -> None:
        self._topic(peer_id, topic).invalid_message_deliveries += 1

    def add_behaviour_penalty(self, peer_id: str, count: float = 1.0) -> None:
        self._peer(peer_id).behaviour_penalty += count

    def set_app_score(self, peer_id: str, score: float) -> None:
        self._peer(peer_id).app_score = score

    # -- scoring -------------------------------------------------------------

    def score(self, peer_id: str) -> float:
        stats = self.peers.get(peer_id)
        if stats is None:
            return 0.0
        now = self._time()
        p = self.params
        topic_sum = 0.0
        for topic, t in stats.topics.items():
            tp = p.topics.get(topic)
            if tp is None:
                continue
            s = 0.0
            if t.in_mesh:
                quanta = min(
                    (now - t.graft_time) / tp.time_in_mesh_quantum, tp.time_in_mesh_cap
                )
                s += quanta * tp.time_in_mesh_weight
            s += t.first_message_deliveries * tp.first_message_deliveries_weight
            if (
                tp.mesh_message_deliveries_weight < 0
                and t.in_mesh
                and now - t.graft_time > tp.mesh_message_deliveries_activation
                and t.mesh_message_deliveries < tp.mesh_message_deliveries_threshold
            ):
                deficit = tp.mesh_message_deliveries_threshold - t.mesh_message_deliveries
                s += deficit * deficit * tp.mesh_message_deliveries_weight
            s += t.mesh_failure_penalty * tp.mesh_failure_penalty_weight
            s += (
                t.invalid_message_deliveries
                * t.invalid_message_deliveries
                * tp.invalid_message_deliveries_weight
            )
            topic_sum += tp.topic_weight * s
        if topic_sum > 0:
            topic_sum = min(topic_sum, p.topic_score_cap)
        total = topic_sum
        total += stats.app_score * p.app_specific_weight
        # IP colocation: penalize peers sharing an IP beyond the threshold
        if stats.ip is not None and p.ip_colocation_factor_weight < 0:
            same_ip = sum(
                1
                for s2 in self.peers.values()
                if s2.connected and s2.ip == stats.ip
            )
            excess = same_ip - p.ip_colocation_factor_threshold
            if excess > 0:
                total += excess * excess * p.ip_colocation_factor_weight
        if stats.behaviour_penalty > p.behaviour_penalty_threshold:
            excess = stats.behaviour_penalty - p.behaviour_penalty_threshold
            total += excess * excess * p.behaviour_penalty_weight
        return total

    def decay(self) -> None:
        """One decay-interval tick (heartbeat calls this every DECAY_INTERVAL)."""
        now = self._time()
        p = self.params
        for peer_id in list(self.peers):
            stats = self.peers[peer_id]
            if (
                not stats.connected
                and now - stats.disconnected_at > p.retain_score_sec
            ):
                del self.peers[peer_id]
                continue
            for topic, t in stats.topics.items():
                tp = p.topics.get(topic, TopicScoreParams())
                t.first_message_deliveries *= tp.first_message_deliveries_decay
                t.mesh_message_deliveries *= tp.mesh_message_deliveries_decay
                t.mesh_failure_penalty *= tp.mesh_failure_penalty_decay
                t.invalid_message_deliveries *= tp.invalid_message_deliveries_decay
                if t.in_mesh:
                    t.mesh_time = now - t.graft_time
                    if t.mesh_time > tp.mesh_message_deliveries_activation:
                        t.mesh_message_deliveries_active = True
            stats.behaviour_penalty *= p.behaviour_penalty_decay

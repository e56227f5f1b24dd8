"""Gossip layer: topics, message-id encoding, validation queues."""

from .topic import GossipType, GossipTopic, stringify_topic, parse_topic  # noqa: F401
from .encoding import compute_msg_id, fast_msg_id, encode_message, decode_message  # noqa: F401

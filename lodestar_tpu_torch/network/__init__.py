"""The network (the port's copy of the JAX package's `network/`):
the secure multiplexed transport over the port's own X25519, Ed25519 and
ChaCha20-Poly1305 (`crypto.py`), gossipsub with its scoring and the
handlers that end in the chain's gossip ladders, req/resp with its
snappy-framed SSZ codec, peers, subnets, discovery over UDP, and the
`Network` facade.
"""

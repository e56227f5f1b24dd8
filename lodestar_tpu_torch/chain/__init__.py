"""The verifier boundary and the serving stack over it (the JAX package's
`chain/`: the facades and host tier, the supervisor, the lane dispatcher)."""

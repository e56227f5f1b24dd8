"""The observer seam of the verifier stack (the JAX package's
`observability/`); the port's metrics families are still to come."""

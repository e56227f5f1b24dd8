"""The device tier of the verifier boundary (the JAX package's `chain/`)."""

"""The serving entry of the port: the verifier stack a beacon node composes
(`bls_stack.build_bls_stack`, the JAX package's `node/node.py:103-152`)."""

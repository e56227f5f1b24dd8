"""Small jax-free helpers the serving stack needs (the port's own copies of
the JAX package's `utils/` modules)."""

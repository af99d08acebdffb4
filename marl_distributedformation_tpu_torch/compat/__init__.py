"""Parameter conversion from the JAX package and checkpoint-backed policies."""

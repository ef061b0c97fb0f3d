"""Index persistence: the same on-disk format as the JAX package."""

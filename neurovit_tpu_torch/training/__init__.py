"""Checkpoint interchange with the JAX package (no training yet)."""

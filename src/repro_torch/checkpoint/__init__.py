"""Checkpoints in the JAX package's layout (twin of ``repro.checkpoint``)."""

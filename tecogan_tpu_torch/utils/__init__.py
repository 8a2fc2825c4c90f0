"""Checkpoint loading, the JAX -> torch weight bridge, FLOP accounting and
GPU timing."""

"""Tensor ops of the serving path (NHWC at the public functions)."""

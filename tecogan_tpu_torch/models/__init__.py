"""Generator and its layers (NCHW channels_last inside, NHWC outside)."""

from .generator import Generator

__all__ = ["Generator"]

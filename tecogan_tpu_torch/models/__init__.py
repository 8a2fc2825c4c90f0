"""Generator, discriminator and their layers (NCHW channels_last inside,
NHWC outside)."""

from .discriminator import Discriminator
from .generator import Generator, PublishedTecoGAN

__all__ = ["Discriminator", "Generator", "PublishedTecoGAN"]

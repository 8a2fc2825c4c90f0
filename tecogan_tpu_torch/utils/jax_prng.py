"""JAX's default PRNG, reproduced bit for bit in numpy.

The JAX package draws some weights from a fixed ``jax.random.PRNGKey``
(the surrogate VGG-19, ``models.vgg.fixed_seed_vgg_params``).  This module
regenerates those draws without JAX, for JAX's threefry2x32 generator
with ``jax_threefry_partitionable`` on (JAX's default) and flax's
parameter keys:

* ``prng_key(seed)`` is the pair (0, seed mod 2**32) (JAX's default
  32-bit integers);
* ``fold_in(key, d)`` hashes the counter pair (0, d) under ``key``;
* ``random_bits(key, shape)`` hashes the flat 64-bit index of each
  element, split into (hi, lo), and returns the two output words xor'ed;
* ``uniform`` maps the top 23 bits to [1, 2), subtracts 1 and computes
  ``max(lo, f * (hi - lo) + lo)`` with ONE rounding of the multiply-add,
  as XLA's CPU backend contracts it to an FMA (two roundings differ in
  the last bit for about half the elements);
* ``flax_param_key(key, *suffix)`` is flax's ``LazyRng`` fold-in of a
  module path and a parameter counter: the first 4 bytes of the SHA-1 of
  the suffix (strings as UTF-8, ints as minimal big-endian bytes, no
  separator), read big-endian, folded into ``key``.

Everything is pure numpy on uint32 arrays (wrap-around arithmetic).
"""

from __future__ import annotations

import hashlib
from typing import Sequence, Tuple, Union

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
_MASK32 = 0xFFFFFFFF


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under ``key`` (2 uint32), as JAX lowers it."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s raw key data, 2 uint32, with JAX's
    default 32-bit integers: the seed's low 32 bits, (0, seed mod 2**32)."""
    return np.array([0, int(seed) & _MASK32], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``."""
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([int(data) & _MASK32], np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


def random_bits(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32)`` (partitionable layout)."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(_MASK32)).astype(np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(tuple(shape))


def uniform(key: np.ndarray, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    bits = random_bits(key, shape)
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    span = hi - lo  # float32, as JAX computes it
    # f * span + lo is exact in float64 (at most 47 significant bits), so
    # one rounding to float32 is the FMA's
    y = (f.astype(np.float64) * np.float64(span) + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, y)


def flax_param_key(key: np.ndarray, *suffix: Union[str, int]) -> np.ndarray:
    """The key flax's ``LazyRng`` derives from ``key`` for ``suffix``: a
    module path and the parameter's counter, e.g. ``("conv1_1", 1)`` for
    the first parameter a top-level submodule ``conv1_1`` creates."""
    m = hashlib.sha1()
    for x in suffix:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(int(x).to_bytes((int(x).bit_length() + 7) // 8, byteorder="big"))
    return fold_in(key, int.from_bytes(m.digest()[:4], byteorder="big"))

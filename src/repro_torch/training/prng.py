"""JAX's default PRNG, threefry2x32, on numpy ``uint32`` (the counterpart of
``jax.random`` as ``src/repro/training/data.py`` calls it).

The functions compute what ``jax.random`` computes with
``jax_threefry_partitionable`` on (JAX's default) and 64-bit types off, bit
for bit:

* :func:`key` — ``PRNGKey(seed)``: ``(0, seed mod 2³²)``;
* :func:`fold_in` — the hash of the counts ``(0, data)`` under the key;
* :func:`split` — ``n`` keys, the hash of the 64-bit counts ``0 … n−1``
  (high and low words) under the key;
* :func:`random_bits` — 32 bits per element: the two words of the hash of
  the element's flat index, xor-ed;
* :func:`uniform`, :func:`bernoulli` and :func:`randint` — JAX's
  ``_uniform`` over [0, 1) (23 mantissa bits under exponent 0, minus 1),
  ``_bernoulli``
  (``uniform < p``, mode "low") and ``_randint`` (two words of bits folded
  into ``span`` with JAX's wrapping ``uint32`` multiplier).

Written from the algorithms; nothing of JAX is imported.  A key is a
``(2,)`` ``uint32`` array.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(k1, k2, x1: np.ndarray, x2: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block cipher, 20 rounds, on two parallel word
    arrays ``x1``, ``x2`` under the key words ``k1``, ``k2``; all
    arithmetic wraps modulo 2³²."""
    ks = [_U32(k1), _U32(k2), _U32(k1) ^ _U32(k2) ^ _U32(_PARITY)]
    x = [np.array(x1, dtype=_U32, ndmin=1) + ks[0],
         np.array(x2, dtype=_U32, ndmin=1) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the seed's low 32 bits under a zero
    high word."""
    return np.array([0, int(seed) & 0xFFFFFFFF], dtype=_U32)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(k, data)`` for ``0 ≤ data < 2³²``."""
    if not 0 <= int(data) < 2 ** 32:
        raise OverflowError(f"fold_in data {data} out of bounds for uint32")
    a, b = threefry2x32(k[0], k[1], [0], [int(data)])
    return np.concatenate([a, b])


def _iota_2x32(shape: Tuple[int, ...]) -> Tuple[np.ndarray, np.ndarray]:
    """The flat indices of ``shape`` as 64-bit counts: (high, low) words."""
    idx = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(_U32), (idx & np.uint64(0xFFFFFFFF)).astype(_U32)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(k, num)``: (num, 2) keys."""
    hi, lo = _iota_2x32((num,))
    a, b = threefry2x32(k[0], k[1], hi, lo)
    return np.stack([a, b], axis=1)


def random_bits(k: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    """32 random bits per element of ``shape`` (``uint32``)."""
    hi, lo = _iota_2x32(tuple(shape))
    a, b = threefry2x32(k[0], k[1], hi, lo)
    return (a ^ b).reshape(shape)


def uniform(k: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    """``jax.random.uniform(k, shape)``: float32 over [0, 1).  (Another
    range would scale and shift in one rounding where XLA fuses them, in two
    here, so only the unit range is offered.)"""
    bits = random_bits(k, shape)
    one = np.array(1.0, np.float32).view(_U32)
    floats = ((bits >> _U32(32 - 23)) | one).view(np.float32) - np.float32(1.0)
    return np.maximum(np.float32(0.0), floats)


def bernoulli(k: np.ndarray, p: float, shape: Tuple[int, ...]) -> np.ndarray:
    """``jax.random.bernoulli(k, p, shape)`` for a Python float ``p``
    (weakly typed: float32)."""
    return uniform(k, shape) < np.float32(p)


def randint(k: np.ndarray, shape: Tuple[int, ...], minval: int, maxval: int
            ) -> np.ndarray:
    """``jax.random.randint(k, shape, minval, maxval, dtype=int32)`` for
    ``minval < maxval`` within int32."""
    if not -2 ** 31 <= minval < maxval <= 2 ** 31 - 1:
        raise ValueError(f"randint range [{minval}, {maxval}) outside int32")
    k1, k2 = split(k)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = np.array([maxval - minval], dtype=_U32)   # arrays: no scalar overflow warning
    mult = np.array([2 ** 16], dtype=_U32) % span
    mult = (mult * mult) % span                      # wraps modulo 2³², as JAX's
    offset = ((higher % span) * mult + lower % span) % span
    return (np.int64(minval) + offset.astype(np.int64)).astype(np.int32)

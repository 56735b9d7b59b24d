"""JAX's threefry-2x32 random numbers in numpy, bit for bit.

The reference draws its data with ``jax.random`` on threefry keys under
``jax_threefry_partitionable`` (the default since JAX 0.5):

* ``PRNGKey(seed)`` is the key ``[seed >> 32, seed & 0xffffffff]``;
* ``fold_in(key, d)`` is ``threefry2x32(key, [0, d])``;
* ``split(key, n)`` is the pair of threefry words of the counters 0 .. n - 1
  (the high and low 32 bits of each counter, as ``iota_2x32_shape`` gives);
* 32 random bits of an element of ``shape`` are the xor of the two words of
  its row-major index, counted the same way;
* ``uniform`` puts 23 of those bits under the exponent of 1.0, subtracts 1,
  and takes ``max(minval, f * (maxval - minval) + minval)`` in float32 with
  one rounding of the product and the sum (XLA fuses them into an FMA);
* ``normal`` is ``sqrt(2) * erfinv(u)`` of a uniform on (-1, 1).

Everything but ``normal`` is exact integer arithmetic or one float32
rounding, so it equals the reference's bits.  ``normal``'s erfinv runs in
float64 here and is rounded once; XLA evaluates a float32 polynomial, so
the two differ by about an ulp.
"""

from __future__ import annotations

import math

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 (20 rounds) of the counter words ``x0``, ``x1`` under
    ``key`` (two uint32)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = np.asarray(x0, np.uint32) + ks[0]
        x1 = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` of a seed below 2**32 (JAX without x64
    truncates wider ones): uint32 [high word, low word]."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32), np.array([data], np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


def _counter_words(shape) -> tuple[np.ndarray, np.ndarray]:
    n = np.arange(math.prod(shape), dtype=np.uint64).reshape(shape)
    return (n >> np.uint64(32)).astype(np.uint32), (n & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32 keys."""
    y0, y1 = threefry2x32(key, *_counter_words((num,)))
    return np.stack([y0, y1], axis=1)


def random_bits(key, shape) -> np.ndarray:
    """32 random bits an element of ``shape``."""
    y0, y1 = threefry2x32(key, *_counter_words(tuple(shape)))
    return y0 ^ y1


def _fma_f32(a: np.ndarray, b: np.float32, c: np.float32) -> np.ndarray:
    """float32 ``a * b + c`` rounded once.  The product of two float32 is
    exact in float64; the float64 sum is rounded, and where it lands on a
    float32 midpoint while its error is not 0 it is moved off the midpoint
    toward the exact value, so that the final rounding is the FMA's."""
    p = a.astype(np.float64) * np.float64(b)
    c = np.float64(c)
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)  # TwoSum: s + err is p + c exactly
    low = s.view(np.uint64) & np.uint64((1 << 29) - 1)
    mid = (low == np.uint64(1 << 28)) & (err != 0)
    s = np.where(mid, np.nextafter(s, s + err), s)
    return s.astype(np.float32)


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    bits = random_bits(key, shape)
    f = ((bits >> np.uint32(9)) | np.float32(1.0).view(np.uint32)).view(np.float32)
    f = f - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, _fma_f32(f, hi - lo, lo))


def normal(key, shape) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``, its erfinv in float64
    (about an ulp from the reference's float32 polynomial)."""
    import torch

    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = torch.from_numpy(uniform(key, shape, lo, 1.0).astype(np.float64))
    return (math.sqrt(2.0) * torch.special.erfinv(u)).numpy().astype(np.float32)

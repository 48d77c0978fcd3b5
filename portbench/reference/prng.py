"""Threefry-2x32 in plain numpy: the counter-based generator whose draws the
program makes (JAX's ``threefry_partitionable`` layout), worked out again
so that the reference needs nothing the program computed.

A key is a pair of uint32 words. ``split(key, n)[i]`` and ``fold_in(key,
d)`` are the block function of the counts (0, i) and (0, d);
``random_bits(key, n)[j]`` is the xor of the two words of the block of
(0, j); ``uniform`` puts 23 random bits into the mantissa of a float in
[1, 2); ``normal`` is sqrt(2) erfinv(u) for u uniform in (-1, 1);
``permutation`` sorts by random words, stably, ceil(3 ln n / ln(2^32 - 1))
times.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def block(k1, k2, x1, x2) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32, 20 rounds, on broadcastable uint32 arrays."""
    k1, k2, x1, x2 = (np.asarray(v, np.uint32) for v in (k1, k2, x1, x2))
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    with np.errstate(over="ignore"):
        a, b = x1 + ks[0], x2 + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                a = a + b
                b = _rotl(b, r) ^ a
            a = a + ks[(i + 1) % 3]
            b = b + ks[(i + 2) % 3] + np.uint32(i + 1)
    return a, b


def key_of(words) -> np.ndarray:
    return np.asarray(words, np.uint32).reshape(2)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """(num, 2) keys."""
    i = np.arange(num, dtype=np.uint32)
    a, b = block(key[..., 0], key[..., 1], np.zeros_like(i), i)
    return np.stack([a, b], axis=-1)


def fold_in(key: np.ndarray, data) -> np.ndarray:
    """One key for an int, or (len(data), 2) keys for an array of ints."""
    d = np.asarray(data, np.uint64).astype(np.uint32)
    a, b = block(key[0], key[1], np.zeros_like(d), d)
    return np.stack([a, b], axis=-1)


def random_bits(keys: np.ndarray, n: int) -> np.ndarray:
    """uint32 words, shape keys.shape[:-1] + (n,)."""
    j = np.arange(n, dtype=np.uint32)
    k1, k2 = keys[..., 0, None], keys[..., 1, None]
    a, b = block(k1, k2, np.zeros_like(j), j)
    return a ^ b


def uniform(keys: np.ndarray, n: int, lo: float, hi: float) -> np.ndarray:
    """float32 in [lo, hi): the scale and shift rounded once."""
    bits = (random_bits(keys, n) >> np.uint32(9)) | np.uint32(0x3F800000)
    f = bits.view(np.float32).astype(np.float64) - 1.0
    lo32, hi32 = float(np.float32(lo)), float(np.float32(hi))
    span = float(np.float32(hi32 - lo32))
    return np.maximum(np.float32(lo32), (f * span + lo32).astype(np.float32))


_NEXT_ABOVE_MINUS_ONE = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal(keys: np.ndarray, n: int) -> np.ndarray:
    """float32 standard normals, shape keys.shape[:-1] + (n,)."""
    u = uniform(keys, n, _NEXT_ABOVE_MINUS_ONE, 1.0)
    x = torch.special.erfinv(torch.from_numpy(u.astype(np.float64)))
    return (math.sqrt(2.0) * x).numpy().astype(np.float32)


def permutation(key: np.ndarray, n: int) -> np.ndarray:
    """int64 permutation of range(n)."""
    x = np.arange(n, dtype=np.int64)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(2 ** 32 - 1))
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(random_bits(sub, n), kind="stable")]
    return x

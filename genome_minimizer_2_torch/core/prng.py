"""Threefry-2x32 counter-based PRNG in torch, bit-compatible with JAX.

The JAX package's seed contract is key-per-index: sample i's latent is
``normal(fold_in(root, i), (latent_dim,))`` (genome_minimizer_2_tpu/core/
prng.py), so results never depend on chunk sizes, shard boundaries or host
counts. This module reproduces that derivation exactly, so ``--seed`` gives
the same latents, and so the same FASTA, in both packages:

- keys are int64 tensors of shape (..., 2) holding the two uint32 words of
  a JAX threefry key (torch's uint32 arithmetic is patchy, so every
  operation works in int64 and masks to 32 bits);
- ``fold_in``, ``split`` and ``random_bits`` follow JAX 0.9.0 with
  ``jax_threefry_partitionable=True`` (``jax/_src/prng.py``:
  ``threefry_fold_in``, ``_threefry_split_foldlike``,
  ``_threefry_random_bits_partitionable``);
- ``normal`` is ``sqrt(2) * erfinv(u)`` with ``u`` uniform in
  ``(nextafter(-1, 0), 1)`` built from the mantissa bits
  (``jax/_src/random.py``: ``_uniform``, ``_normal_real``). ``erfinv`` is
  XLA's float32 polynomial (Giles' approximation) written out in torch ops,
  rather than ``torch.erfinv``, so the draws agree with JAX to the last ulp
  or so (the tests hold them to 4 ulp).

Everything here is plain elementwise torch on whatever device the key lives
on; the per-chunk draw is (chunk x latent_dim) values and needs no kernel.
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block function (20 rounds) on broadcastable int64
    tensors of uint32 values; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & _M32
    b = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _M32
    return a, b


def key(seed: int, device: str | torch.device = "cuda") -> torch.Tensor:
    """``jax.random.key(seed)`` key data: [seed >> 32, seed & 0xFFFFFFFF]
    (seeds are 32-bit in JAX's default mode, so the high word is 0 for any
    seed it accepts)."""
    seed = int(seed)
    hi = (seed >> 32) & _M32 if seed >= 0 else 0
    return torch.tensor([hi, seed & _M32], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: threefry of the count pair (0, data) under
    ``key``. ``data`` may be an int or an integer tensor of indices, giving
    a (len(data), 2) batch of keys (``key`` must then be a single key)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    a, b = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([a, b], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable form): key i is the threefry of
    the 64-bit count i split into words (0, i). Returns (num, 2)."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    a, b = threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    return torch.stack([a, b], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32-bit random words, int64 tensor of shape ``key.shape[:-1] +
    shape``: word j of a key is the xor of the threefry outputs for the
    64-bit count j (partitionable layout). Shapes below 2**32 elements."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if n >= 2 ** 32:
        raise NotImplementedError("random bits beyond 2**32 words per key")
    lo = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    batch = key.shape[:-1]
    k1 = key[..., 0].reshape(batch + (1,) * len(shape))
    k2 = key[..., 1].reshape(batch + (1,) * len(shape))
    a, b = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return a ^ b


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniform in [minval, maxval): the 23 high bits of each word
    become the mantissa of a float in [1, 2), minus 1, then scaled — the
    same arithmetic as ``jax.random.uniform``."""
    bits = random_bits(key, shape)
    float_bits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = float_bits.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


# XLA's ErfInv for float32 (Giles, "Approximating the erfinv function"):
# coefficient pairs (central branch w < 5, tail branch), Horner order.
_ERFINV_COEFFS = (
    (2.81022636e-08, -0.000200214257),
    (3.43273939e-07, 0.000100950558),
    (-3.5233877e-06, 0.00134934322),
    (-4.39150654e-06, -0.00367342844),
    (0.00021858087, 0.00573950773),
    (-0.00125372503, -0.0076224613),
    (-0.00417768164, 0.00943887047),
    (0.246640727, 1.00167406),
    (1.50140941, 2.83297682),
)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function with XLA's polynomial, op for op."""
    x = x.to(torch.float32)
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    c0, c1 = _ERFINV_COEFFS[0]
    p = torch.where(lt, torch.full_like(x, c0), torch.full_like(x, c1))
    for c_lt, c_gt in _ERFINV_COEFFS[1:]:
        c = torch.where(lt, torch.full_like(x, c_lt), torch.full_like(x, c_gt))
        p = c + p * w
    out = p * x
    return torch.where(x.abs() == 1.0, x * float("inf"), out)


_NEXT_BELOW_ONE = -0.99999994  # float32 nextafter(-1, 0)


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal`` at float32: sqrt(2) * erfinv(u), u uniform in
    (nextafter(-1, 0), 1)."""
    u = uniform(key, shape, _NEXT_BELOW_ONE, 1.0)
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=torch.float32, device=key.device)
    return sqrt2 * erfinv(u)


def draw_latents(key: torch.Tensor, indices, latent_dim: int) -> torch.Tensor:
    """z_i ~ N(0, I) for each global sample index i: ``normal(fold_in(key,
    i), (latent_dim,))`` — the JAX package's ``core/prng.py::draw_latents``.
    Returns float32 (len(indices), latent_dim) on the key's device."""
    return normal(fold_in(key, indices), (latent_dim,))

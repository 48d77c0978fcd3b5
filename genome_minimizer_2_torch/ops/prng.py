"""The port's random numbers, routed by the key's device.

The port draws every key split, fold-in, uniform and normal through this
module. A CUDA key takes the hand-written kernel: each of ``split``,
``fold_in``, ``random_bits``, ``uniform`` and ``normal`` is one launch of
``csrc/threefry.cu`` (``ops/kernels.py::threefry``), ``permutation`` two a
round beside its sort, ``draw_latents`` two. Any other key takes
``core/prng.py``'s elementwise torch code, which is the kernel's plain
version: the kernel's draws equal it bit for bit, and it equals JAX's.
"""

from __future__ import annotations

import math

import torch

from ..core import prng as P
from . import kernels as K

key = P.key


def _on_card(key: torch.Tensor) -> bool:
    return key.device.type == "cuda"


def _keys(key: torch.Tensor) -> torch.Tensor:
    """The key as the kernel takes it: (2,) or a table (N, 2) of keys."""
    return key if key.dim() <= 2 else key.reshape(-1, key.shape[-1])


def _broadcast(a: tuple, b: tuple) -> tuple:
    """The broadcast of two shapes that broadcast (``torch.broadcast_shapes``
    imports ``torch._refs`` at its first call: seconds on a busy host)."""
    n = max(len(a), len(b))
    a, b = (1,) * (n - len(a)) + tuple(a), (1,) * (n - len(b)) + tuple(b)
    return tuple(x if y == 1 else y for x, y in zip(a, b))


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` (``core/prng.py::fold_in``)."""
    if not _on_card(key):
        return P.fold_in(key, data)
    if not isinstance(data, torch.Tensor):
        pairs = K.threefry(_keys(key), "pairs", first=int(data) & P._M32)
        return pairs.reshape(key.shape[:-1] + (2,))
    pairs = K.threefry(_keys(key), "pairs", counts=data)
    return pairs.reshape(_broadcast(key.shape[:-1], data.shape) + (2,))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (``core/prng.py::split``)."""
    if not _on_card(key):
        return P.split(key, num)
    return K.threefry(_keys(key), "pairs", num).reshape(key.shape[:-1] + (num, 2))


def _draw(key: torch.Tensor, shape, kind: str, minval: float = 0.0,
          maxval: float = 1.0) -> torch.Tensor:
    """One launch of the kernel: ``kind`` of ``shape`` words under each key
    of ``key`` (..., 2), shaped ``key.shape[:-1] + shape``."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if n >= 2 ** 32:
        raise NotImplementedError("random bits beyond 2**32 words per key")
    out = K.threefry(_keys(key), kind, n, minval=minval, maxval=maxval)
    return out.reshape(key.shape[:-1] + shape)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32-bit random words (``core/prng.py::random_bits``)."""
    if not _on_card(key):
        return P.random_bits(key, shape)
    return _draw(key, shape, "bits")


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniform in [minval, maxval) (``core/prng.py::uniform``)."""
    if not _on_card(key):
        return P.uniform(key, shape, minval, maxval)
    return _draw(key, shape, "uniform", minval, maxval)


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal`` at float32 (``core/prng.py::normal``)."""
    if not _on_card(key):
        return P.normal(key, shape)
    return _draw(key, shape, "normal")


def draw_latents(key: torch.Tensor, indices, latent_dim: int) -> torch.Tensor:
    """z_i ~ N(0, I) for each global sample index i
    (``core/prng.py::draw_latents``): a fold-in and a normal."""
    return normal(fold_in(key, indices), (latent_dim,))


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` (``core/prng.py::permutation``):
    each round a split and a stable sort of the rows by random bits."""
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(2 ** 32 - 1))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x

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
  (``jax/_src/random.py``: ``_uniform``, ``_normal_real``). ``erfinv`` and
  its ``log1p`` are XLA's float32 code as its CPU backend compiles it
  (Giles' polynomial, the Cephes log1p, one rounding per contracted
  multiply-add), written in IEEE ``+ - * /`` and square roots, so the draws
  equal JAX's bit for bit on the CPU and the same ops give the same bits on
  a CUDA device;
- ``permutation`` is ``jax.random.permutation``'s sort shuffle
  (``jax/_src/random.py::_shuffle``).

Everything here is plain elementwise torch on whatever device the key lives
on. It is the plain version of the hand-written kernel ``csrc/threefry.cu``,
which ``ops/prng.py`` launches for a CUDA key and which holds these bits.
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


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA's CPU backend emits it
    (it contracts a product feeding one sum into an FMA). The float64
    product of two float32 values is exact; the sum is rounded to float64
    and then to float32, which is the single rounding for all but
    vanishingly rare double-rounding ties. IEEE float64 ``*`` and ``+``
    give the same bits on the CPU and on a CUDA device."""
    a = a.double()
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a * b + c).float()


def _const(value: float, device) -> torch.Tensor:
    """A float32 0-dim constant made by a fill on ``device``: no copy from
    the host, which a captured CUDA graph cannot hold and which would wait
    for the stream (the same float32 rounding as ``torch.tensor``)."""
    return torch.full((), value, dtype=torch.float32, device=device)


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniform in [minval, maxval) (:func:`uniform_from_bits` of
    :func:`random_bits`)."""
    return uniform_from_bits(random_bits(key, shape), minval, maxval)


def uniform_from_bits(bits: torch.Tensor, minval: float = 0.0,
                      maxval: float = 1.0) -> torch.Tensor:
    """The uniform of each 32-bit word: its 23 high bits become the mantissa
    of a float in [1, 2), minus 1, then scaled — the same arithmetic as
    ``jax.random.uniform``, whose scale-and-shift XLA contracts into one
    FMA."""
    float_bits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = float_bits.view(torch.float32) - 1.0
    lo = _const(minval, bits.device)
    hi = _const(maxval, bits.device)
    return torch.maximum(lo, _fma(floats, hi - lo, lo))


_FLT_MIN = 1.1754943508222875e-38
# XLA's float32 log (Cephes logf) polynomial, as the CPU backend emits it
_LOG_P = (0.07037683576345444, -0.11514610052108765, -0.12420140951871872,
          0.14249323308467865, 0.2000071406364441, -0.24999994039535522,
          0.11676998436450958, -0.16668057441711426, 0.3333333134651184)
_LOG_Q1, _LOG_Q2 = -0.00021219444170128554, 0.693359375
# XLA's log1p rational approximation for |x| < sqrt(2) - 1 (Cephes)
_LOG1P_SMALL = 0.4142135679721832
_LOG1P_DEN = (15.062909126281738, 83.04756927490234, 221.7624053955078,
              309.0987243652344, 216.42788696289062, 60.11865997314453)
_LOG1P_NUM = (4.527000055531971e-05, 0.4985410273075104, 6.578732490539551,
              29.91191864013672, 60.949668884277344, 57.11296463012695,
              20.039552688598633)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log-plus-one`` as its CPU backend compiles it (read
    from the LLVM IR and the machine code jaxlib 0.9 emits), in IEEE
    float32 ``+ - * /`` plus the FMAs of :func:`_fma`, so the CPU and a
    CUDA device give the same bits. ``torch.log1p`` is up to 2 ulp off it.

    |x| < sqrt(2) - 1: x - x^2/2 + x^3 P(x)/Q(x); otherwise log(1 + x) by
    frexp and the Cephes logf polynomial."""
    x = x.to(torch.float32)
    # -- log(1 + x) --
    a = x + 1.0
    m = torch.where(a > _FLT_MIN, a, torch.full_like(a, _FLT_MIN))
    bits = m.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    f = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    lt = f < 0.7071067690849304
    y = (f + -1.0) + torch.where(lt, f, torch.zeros_like(f))
    e = torch.where(lt, e - 1.0, e)
    y2 = y * y
    y3 = y * y2
    c = _LOG_P
    p1 = _fma(_fma(y, c[0], c[1]), y, c[6])
    p2 = _fma(_fma(y, c[2], c[3]), y, c[7])
    p3 = _fma(_fma(y, c[4], c[5]), y, c[8])
    q = _fma(_fma(_fma(p1, y3, p2), y3, p3), y3, e * _LOG_Q1)
    large = _fma(e, _LOG_Q2, (y - y2 * 0.5) + q)
    large = torch.where(~(a > 0.0), torch.full_like(a, float("nan")), large)
    large = torch.where(a == 0.0, torch.full_like(a, float("-inf")), large)
    large = torch.where(a == float("inf"), a, large)
    # -- small |x| --
    z2 = x * x
    zero = x * 0.0
    den = zero + 1.0
    for k in _LOG1P_DEN:
        den = _fma(den, x, k)
    num = zero + _LOG1P_NUM[0]
    for k in _LOG1P_NUM[1:]:
        num = _fma(num, x, k)
    small = x + ((x * z2) * (num / den) - z2 * 0.5)
    return torch.where(x.abs() < _LOG1P_SMALL, small, large)


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


def _coeff(lt: torch.Tensor, pair) -> torch.Tensor:
    """The float32 coefficient of each element's branch."""
    return torch.where(lt, _const(pair[0], lt.device), _const(pair[1], lt.device))


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function as XLA's CPU backend computes it:
    its polynomial, its :func:`log1p`, and one rounding per Horner step."""
    x = x.to(torch.float32)
    lg = log1p(x * -x)  # w = -lg
    lt = lg > -5.0
    # the float64 root rounded to float32 is the correctly rounded float32
    # root (torch's float32 sqrt on the CPU is not always)
    w = torch.where(lt, -2.5 - lg, (-lg).double().sqrt().float() - 3.0)
    p = _coeff(lt, _ERFINV_COEFFS[0])
    for pair in _ERFINV_COEFFS[1:]:
        p = _fma(p, w, _coeff(lt, pair))
    return torch.where(x.abs() == 1.0, x * float("inf"), x * p)


_NEXT_BELOW_ONE = -0.99999994  # float32 nextafter(-1, 0)


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal`` at float32 (:func:`normal_from_bits` of
    :func:`random_bits`)."""
    return normal_from_bits(random_bits(key, shape))


def normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """The normal of each 32-bit word: sqrt(2) * erfinv(u), u its uniform in
    (nextafter(-1, 0), 1)."""
    u = uniform_from_bits(bits, _NEXT_BELOW_ONE, 1.0)
    return _const(math.sqrt(2.0), bits.device) * erfinv(u)


def draw_latents(key: torch.Tensor, indices, latent_dim: int) -> torch.Tensor:
    """z_i ~ N(0, I) for each global sample index i: ``normal(fold_in(key,
    i), (latent_dim,))`` — the JAX package's ``core/prng.py::draw_latents``.
    Returns float32 (len(indices), latent_dim) on the key's device."""
    return normal(fold_in(key, indices), (latent_dim,))


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``ceil(3 ln n / ln(2**32 - 1))``
    rounds, each ``key, sub = split(key)`` and a stable sort of
    ``arange(n)`` by 32-bit ``random_bits(sub, (n,))``. Returns int64 (n,)
    on the key's device."""
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(2 ** 32 - 1))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x

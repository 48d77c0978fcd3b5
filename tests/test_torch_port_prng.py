"""The port's torch threefry against JAX (0.9.0, partitionable threefry):
keys, random bits, uniforms and permutations exactly equal; ``log1p``,
``erfinv`` and normal draws within 0 ulp of XLA's CPU code (the port writes
out its float32 polynomials with one rounding per contracted multiply-add)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from genome_minimizer_2_torch.core import prng as P
from genome_minimizer_2_torch.ops import kernels as K
from genome_minimizer_2_torch.ops import prng as R
from genome_minimizer_2_tpu.core.prng import draw_latents as jax_draw_latents

SEEDS = (0, 5, 12345, 2 ** 31 - 1)
NORMAL_ULP = 0
NORMAL_DRAWS = 131_072  # per seed; four seeds give over 5e5 draws


def _ulp(a: np.ndarray, b: np.ndarray) -> int:
    """Max distance in float32 ulps (both arrays share signs where it
    matters: a sign flip counts as a huge distance)."""
    ai = a.astype(np.float32).view(np.int32).astype(np.int64)
    bi = b.astype(np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ai - bi).max())


def _kd(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_matches(seed):
    np.testing.assert_array_equal(P.key(seed, "cpu").numpy(),
                                  _kd(jax.random.key(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_matches(seed):
    kj, kt = jax.random.key(seed), P.key(seed, "cpu")
    for data in (0, 1, 7, 511, 2 ** 31 + 3):
        np.testing.assert_array_equal(P.fold_in(kt, data).numpy(),
                                      _kd(jax.random.fold_in(kj, data)))
    idx = np.arange(0, 300, 7)
    want = np.stack([_kd(jax.random.fold_in(kj, int(i))) for i in idx])
    np.testing.assert_array_equal(P.fold_in(kt, torch.as_tensor(idx)).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_split_matches(seed):
    kj, kt = jax.random.key(seed), P.key(seed, "cpu")
    for num in (2, 5):
        np.testing.assert_array_equal(P.split(kt, num).numpy(),
                                      _kd(jax.random.split(kj, num)))
    probe_j, rest_j = jax.random.split(kj)
    probe_t, rest_t = P.split(kt)
    np.testing.assert_array_equal(probe_t.numpy(), _kd(probe_j))
    np.testing.assert_array_equal(rest_t.numpy(), _kd(rest_j))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (64,), (3, 7), (513,)])
def test_random_bits_match(seed, shape):
    kj, kt = jax.random.key(seed), P.key(seed, "cpu")
    want = np.asarray(jax.random.bits(kj, shape, jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(P.random_bits(kt, shape).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_matches_exactly(seed):
    kj, kt = jax.random.key(seed), P.key(seed, "cpu")
    want = np.asarray(jax.random.uniform(kj, (4096,)))
    np.testing.assert_array_equal(P.uniform(kt, (4096,)).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_ulps(seed):
    kj, kt = jax.random.key(seed), P.key(seed, "cpu")
    want = np.asarray(jax.random.normal(kj, (NORMAL_DRAWS,)))
    got = P.normal(kt, (NORMAL_DRAWS,)).numpy()
    assert got.dtype == np.float32
    assert _ulp(got, want) <= NORMAL_ULP


def test_erfinv_within_ulps_of_xla():
    u = np.linspace(-0.9999999, 0.9999999, 100_001).astype(np.float32)
    want = np.asarray(jax.scipy.special.erfinv(jnp.asarray(u)))
    got = P.erfinv(torch.from_numpy(u)).numpy()
    assert _ulp(got, want) <= NORMAL_ULP
    edge = P.erfinv(torch.tensor([-1.0, 1.0])).numpy()
    assert np.isneginf(edge[0]) and np.isposinf(edge[1])


def test_log1p_matches_xla():
    rng = np.random.RandomState(0)
    x = np.concatenate([-rng.rand(100_000), np.linspace(-0.999999, 3.0, 100_001),
                        [0.0, -1.0, np.inf, -2.0, np.nan, 1e-30, -1e-8]]
                       ).astype(np.float32)
    want = np.asarray(jax.jit(jnp.log1p)(jnp.asarray(x)))
    got = P.log1p(torch.from_numpy(x)).numpy()
    fin = np.isfinite(want)
    assert _ulp(got[fin], want[fin]) == 0
    np.testing.assert_array_equal(got[~fin], want[~fin])


@pytest.mark.parametrize("seed", (0, 3))
@pytest.mark.parametrize("n", [1, 7, 1000, 5000])
def test_permutation_matches_exactly(seed, n):
    want = np.asarray(jax.random.permutation(jax.random.key(seed), n))
    got = P.permutation(P.key(seed, "cpu"), n)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,latent", [(0, 3), (7, 64), (123, 4)])
def test_draw_latents_matches(seed, latent):
    idx = np.arange(40, 140)
    want = np.asarray(jax_draw_latents(jax.random.key(seed), jnp.asarray(idx),
                                       latent))
    got = P.draw_latents(P.key(seed, "cpu"), torch.as_tensor(idx), latent).numpy()
    assert got.shape == (100, latent)
    assert _ulp(got, want) <= NORMAL_ULP


# -- the route by the key's device: a CPU key never reaches the kernel ------

CPU_CALLS = {
    "split": lambda m: m.split(m.key(12345, "cpu"), 3),
    "fold_in": lambda m: m.fold_in(m.key(12345, "cpu"), torch.arange(9)),
    "random_bits": lambda m: m.random_bits(m.key(12345, "cpu"), (4, 5)),
    "uniform": lambda m: m.uniform(m.key(12345, "cpu"), (33,), -2.0, 3.0),
    "normal": lambda m: m.normal(m.key(12345, "cpu"), (32, 64)),
    "draw_latents": lambda m: m.draw_latents(m.key(12345, "cpu"), torch.arange(40), 8),
    "permutation": lambda m: m.permutation(m.key(12345, "cpu"), 7000),
}


@pytest.mark.parametrize("name", list(CPU_CALLS))
def test_cpu_key_runs_no_kernel_launch(name, monkeypatch):
    """A CPU key takes core/prng.py's torch code through ops/prng.py: no
    launch of the PRNG kernel (no build is attempted) and the torch code's
    bits, which equal JAX's."""
    def no_build():
        raise AssertionError("the CUDA kernels were asked for")

    monkeypatch.setattr(K, "load_library", no_build)
    before = K.launch_counts()
    got = CPU_CALLS[name](R)
    assert K.launch_counts() == before and before["threefry"] == K.threefry.launches
    assert torch.equal(got, CPU_CALLS[name](P))
    if name == "permutation":
        want = np.asarray(jax.random.permutation(jax.random.key(12345), 7000))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("key,match", [
    (torch.zeros(2, dtype=torch.int64), "CUDA device"),
    (torch.zeros(2, dtype=torch.int32), "int64"),
    (torch.zeros(2), "int64"),
    (torch.zeros(3, dtype=torch.int64), r"\(2,\) or \(N, 2\)"),
    (torch.zeros(4, 3, dtype=torch.int64), r"\(2,\) or \(N, 2\)"),
    (torch.zeros(2, 2, 2, dtype=torch.int64), r"\(2,\) or \(N, 2\)"),
    ([0, 1], "int64 tensor"),
])
def test_threefry_refuses_before_any_build(key, match, monkeypatch):
    """The kernel's wrapper raises a clear error for a key it cannot take,
    before it builds or loads anything."""
    def no_build():
        raise AssertionError("the CUDA kernels were asked for")

    monkeypatch.setattr(K, "load_library", no_build)
    with pytest.raises(ValueError, match=match):
        K.threefry(key, "normal", 64)
    with pytest.raises(ValueError, match="kind"):
        K.threefry(torch.zeros(2, dtype=torch.int64), "gamma", 64)


@pytest.mark.parametrize("a,b", [((), (5,)), ((1,), (5,)), ((5,), ()), ((5,), (5,)),
                                 ((5,), (1,)), ((2, 3), (3,)), ((4, 1), (3,))])
def test_card_route_broadcasts_like_torch(a, b):
    """The shape a card's fold_in returns: the broadcast of the keys' and
    the indices' shapes, as torch.broadcast_shapes gives it."""
    assert R._broadcast(a, b) == tuple(torch.broadcast_shapes(a, b))

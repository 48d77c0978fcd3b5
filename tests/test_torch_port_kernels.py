"""The port's ``decode_threshold_pack`` plain version (what the wrapper runs
for CPU tensors) against the JAX package's ``decode_threshold_pack``, run
off-TPU through its own reference path as tests/test_pallas.py runs it.

Tolerance: bits must be equal wherever the JAX logit is at least 1e-5 from
0 at float32 (the two sum the K products in different orders) and at least
1e-2 from 0 at bfloat16 (operands rounded to bf16 in both, but XLA's CPU
dot may round its bf16 accumulation differently)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genome_minimizer_2_torch.ops import kernels as K
from genome_minimizer_2_tpu.ops import pallas_kernels as PK

SHAPES = [(6, 16, 50), (13, 24, 1003), (9, 32, 1000), (7, 16, 128),
          (1, 8, 7), (33, 64, 257)]
DTYPES = [("float32", torch.float32, jnp.float32, 1e-5),
          ("bfloat16", torch.bfloat16, jnp.bfloat16, 1e-2)]


def _inputs(M, Kd, N, seed):
    rng = np.random.RandomState(seed)
    h = rng.randn(M, Kd).astype(np.float32)
    w = (rng.randn(Kd, N) / np.sqrt(Kd)).astype(np.float32)
    b = (0.1 * rng.randn(N)).astype(np.float32)
    return h, w, b


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dname,tdt,jdt,tol", DTYPES)
def test_plain_version_matches_jax(shape, dname, tdt, jdt, tol):
    M, Kd, N = shape
    h, w, b = _inputs(M, Kd, N, seed=M * 1000 + N)
    want = np.asarray(PK.decode_threshold_pack(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), compute_dtype=jdt))
    got = K.decode_threshold_pack(torch.from_numpy(h), torch.from_numpy(w),
                                  torch.from_numpy(b), compute_dtype=tdt)
    assert got.dtype == torch.uint8
    assert tuple(got.shape) == want.shape == (M, (N + 7) // 8)
    jax_logits = np.asarray(PK._matmul_bias_reference(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), jdt))
    decided = np.abs(jax_logits) >= tol
    got_bits = K.unpack_bits(got.numpy(), N)
    want_bits = PK.unpack_bits(want, N)
    np.testing.assert_array_equal(got_bits[decided], want_bits[decided])
    # bits past N (the byte's padding) are 0 in both
    np.testing.assert_array_equal(
        np.unpackbits(got.numpy(), axis=1, bitorder="little")[:, N:], 0)


def test_threshold_is_strict_and_padding_packs_zero():
    """Zero weights and zero bias give logit exactly 0 -> bit 0, as the
    padded gene columns of a model do."""
    h = torch.randn(5, 8)
    w = torch.zeros(8, 24)
    w[:, :10] = torch.randn(8, 10)
    b = torch.zeros(24)
    out = K.decode_threshold_pack(h, w, b, compute_dtype=torch.float32)
    bits = K.unpack_bits(out.numpy(), 24)
    assert bits[:, 10:].sum() == 0
    np.testing.assert_array_equal(bits[:, :10],
                                  ((h @ w[:, :10]) > 0).numpy().astype(np.uint8))


@pytest.mark.parametrize("n", [8, 64, 128, 1000])
def test_pack_bits_matches_numpy_packbits(n):
    bits = (np.random.RandomState(n).rand(6, n) < 0.4).astype(np.uint8)
    got = K.pack_bits(torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(got, np.packbits(bits, axis=1,
                                                   bitorder="little"))
    np.testing.assert_array_equal(K.unpack_bits(got, n), bits)


def test_pack_bits_matches_jax_packer():
    bits = (np.random.RandomState(3).rand(4, 96) < 0.5).astype(np.uint8)
    np.testing.assert_array_equal(K.pack_bits(torch.from_numpy(bits)).numpy(),
                                  np.asarray(PK.pack_bits(jnp.asarray(bits))))


def test_pack_bits_rejects_ragged_width():
    with pytest.raises(ValueError, match="multiple of 8"):
        K.pack_bits(torch.zeros(2, 10, dtype=torch.uint8))


def test_unpack_bits_trims_to_n():
    packed = np.array([[0xFF, 0x01]], np.uint8)
    np.testing.assert_array_equal(K.unpack_bits(packed, 10),
                                  [[1, 1, 1, 1, 1, 1, 1, 1, 1, 0]])


def test_wrapper_rejects_unknown_compute_dtype():
    with pytest.raises(ValueError, match="compute dtype"):
        K.decode_threshold_pack(torch.zeros(2, 4), torch.zeros(4, 8),
                                torch.zeros(8), compute_dtype=torch.float16)

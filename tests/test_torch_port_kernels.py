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


# The gather's deal of its output over one CTA per SM (m runs of
# block_bytes), as the wrapper passes it to the kernel: the training shape
# (4,608 x 55,040 bf16 and float32) at B = 8 and B = 1, fewer runs than SMs,
# runs that are not whole chunks, 1 and 132 SMs, and the word route's units.
@pytest.mark.parametrize("m,block_bytes,sms,unit", [
    (576, 8 * 55_040 * 2, 132, 16),
    (4_608, 55_040 * 2, 132, 16),
    (576, 8 * 55_040 * 4, 132, 16),
    (24, 8 * 55_040 * 2, 132, 16),
    (100, 48_000, 132, 16),
    (100, 48_000, 1, 16),
    (4_608, 96, 132, 16),
    (7, 16, 132, 16),
    (64, 4_004, 132, 4),
    (37, 14, 132, 1),
    (37, 14, 1, 1),
])
def test_gather_split_covers_output_once_and_balances(m, block_bytes, sms, unit):
    split = K.gather_split(m, block_bytes, sms, unit)
    assert split.ctas == sms and split.unit == unit
    assert split.rounds == 0 or unit == 16  # the word route: one range a CTA
    chunks, sizes = [], []
    for c in range(sms):
        mine = list(K.gather_chunks(split, block_bytes, c))
        for off, n in mine:
            assert off // block_bytes == (off + n - 1) // block_bytes  # one run
            assert off % unit == 0 and n % unit == 0
            assert 0 < n and (n <= split.chunk or unit != 16)  # fits a stage
        chunks += mine
        sizes.append(sum(n for _, n in mine))
    pos = 0
    for off, n in sorted(chunks):  # every output byte exactly once
        assert off == pos
        pos += n
    assert pos == m * block_bytes
    assert max(sizes) - min(sizes) <= unit  # balanced to one word
    assert max(sizes) - min(sizes) <= split.chunk


def test_gather_split_deals_rounds_side_by_side():
    """In round r the CTAs copy the r-th ctas * chunk bytes of the output,
    CTA c the c-th chunk of them; the rest comes last."""
    bb = 8 * 55_040 * 2
    split = K.gather_split(576, bb, 132)
    assert split.rounds == 576 * bb // (132 * K.GATHER_CHUNK) == 117
    for c in (0, 1, 131):
        offsets = [off for off, _ in K.gather_chunks(split, bb, c)]
        starts = [(r * 132 + c) * K.GATHER_CHUNK for r in range(117)]
        assert set(starts) <= set(offsets) and offsets[0] == starts[0]
        assert offsets[-1] >= 117 * 132 * K.GATHER_CHUNK == split.rest(0)


def test_gather_split_rejects_partial_words():
    with pytest.raises(ValueError, match="16-byte words"):
        K.gather_split(3, 14, 132, 16)


@pytest.mark.parametrize("align,word", [(512 | 880_640, 16), (512 | 4_004, 4),
                                        (512 | 14, 1), (8 | 48_000, 4)])
def test_gather_route_by_alignment(align, word):
    assert K._gather_word(align) == word


# The output layer's backward plan, as the wrapper hands it to the kernels:
# H and D padded to 16-byte rows, the K splits of dh that fill an H100's
# 132 SMs (float32: two blocks of the CUDA-core dh an SM; bf16: one
# persistent block), and the scratch of the cotangent and of dh's partials.
@pytest.mark.parametrize("B,H,D,dtype,bps,splits", [
    (2048, 1024, 55_040, torch.float32, 2, 2),   # 128 tiles -> 256 blocks
    (512, 1024, 55_040, torch.float32, 2, 8),    # 32 tiles -> 256 blocks
    (856, 1024, 55_040, torch.float32, 2, 14),   # 56 tiles -> 784 blocks
    (2048, 1024, 27_520, torch.float32, 2, 2),   # a gene slice of model 2
    (2048, 1024, 55_040, torch.float32, 1, 1),   # one block an SM: no split
    (64, 32, 1003, torch.float32, 2, 12),        # ragged D
    (1, 40, 300, torch.float32, 2, 12),
    (2048, 1024, 55_040, torch.bfloat16, 1, 2),  # the tensor-core route's
    (512, 1024, 55_040, torch.bfloat16, 1, 8),
])
def test_bwd_plan_splits_and_scratch(B, H, D, dtype, bps, splits):
    plan = K.bwd_plan(B, H, D, dtype, 132, bps)
    assert plan.hidden == -(-H // 8) * 8 and plan.genes == -(-D // 8) * 8
    assert plan.splits == splits
    assert plan.dl == (B, plan.genes)
    assert plan.ws == ((splits, B, plan.hidden) if splits > 1 else None)
    tile, depth = ((K.SGEMM_TILE, K.SGEMM_DEPTH) if dtype == torch.float32
                   else (K.GEMM_TILE, K.GEMM_DEPTH))
    assert splits <= min(16, -(-plan.genes // depth))
    if B >= 512:  # the split fills the card's rounds of blocks
        blocks = -(-B // tile[0]) * -(-plan.hidden // tile[1]) * splits
        slots = 132 * bps
        assert blocks / (-(-blocks // slots) * slots) >= 0.96


def test_dh_splits_bf16_rule_is_the_default():
    """The float32 rule's arguments leave the tensor-core route's count as
    it was: 128 x 256 tiles, K blocks of 64, one block an SM."""
    for B in (1, 100, 512, 856, 2048):
        assert K.dh_splits(B, 1024, 55_040, 132) == K.dh_splits(
            B, 1024, 55_040, 132, (128, 256), 64)


# The bf16 decode's plan (csrc/gemm_cluster_sm90.cuh), as its kernel walks
# it: clusters of 128-row tiles along M, units dealt to clusters in turn.
# Clusters an H100 80GB HBM3 holds at once, by size, as
# cudaOccupancyMaxActiveClusters reports them for the decode's kernel (a
# cluster's CTAs share a GPC: 4-CTA clusters leave 12 of its 132 SMs idle).
CLUSTERS_H100 = {1: 132, 2: 66, 4: 30}
DECODE_SHAPES = [(512, 55_040, 1024), (512, 27_520, 1024), (1024, 55_040, 1024),
                 (1, 8, 64), (65, 136, 40), (129, 1008, 1000), (300, 1008, 1024),
                 (257, 520, 64), (100, 55_040, 1024)]


def _plans():
    return [K.decode_plan(M, N, Kd, CLUSTERS_H100.get) for M, N, Kd in DECODE_SHAPES]


@pytest.mark.parametrize("plan", _plans(), ids=lambda p: f"{p.M}x{p.N}x{p.K}")
def test_gemm_units_cover_every_tile_once(plan):
    """Every (row tile, column tile) of the product is computed exactly
    once, over all of K; the tiles a cluster adds past M compute zeros."""
    seen = {}
    for _, _, _, m0, n0 in K.gemm_units(plan):
        seen[(m0, n0)] = seen.get((m0, n0), 0) + 1
    assert set(seen.values()) == {1}
    real = {(m * K.GEMM_TILE[0], n * K.GEMM_TILE[1]) for m in range(plan.m_tiles)
            for n in range(plan.n_tiles)}
    assert real <= set(seen)
    assert all(m0 >= plan.M for m0, _ in set(seen) - real)
    assert plan.k_blocks == -(-plan.K // K.GEMM_DEPTH)


@pytest.mark.parametrize("plan", _plans(), ids=lambda p: f"{p.M}x{p.N}x{p.K}")
def test_cluster_shapes_divide_the_grid(plan):
    """A cluster is 1, 2 or 4 CTAs, no more than M's row tiles need; the
    grid is whole clusters, no more than the card holds at once nor than
    there are units; the CTAs of a cluster take consecutive row tiles of one
    column strip at one turn."""
    assert plan.cm in (1, 2, 4)
    assert plan.cm == 1 or plan.cm // 2 < plan.m_tiles
    assert plan.clusters == min(plan.units, CLUSTERS_H100[plan.cm])
    by_turn = {}
    for c, rank, turn, m0, n0 in K.gemm_units(plan):
        by_turn.setdefault((c, turn), []).append((rank, m0, n0))
    assert len(by_turn) == plan.units
    for tiles in by_turn.values():
        assert [r for r, _, _ in tiles] == list(range(plan.cm))
        assert len({n0 for _, _, n0 in tiles}) == 1
        assert [m0 for _, m0, _ in tiles] == [tiles[0][1] + K.GEMM_TILE[0] * r
                                             for r in range(plan.cm)]
        assert tiles[0][1] % (K.GEMM_TILE[0] * plan.cm) == 0


@pytest.mark.parametrize("M,N,Kd", DECODE_SHAPES)
def test_fill_rule_takes_the_cluster_with_the_least_work(M, N, Kd):
    """The decode takes the cluster size whose busiest CTA runs the fewest
    k blocks (rounds of units times a unit's depth, at the clusters the
    card holds), the larger cluster among equals: at the pipeline's shape
    2 (66 clusters, 430 units: 7 rounds) before 4 (30 clusters: 15)."""
    plan = K.decode_plan(M, N, Kd, CLUSTERS_H100.get)
    candidates = [K.gemm_plan(M, N, Kd, cm, CLUSTERS_H100.get)
                  for cm in K.cluster_sizes(M)]
    assert plan in candidates
    cost = K.plan_cost(plan)
    assert all(cost < K.plan_cost(c) or (cost == K.plan_cost(c) and plan.cm >= c.cm)
               for c in candidates)
    if (M, N) == (512, 55_040):
        assert (plan.cm, plan.clusters, K.plan_cost(plan)) == (2, 66, 7 * 16)


@pytest.mark.parametrize("cm", [1, 2, 4])
def test_stage_shares_cover_the_stage_once(cm):
    """The CTAs of a cluster load disjoint boxes of a W stage that together
    are all of it, each 64 columns wide (one 128-byte swizzle span) and
    whole 8-row swizzle atoms deep."""
    shares = K.stage_shares(cm)
    assert len(shares) == cm
    cells = [(k, n) for share in shares for k0, n0, rows, cols in share
             for k in range(k0, k0 + rows) for n in range(n0, n0 + cols)]
    assert sorted(cells) == [(k, n) for k in range(K.GEMM_DEPTH)
                             for n in range(K.GEMM_TILE[1])]
    for k0, n0, rows, cols in (box for share in shares for box in share):
        assert k0 % 8 == 0 and rows % 8 == 0 and cols == 64 and n0 % 64 == 0

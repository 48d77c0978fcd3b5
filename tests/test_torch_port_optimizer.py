"""The launch plan of the port's clip + Adam kernel (``ops/kernels.py::
clip_adam_plan``), pure Python as the kernel cuts its work: every value of
every leaf is updated by exactly one unit, a vector unit only at a 16-byte
aligned chunk of all four arrays, the units split evenly over the blocks,
up to 64 leaves a launch, and a leaf of no values refused. Then the
multi-leaf entry point's plain version on the CPU against the per-leaf one.
Nothing here needs a card or JAX."""

import numpy as np
import pytest
import torch

from genome_minimizer_2_torch.ops import kernels as K

UNIT, TILE = K.CLIP_ADAM_UNIT, K.CLIP_ADAM_TILE
WARPS = K.CLIP_ADAM_THREADS // 32


# The kernel's arithmetic (csrc/clip_adam.cu), mirrored on the host.

def unit_values(leaf, u):
    """The values of ``leaf`` its unit ``u`` updates: an aligned chunk of
    the vector path, or up to UNIT values of the head, then of the tail
    after the chunks."""
    if u < leaf.chunks:
        return list(range(leaf.head + u * UNIT, leaf.head + (u + 1) * UNIT))
    k0, scalar = (u - leaf.chunks) * UNIT, leaf.n - leaf.chunks * UNIT
    return [k if k < leaf.head else k + leaf.chunks * UNIT
            for k in range(k0, min(k0 + UNIT, scalar))]


def warp_tiles(units, blocks, b, w):
    """The first units of the tiles warp ``w`` of block ``b`` takes: the
    grid's warps sweep the units together, tile by tile."""
    return range((b * WARPS + w) * TILE, units, blocks * WARPS * TILE)


def whole_tile(leaf, local):
    """Whether the tile from the leaf's unit ``local`` lies wholly on its
    vector path (warp-wide loads), else it goes value by value."""
    return local + TILE <= leaf.chunks


def _arrays(offset, moment_bytes=2, base=1 << 20):
    """(address, bytes a value) of g, m, v, p: four allocations of aligned
    bases, each a view at ``offset`` values."""
    sizes = (4, moment_bytes, moment_bytes, 4)
    return [(base * (i + 1) + offset * s, s) for i, s in enumerate(sizes)]


def _covered(leaf):
    values = [e for u in range(leaf.units) for e in unit_values(leaf, u)]
    return sorted(values) == list(range(leaf.n)) and len(values) == leaf.n


@pytest.mark.parametrize("moment_bytes", [4, 2])
@pytest.mark.parametrize("n", [1, 7, 8, 9, 15, 16, 17, 1000, 1_000_003])
@pytest.mark.parametrize("offset", [0, 1, 3, 4, 7])
def test_every_value_once_and_vector_units_aligned(n, offset, moment_bytes):
    arrays = _arrays(offset, moment_bytes)
    [[leaf]] = K.clip_adam_plan([(n, arrays)])
    assert leaf.begin == 0
    if n <= 1000:
        assert _covered(leaf)
    else:  # the scalar units cover the head and the tail, once each
        scalar = [e for u in range(leaf.chunks, leaf.units)
                  for e in unit_values(leaf, u)]
        head = max(leaf.head, 0) if leaf.chunks else n
        assert scalar == list(range(head)) + list(
            range(head + leaf.chunks * UNIT, n))
        assert unit_values(leaf, leaf.chunks - 1)[-1] == \
            head + leaf.chunks * UNIT - 1
    if leaf.head >= 0:
        for addr, size in arrays:
            assert (addr + leaf.head * size) % 16 == 0
        assert leaf.head < UNIT and n - leaf.head >= UNIT
        assert leaf.chunks == (n - leaf.head) // UNIT
        # head and tail each fit in one scalar unit
        assert leaf.units - leaf.chunks <= 2
    else:
        assert leaf.chunks == 0 and leaf.units == -(-n // UNIT)
    # the head: the values before the first aligned value of g, m, v and p
    want = (-offset) % (16 // min(4, moment_bytes)) if n >= UNIT + 7 else None
    if want is not None:
        assert leaf.head == want


def test_head_is_minus_one_where_the_arrays_share_no_aligned_value():
    # g aligned at value 0, p at value 1: no value aligns both
    arrays = [(1 << 20, 4), (2 << 20, 2), (3 << 20, 2), ((4 << 20) + 12, 4)]
    [[leaf]] = K.clip_adam_plan([(100, arrays)])
    assert leaf.head == -1 and leaf.chunks == 0 and leaf.units == 13
    assert _covered(leaf)
    assert unit_values(leaf, 12) == [96, 97, 98, 99]


def test_units_are_numbered_over_the_leaves_of_a_launch():
    sizes = [1, 7, 8, 1_000_003, 55_040, 64]
    [launch] = K.clip_adam_plan([(n, _arrays(0)) for n in sizes])
    assert [a.n for a in launch] == sizes
    assert launch[0].begin == 0
    for a, b in zip(launch, launch[1:]):
        assert b.begin == a.begin + a.units
    total = launch[-1].begin + launch[-1].units
    assert total == sum(-(-n // UNIT) for n in sizes)  # aligned: chunks + tail


@pytest.mark.parametrize("units,sms", [(1, 132), (511, 132), (513, 132),
                                       (14_648_304, 132), (7_599_744, 132),
                                       (100_000, 7)])
def test_warps_sweep_every_unit_once(units, sms):
    """The grid's warps take tiles of 32 units in turn, one moving front:
    every unit once, and in each round of tiles the warps' tiles are
    side by side."""
    blocks = K.clip_adam_blocks(units, sms)
    assert 1 <= blocks <= sms
    assert blocks == min(sms, -(-units // (WARPS * TILE)))
    tiles = [warp_tiles(units, blocks, b, w)
             for b in range(blocks) for w in range(WARPS)]
    if units < 1_000_000:
        starts = sorted(t for r in tiles for t in r)
        assert starts == list(range(0, units, TILE))
    else:
        assert sum(len(r) for r in tiles) == -(-units // TILE)
    front = [r[0] for r in tiles if len(r)]
    assert front == list(range(0, len(front) * TILE, TILE))


def test_tiles_go_wide_only_on_one_leafs_vector_path():
    """A tile takes the warp-wide loads only where its 32 units are chunks
    of one leaf; a leaf's head, tail and boundary go value by value, and
    the leaves of the v0 model put all but a few tiles on the wide path."""
    [[a, b]] = K.clip_adam_plan([(1000, _arrays(1)), (70_000, _arrays(0))])
    assert a.head == 7 and a.chunks == 124 and a.units == 125
    assert whole_tile(a, 0) and whole_tile(a, 92)
    assert not whole_tile(a, 93 + 3)  # reaches the tail
    assert b.begin == 125 and whole_tile(b, 0)
    assert not whole_tile(b, b.chunks - 31)
    sizes = [55_040 * 1024, 1024, 1024, 1024, 1024 * 64, 64, 64 * 1024, 64,
             64 * 1024, 1024, 1024, 1024, 1024 * 55_040, 55_040]
    [leaves] = K.clip_adam_plan([(n, _arrays(0)) for n in sizes])
    total = leaves[-1].begin + leaves[-1].units
    narrow, l = [], 0
    for w0 in range(0, total, TILE):  # the kernel's walk
        while l + 1 < len(leaves) and w0 >= leaves[l + 1].begin:
            l += 1
        if not whole_tile(leaves[l], w0 - leaves[l].begin):
            narrow.append(w0)
    assert total // TILE > 400_000
    assert len(narrow) <= 2 * len(sizes)


@pytest.mark.parametrize("leaves,launches", [(1, 1), (30, 1), (64, 1), (65, 2),
                                             (128, 2), (129, 3)])
def test_at_most_64_leaves_a_launch(leaves, launches):
    plan = K.clip_adam_plan([(10 + i, _arrays(0)) for i in range(leaves)])
    assert len(plan) == launches
    assert [len(p) for p in plan] == [min(64, leaves - 64 * i)
                                      for i in range(launches)]
    for launch in plan:  # each launch numbers its units from 0
        assert launch[0].begin == 0


@pytest.mark.parametrize("sizes", [[0], [5, 0, 3]])
def test_a_leaf_of_no_values_is_refused(sizes):
    with pytest.raises(ValueError, match="no values"):
        K.clip_adam_plan([(n, _arrays(0)) for n in sizes])


@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_leaves_entry_on_the_cpu_is_the_per_leaf_plain_version(moments, max_norm):
    """On CPU tensors the multi-leaf entry takes its plain version: bit-equal
    to the per-leaf one, leaf by leaf, ragged sizes and a view at an odd
    offset included."""
    rng = np.random.RandomState(4)
    sizes = [1, 7, 8, 1003]
    base = [rng.randn(n + 1).astype(np.float32) for n in sizes]
    g = [torch.from_numpy(b[1:].copy() * 0.3) for b in base]
    m = [torch.from_numpy(0.01 * b).to(moments)[1:] for b in base]  # odd views
    v = [torch.from_numpy(1e-4 * np.abs(b[1:])).to(moments) for b in base]
    p = [torch.from_numpy(b[1:].copy()) for b in base]
    scalars = torch.tensor([2.5, 0.271, 0.00399, 1e-3])
    m2, v2, p2 = ([t.clone() for t in x] for x in (m, v, p))
    K.clip_adam_apply_leaves(g, m, v, p, scalars, max_norm)
    for i in range(len(sizes)):
        K.clip_adam_apply_reference(g[i], m2[i], v2[i], p2[i], scalars, max_norm)
        assert torch.equal(p[i], p2[i]) and torch.equal(m[i], m2[i])
        assert torch.equal(v[i], v2[i])
    with pytest.raises(ValueError, match="one g, m, v and p a leaf"):
        K.clip_adam_apply_leaves(g, m, v[:-1], p, scalars, max_norm)

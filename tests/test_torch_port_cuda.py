"""Card-only tests of the port: the hand-written CUDA kernel against its
plain version, and the streaming pipeline on the card. They skip without a
CUDA device. On a machine with one (and without JAX), run them with

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

(``--noconftest``: tests/conftest.py configures JAX, which the port never
needs). This file imports nothing of JAX or the JAX package."""

import importlib.util
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from genome_minimizer_2_torch.ops import kernels as K

pytestmark = pytest.mark.cuda
REPO = Path(__file__).resolve().parents[1]

# A bit may differ from the plain version only where the plain logit lies
# within this of 0 (the two sum K float32 products in different orders).
NEAR_ZERO = 1e-3


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bits(packed: torch.Tensor, n: int) -> np.ndarray:
    return K.unpack_bits(packed.cpu().numpy(), n)


@pytest.mark.parametrize("M,Kd,N", [(512, 1024, 55_040), (300, 1024, 1003),
                                    (300, 1024, 1000), (1, 64, 7), (65, 33, 129),
                                    # K not a multiple of a stage (16 / 64)
                                    (129, 1000, 1003), (300, 40, 55_040),
                                    # a gene slice of the model axis of 2
                                    (512, 1024, 27_520), (658, 1024, 27_520),
                                    # bf16: clusters of 2 and 4 with row
                                    # tiles past M, N past the last tile,
                                    # the sampler's chunk of 1,024
                                    (100, 1024, 55_040), (257, 64, 520),
                                    (1024, 1024, 55_040)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda, M, Kd, N, dtype):
    gen = torch.Generator(device=cuda).manual_seed(M + N)
    h = torch.randn(M, Kd, generator=gen, device=cuda)
    w = (torch.randn(Kd, N, generator=gen, device=cuda) / math.sqrt(Kd)).to(dtype)
    b = torch.randn(N, generator=gen, device=cuda) * 0.1
    before = K.decode_threshold_pack.launches
    out = K.decode_threshold_pack(h, w, b, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert K.decode_threshold_pack.launches == before + 1
    assert out.dtype == torch.uint8 and tuple(out.shape) == (M, (N + 7) // 8)
    ref = K.decode_threshold_pack_reference(h, w, b, dtype)
    logits = K.decode_logits_reference(h, w, b, dtype).cpu().numpy()
    diff = _bits(out, N) != _bits(ref, N)
    assert np.all(np.abs(logits[diff]) < NEAR_ZERO)
    assert diff.sum() <= 1e-5 * M * N
    assert np.unpackbits(out.cpu().numpy(), axis=1,
                         bitorder="little")[:, N:].sum() == 0


def test_kernel_rejects_mixed_devices(cuda):
    with pytest.raises(ValueError, match="CUDA"):
        K.decode_threshold_pack(torch.zeros(2, 4, device=cuda),
                                torch.zeros(4, 8), torch.zeros(8, device=cuda),
                                compute_dtype=torch.float32)


def test_pipeline_on_card_launches_once_per_chunk(cuda, tmp_path):
    from genome_minimizer_2_torch import pipeline
    from genome_minimizer_2_torch.core import prng
    from genome_minimizer_2_torch.genome.genbank import Feature, GenBankRecord
    from genome_minimizer_2_torch.genome.minimizer import MinimizerEngine
    from genome_minimizer_2_torch.models import vae
    from genome_minimizer_2_torch.sample.sampler import Sampler

    D, n, chunk = 300, 37, 8
    rng = np.random.RandomState(0)
    genes = [f"g{i:03d}" for i in range(D)]
    seq = "".join(rng.choice(list("ACGT"), 20_000))
    feats = [Feature("gene", int(s), int(s) + 150, 1, {"gene": [genes[i]]})
             for i, s in enumerate(rng.choice(19_000, 100, replace=False))]
    engine = MinimizerEngine.from_record(GenBankRecord("t", seq, feats))
    cfg = vae.VAEConfig(input_dim=D, hidden_dim=32, latent_dim=4)
    model = vae.init(cfg, torch.Generator(device=cuda).manual_seed(0))
    sampler = Sampler(model=model, chunk_size=64)
    before = K.decode_threshold_pack.launches
    stats = pipeline.sample_and_minimize(
        sampler, engine, np.array(genes, dtype=object), {genes[0]}, n,
        str(tmp_path / "o.fasta"), key=prng.key(3, cuda), chunk_size=chunk,
        process_index=0, process_count=1)
    assert K.decode_threshold_pack.launches - before == math.ceil(n / chunk)
    assert stats.genomes == n
    assert (tmp_path / "o.fasta").read_text().count(">") == n

    # the feature-bits transfer: one launch a chunk, the same FASTA
    before = K.decode_threshold_pack.launches
    pipeline.sample_and_minimize(
        sampler, engine, np.array(genes, dtype=object), {genes[0]}, n,
        str(tmp_path / "fb.fasta"), key=prng.key(3, cuda), chunk_size=chunk,
        process_index=0, process_count=1, transfer="feature-bits")
    assert K.decode_threshold_pack.launches - before == math.ceil(n / chunk)
    body = lambda p: p.read_bytes().split(b"\n", 3)[3]  # noqa: E731
    assert body(tmp_path / "fb.fasta") == body(tmp_path / "o.fasta")


def test_feature_decoder_on_card_matches_cpu_gather(cuda):
    """The keep bits gathered on the card equal the host gather of the
    card's own packed mask: present | essential, -1 columns the flag."""
    from genome_minimizer_2_torch.models import vae
    from genome_minimizer_2_torch.sample.sampler import Sampler

    D, rows = 1003, 70
    rng = np.random.RandomState(2)
    cfg = vae.VAEConfig(input_dim=D, hidden_dim=32, latent_dim=4)
    sampler = Sampler(model=vae.init(cfg, torch.Generator(device=cuda).manual_seed(1)))
    col_idx = np.concatenate([rng.randint(0, D, 500), [-1, -1, D - 1]])
    ess = rng.rand(col_idx.size) < 0.2
    z = rng.randn(rows, 4).astype(np.float32)
    packed = sampler.decode_packed_device(z, pad_to=96).wait()
    before = K.decode_threshold_pack.launches
    got = sampler.make_feature_decoder(col_idx, ess)(z, pad_to=96).wait()
    assert K.decode_threshold_pack.launches == before + 1
    assert got.shape == (96, (col_idx.size + 7) // 8)
    binary = K.unpack_bits(packed, D).astype(bool)
    padded = np.concatenate([binary, np.zeros((96, 1), bool)], axis=1)
    np.testing.assert_array_equal(K.unpack_bits(got, col_idx.size).astype(bool),
                                  padded[:, col_idx] | ess[None, :])


# ---------------------------------------------------------------------------
# the training slice's kernels and draws
# ---------------------------------------------------------------------------

def test_normal_draws_on_card_equal_cpu_draws(cuda):
    """The port's normals use IEEE + - * / and square roots only, so the
    card's draws equal the CPU's bit for bit (and the CPU's equal JAX's)."""
    from genome_minimizer_2_torch.core import prng

    for seed in (0, 12345):
        cpu = prng.normal(prng.key(seed, "cpu"), (131_072,))
        card = prng.normal(prng.key(seed, cuda), (131_072,)).cpu()
        assert torch.equal(cpu, card)
        assert torch.equal(prng.permutation(prng.key(seed, "cpu"), 5000),
                           prng.permutation(prng.key(seed, cuda), 5000).cpu())


# The PRNG kernel (csrc/threefry.cu, through ops/prng.py on a CUDA key)
# against the torch route (core/prng.py) on CPU keys, bit for bit: the
# steps' noise shapes, a large and an odd count
PRNG_SEEDS = (0, 12345, 2 ** 31 - 1)
PRNG_SHAPES = [(32, 64), (24, 64), (32, 32), (16, 32), (131_072,), (1_001,)]


def _launches(fn):
    """fn's result and the PRNG kernel's launches while it ran."""
    before = K.threefry.launches
    out = fn()
    torch.cuda.synchronize()
    return out, K.threefry.launches - before


@pytest.mark.parametrize("num", [2, 10])
def test_threefry_split_equals_torch_route(cuda, num):
    from genome_minimizer_2_torch.core import prng as P
    from genome_minimizer_2_torch.ops import prng

    for seed in PRNG_SEEDS:
        got, n = _launches(lambda: prng.split(prng.key(seed, cuda), num))  # noqa: B023
        assert n == 1 and got.dtype == torch.int64 and got.shape == (num, 2)
        assert torch.equal(got.cpu(), P.split(P.key(seed, "cpu"), num))


def test_threefry_fold_in_equals_torch_route(cuda):
    """A table of 16,384 indices under one key, an int under one key and
    under a table of keys, and a table of keys with one index each."""
    from genome_minimizer_2_torch.core import prng as P
    from genome_minimizer_2_torch.ops import prng

    idx = torch.arange(16_384, dtype=torch.int64)
    for seed in PRNG_SEEDS:
        kc, kd = P.key(seed, "cpu"), prng.key(seed, cuda)
        got, n = _launches(lambda: prng.fold_in(kd, idx.to(cuda)))  # noqa: B023
        assert n == 1 and torch.equal(got.cpu(), P.fold_in(kc, idx))
        for data in (0, 7, 2 ** 31 + 3):
            got, n = _launches(lambda: prng.fold_in(kd, data))  # noqa: B023
            assert n == 1 and torch.equal(got.cpu(), P.fold_in(kc, data))
        table = P.fold_in(kc, idx[:100])
        got, n = _launches(lambda: prng.fold_in(table.to(cuda), 5))  # noqa: B023
        assert n == 1 and torch.equal(got.cpu(), P.fold_in(table, 5))
        got, _ = _launches(lambda: prng.fold_in(table.to(cuda), idx[:100].to(cuda)))  # noqa: B023
        assert torch.equal(got.cpu(), P.fold_in(table, idx[:100]))


@pytest.mark.parametrize("shape", PRNG_SHAPES)
@pytest.mark.parametrize("kind", ["random_bits", "uniform", "normal"])
def test_threefry_draws_equal_torch_route(cuda, kind, shape):
    from genome_minimizer_2_torch.core import prng as P
    from genome_minimizer_2_torch.ops import prng

    fn, plain = getattr(prng, kind), getattr(P, kind)
    for seed in PRNG_SEEDS:
        got, n = _launches(lambda: fn(prng.key(seed, cuda), shape))  # noqa: B023
        want = plain(P.key(seed, "cpu"), shape)
        assert n == 1 and got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.cpu(), want)
    if kind == "uniform":  # Xavier's bounds, as init_from_key draws them
        got = prng.uniform(prng.key(3, cuda), shape, -0.0473, 0.0473)
        assert torch.equal(got.cpu(), P.uniform(P.key(3, "cpu"), shape,
                                                -0.0473, 0.0473))


def test_threefry_draw_latents_and_permutation_equal_torch_route(cuda):
    """The sampler's draw at 16,384 x 64 (fold_in, then normal: two
    launches) and the shuffle's permutation of 7,000 rows (two rounds of a
    split and random bits: four launches)."""
    from genome_minimizer_2_torch.core import prng as P
    from genome_minimizer_2_torch.ops import prng

    idx = torch.arange(16_384, dtype=torch.int64)
    for seed in PRNG_SEEDS:
        got, n = _launches(lambda: prng.draw_latents(prng.key(seed, cuda),  # noqa: B023
                                                     idx.to(cuda), 64))
        assert n == 2 and got.shape == (16_384, 64)
        assert torch.equal(got.cpu(), P.draw_latents(P.key(seed, "cpu"), idx, 64))
        got, n = _launches(lambda: prng.permutation(prng.key(seed, cuda), 7000))  # noqa: B023
        assert n == 4
        assert torch.equal(got.cpu(), P.permutation(P.key(seed, "cpu"), 7000))


def test_threefry_init_from_key_equals_torch_route(cuda):
    """v2's parameters at full width from one key: a split of 10 and nine
    Xavier uniforms, 56.4 M values."""
    from genome_minimizer_2_torch.models import vae
    from genome_minimizer_2_torch.ops import prng
    from genome_minimizer_2_torch.utils.config import get_v2_config

    v2 = get_v2_config()
    cfg = vae.VAEConfig(55_039, v2.hidden_dim, v2.latent_dim)
    got, n = _launches(lambda: vae.init_from_key(cfg, prng.key(7, cuda)))
    want = vae.init_from_key(cfg, prng.key(7, "cpu"))
    assert n == 10
    gl, wl = got.flat_params(), want.flat_params()
    assert gl.keys() == wl.keys()
    assert all(torch.equal(gl[k].cpu(), wl[k]) for k in wl)


def test_threefry_transforms_every_mantissa(cuda):
    """Every uniform the kernel can make (the 23 bits it keeps of a word)
    through its uniform and normal transforms, against the torch route's
    (``_fma``, ``erfinv``, ``log1p``) on the same words on the CPU."""
    from genome_minimizer_2_torch.core import prng as P

    words = torch.arange(2 ** 23, dtype=torch.int64) << 9
    normal = K.threefry_words(words.to(cuda), "normal").cpu()
    uniform = K.threefry_words(words.to(cuda), "uniform", -0.0473, 0.0473).cpu()
    for part in torch.arange(2 ** 23).chunk(16):
        w = words[part]
        assert torch.equal(normal[part], P.normal_from_bits(w))
        assert torch.equal(uniform[part], P.uniform_from_bits(w, -0.0473, 0.0473))


def test_threefry_captured_epoch_launches(cuda):
    """A captured v0 epoch at batch 32 over 7,000 rows (219 steps, the exact
    row permutation) and 40 validation rows (2 steps): the PRNG kernel
    launches twice a step, a split and a draw, and five times a shuffle (the
    state key's split, then two rounds of a split and random bits); the
    replays count what their captures recorded."""
    t = _graph_trainer(cuda, "bfloat16", 32)
    x, xv = (t.prepare_data(a) for a in _graph_data(7000))
    state = t.init_state()
    for _ in range(2):
        K.reset_launch_counts()
        t.graphed_epoch(state, x, 7000, train=True)
        t.graphed_epoch(state, xv, 40, train=False)
        torch.cuda.synchronize()
        assert K.threefry.launches == 5 + 2 * 219 + 2 * 2
    assert K.threefry.replayed == 5 + 2 * 219 + 2 * 2
    graphs = {name: launches["threefry"] for prog in t._epoch_fns.values()
              for name, _, launches in prog.graphs}
    assert graphs == {"gm2/shuffle": 5, "gm2/train_step": 2 * 219, None: 2 * 2}


# A bf16 value computed from a float32 sum on the card and on the CPU, or
# by a kernel and its plain version, may round either way where the two
# sums differ in their last bits: each element within 1 bf16 ulp, or, where
# the sum cancels, within CANCEL of the sum of its terms' magnitudes.
CANCEL = 2.0 ** -16


def _bf16_outside(o, r, terms) -> int:
    def ordered(x):
        i = x.to(torch.bfloat16).view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    far = (o - r).abs() > CANCEL * terms
    return int((((ordered(o) - ordered(r)).abs() > 1) & far).sum())


def _absmm(a, b):
    """|a| @ |b| of the operands rounded to bf16: the sum of the magnitudes
    of each product element's terms (g stands in for its bf16 split)."""
    return a.to(torch.bfloat16).float().abs() @ b.to(torch.bfloat16).float().abs()


def test_bf16_product_and_backward_on_card_match_cpu(cuda):
    """The bf16 policy's product and its backward (the float32 cotangent
    split into two bf16 terms, the gradients rounded to bf16) on the card
    and on the CPU (tests/test_torch_train_ops.py holds the CPU's to JAX):
    the output within 1e-5 of its largest value (float32 sums of exact
    products in another order), both gradients bf16-valued and within 1
    bf16 ulp (or the cancellation slack) of the CPU's."""
    from genome_minimizer_2_torch.core.dtypes import Policy
    from genome_minimizer_2_torch.models.vae import matmul

    gen = torch.Generator().manual_seed(3)
    x, w = torch.randn(300, 200, generator=gen), torch.randn(200, 130, generator=gen)
    g = torch.randn(300, 130, generator=gen)
    outs = []
    for dev in ("cpu", cuda):
        xd = x.detach().to(dev).requires_grad_()
        wd = w.detach().to(dev).requires_grad_()
        y = matmul(xd, wd, Policy("bfloat16"))
        y.backward(g.to(dev))
        outs.append([t.detach().cpu() for t in (y, xd.grad, wd.grad)])
    (y_cpu, dx_cpu, dw_cpu), (y_card, dx_card, dw_card) = outs
    assert float((y_cpu - y_card).abs().max()) <= 1e-5 * float(y_cpu.abs().max())
    for a, b, terms in ((dx_cpu, dx_card, _absmm(g, w.t())),
                        (dw_cpu, dw_card, _absmm(x.t(), g))):
        assert a.dtype == b.dtype == torch.float32
        assert torch.equal(b, b.to(torch.bfloat16).float())
        assert _bf16_outside(b, a, terms) == 0


# (B, D, N): v0's and v2's input layer at the cells' batch, their last
# batch, the gene slice, unpadded genes, the heads, D and N not multiples
# of 8, several k blocks of 32 rows
WGRAD_SHAPES = [(32, 55_040, 1024), (32, 55_040, 512), (24, 55_040, 1024),
                (32, 27_520, 1024), (16, 55_039, 1024), (32, 1024, 64),
                (32, 64, 1024), (7, 1003, 130), (1, 300, 4), (33, 200, 48),
                (256, 300, 32)]


@pytest.mark.parametrize("B, D, N", WGRAD_SHAPES)
def test_weight_grad_matches_plain_version(cuda, B, D, N):
    """One launch, bf16 values, each within 1 bf16 ulp of the plain version
    (the two library products, the add and the casts) or, where the sum
    cancels, within CANCEL of the sum of its terms' magnitudes."""
    gen = torch.Generator(device=cuda).manual_seed(B + D + N)
    x = torch.randn(B, D, generator=gen, device=cuda).to(torch.bfloat16)
    g = torch.randn(B, N, generator=gen, device=cuda) * 1e-3
    before = K.weight_grad_bf16.launches
    out = K.weight_grad_bf16(x, g)
    assert K.weight_grad_bf16.launches == before + 1
    ref = K.weight_grad_bf16_reference(x, g)
    assert out.dtype == torch.float32 and tuple(out.shape) == (D, N)
    assert torch.equal(out, out.to(torch.bfloat16).float())
    assert _bf16_outside(out, ref, x.float().abs().t() @ g.abs()) == 0


@pytest.mark.parametrize("B", [256, 2048])
def test_weight_grad_keeps_the_lo_term(cuda, B):
    """At many rows the kernel is as near the exact product, rounded to bf16,
    as the plain version: the lo term's products keep their bits (one
    accumulator for hi and lo cut them: on an H100 at 27,520 x 1,024, 530x
    more values off the exact rounding at 256 rows, 170x at 2,048). 0/1
    inputs at 40 %, as genes."""
    gen = torch.Generator(device=cuda).manual_seed(B)
    x = (torch.rand(B, 4096, generator=gen, device=cuda) < 0.4).to(torch.bfloat16)
    g = torch.randn(B, 1024, generator=gen, device=cuda) * 1e-4
    hi = g.to(torch.bfloat16)
    lo = (g - hi.float()).to(torch.bfloat16)
    exact = (x.double().t() @ (hi.double() + lo.double())).float()
    exact = exact.to(torch.bfloat16).float()
    off_kernel = int((K.weight_grad_bf16(x, g) != exact).sum())
    off_plain = int((K.weight_grad_bf16_reference(x, g) != exact).sum())
    assert off_kernel <= 2 * off_plain + 8, (off_kernel, off_plain)


def test_weight_grad_captured_equals_eager(cuda):
    """The launch captured in a CUDA graph and replayed writes what an eager
    launch writes, bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(32, 55_040, generator=gen, device=cuda).to(torch.bfloat16)
    g = torch.randn(32, 512, generator=gen, device=cuda) * 1e-3
    eager = K.weight_grad_bf16(x, g)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K.weight_grad_bf16(x, g)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = K.weight_grad_bf16(x, g)
    captured.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


# The bulk route with a ragged last chunk (800, 3000, 8: runs of 48,000 or
# 96,000 bytes), fewer runs than SMs (24 runs of 8 x 55,040), B = 1 at a
# width in the tens of thousands, and the word route (odd widths: 1-byte
# words in bf16, 4-byte in float32).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,block", [(4608, 384, 8), (101, 19, 1), (37, 7, 1),
                                       (800, 3000, 8), (192, 55_040, 8),
                                       (300, 30_000, 1), (64, 1001, 1)])
def test_gather_row_blocks_matches_plain_version(cuda, dtype, n, d, block):
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(n, d, generator=gen, device=cuda).to(dtype)
    idx = torch.randperm(n // block, generator=gen, device=cuda)
    before = K.gather_row_blocks.launches
    out = K.gather_row_blocks(x, idx, block)
    torch.cuda.synchronize()
    assert K.gather_row_blocks.launches == before + 1
    assert torch.equal(out, K.gather_row_blocks_reference(x, idx, block))


def test_gather_row_blocks_takes_word_route_for_unaligned_source(cuda):
    """x starting 2 bytes past a 16-byte boundary: 1-byte words."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    base = torch.randn(64 * 512 + 1, generator=gen, device=cuda).to(torch.bfloat16)
    x = base[1:].view(64, 512)
    idx = torch.randperm(8, generator=gen, device=cuda)
    assert K._gather_word(x.data_ptr() | 8 * 512 * 2) == 1
    out = K.gather_row_blocks(x, idx)
    torch.cuda.synchronize()
    assert torch.equal(out, K.gather_row_blocks_reference(x, idx))


@pytest.mark.parametrize("d", [384, 7])  # the bulk route, the word route
def test_gather_row_blocks_traps_out_of_range_index(cuda, d):
    """A row index outside [0, n) stops the kernel (block 1: 768-byte rows
    take the bulk route, 14-byte rows the word route); run in a child
    process, whose CUDA context the trap ends."""
    code = ("import torch\n"
            "from genome_minimizer_2_torch.ops import kernels as K\n"
            f"x = torch.zeros(64, {d}, dtype=torch.bfloat16, device='cuda')\n"
            "K.gather_row_blocks(x, torch.tensor([0, 64, 1], device='cuda'), 1)\n"
            "torch.cuda.synchronize()\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, timeout=600,
                         capture_output=True, text=True)
    assert run.returncode != 0 and "CUDA error" in run.stderr, run.stderr[-2000:]


@pytest.mark.parametrize("B,H,D,dtype", [(64, 32, 384, torch.float32),
                                         (2048, 1024, 55_040, torch.float32),
                                         (1, 32, 384, torch.float32),
                                         # float32: ragged B, H, D and K,
                                         # split dh (8 and 14 ways at 512
                                         # and 856; 12 at the small shapes)
                                         (1, 40, 300, torch.float32),
                                         (100, 40, 300, torch.float32),
                                         (64, 32, 1003, torch.float32),
                                         (856, 1024, 55_040, torch.float32),
                                         (512, 1024, 55_040, torch.float32),
                                         (2048, 1024, 27_520, torch.float32),
                                         (1, 40, 300, torch.bfloat16),
                                         (100, 40, 300, torch.bfloat16),
                                         (856, 1024, 55_040, torch.bfloat16),
                                         (512, 1024, 55_040, torch.bfloat16),
                                         (2048, 1024, 55_040, torch.bfloat16),
                                         # a gene slice of the model axis of 2
                                         (2048, 1024, 27_520, torch.bfloat16),
                                         (512, 1024, 27_520, torch.bfloat16),
                                         # bf16: dW clusters of 2 and 4 CTAs
                                         # along H, ragged B and D
                                         (200, 256, 384, torch.bfloat16),
                                         (130, 512, 1003, torch.bfloat16),
                                         (64, 1024, 1003, torch.bfloat16)])
@pytest.mark.parametrize("with_g_logits", [False, True])
def test_output_layer_bwd_matches_plain_version(cuda, B, H, D, dtype, with_g_logits):
    """float32 (CUDA cores): dW, db, dh within 1e-4 of the largest plain
    value (float32 sums in another order); y float32 at every batch. bf16 (tensor cores): db within
    1e-4 of its largest value; dW and dh bf16-valued, each element within 1
    bf16 ulp of the plain one or within the cancellation slack; y float32
    at the ragged batch 856."""
    gen = torch.Generator(device=cuda).manual_seed(B + D)
    h = torch.relu(torch.randn(B, H, generator=gen, device=cuda))
    w = torch.randn(H, D, generator=gen, device=cuda) * 0.05
    logits = (h.to(dtype).float() @ w.to(dtype).float()).to(dtype)
    y = (torch.rand(B, D, generator=gen, device=cuda) < 0.5)
    y = y.float() if B == 856 else y.to(dtype)
    mask = torch.ones(D, device=cuda)
    mask[-5:] = 0.0
    g = torch.tensor(0.7, device=cuda)
    gl = ((torch.randn(B, D, generator=gen, device=cuda) * 0.01).to(dtype)
          if with_g_logits else None)
    before = K.output_layer_bwd.launches
    out = K.output_layer_bwd(logits, y, mask, h, w, g, gl)
    torch.cuda.synchronize()
    assert K.output_layer_bwd.launches == before + 1
    ref = K.output_layer_bwd_reference(logits, y, mask, h, w, g, gl)
    if dtype == torch.float32:
        for o, r in zip(out, ref):
            assert float((o - r).abs().max()) <= 1e-4 * float(r.abs().max())
        return
    dl = K.output_layer_dl(logits, y, mask, g, gl)
    (dw, db, dh), (rw, rb, rh) = out, ref
    assert float((db - rb).abs().max()) <= 1e-4 * float(rb.abs().max())
    for o, r, terms in ((dw, rw, _absmm(h.t(), dl)), (dh, rh, _absmm(dl, w.t()))):
        assert torch.equal(o, o.to(torch.bfloat16).float())
        assert _bf16_outside(o, r, terms) == 0


@pytest.mark.parametrize("B,D", [(2048, 55_040), (856, 1003)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_output_layer_bwd_float32_is_deterministic(cuda, B, D, dtype):
    """Two calls on the same inputs give the same bits, at float32 and at
    bf16: db is a fixed-order sum (of the dl makers' partials under bf16),
    dh's split partials are summed in split order, nothing uses atomics."""
    H = 1024
    gen = torch.Generator(device=cuda).manual_seed(5)
    h = torch.relu(torch.randn(B, H, generator=gen, device=cuda)).to(dtype)
    w = (torch.randn(H, D, generator=gen, device=cuda) * 0.05).to(dtype)
    logits = (h.float() @ w.float()).to(dtype)
    y = (torch.rand(B, D, generator=gen, device=cuda) < 0.5).to(dtype)
    gl = (torch.randn(B, D, generator=gen, device=cuda) * 0.01).to(dtype)
    mask, g = torch.ones(D, device=cuda), torch.tensor(0.7, device=cuda)
    first = K.output_layer_bwd(logits, y, mask, h, w, g, gl)
    second = K.output_layer_bwd(logits, y, mask, h, w, g, gl)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("M,N", [(512, 55_040), (300, 1003)])
def test_decode_is_deterministic(cuda, M, N):
    """Two bf16 decodes of the same inputs give the same bytes."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    h = torch.randn(M, 1024, generator=gen, device=cuda)
    w = (torch.randn(1024, N, generator=gen, device=cuda) / 32).to(torch.bfloat16)
    b = torch.randn(N, generator=gen, device=cuda) * 0.1
    first = K.decode_threshold_pack(h, w, b, compute_dtype=torch.bfloat16)
    second = K.decode_threshold_pack(h, w, b, compute_dtype=torch.bfloat16)
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_output_layer_bwd_empty_share_launches_nothing(cuda, dtype):
    """A data-parallel rank's empty share of a ragged batch (B = 0): the
    sums over no rows, and no launch on an empty grid."""
    H, D = 40, 300
    before = K.output_layer_bwd.launches
    dw, db, dh = K.output_layer_bwd(
        torch.zeros(0, D, dtype=dtype, device=cuda),
        torch.zeros(0, D, dtype=dtype, device=cuda),
        torch.ones(D, device=cuda), torch.zeros(0, H, device=cuda),
        torch.randn(H, D, device=cuda), torch.tensor(1.0, device=cuda))
    assert K.output_layer_bwd.launches == before
    assert tuple(dw.shape) == (H, D) and tuple(db.shape) == (D,)
    assert tuple(dh.shape) == (0, H)
    assert not dw.any() and not db.any()


def test_decode_refuses_no_rows(cuda):
    before = K.decode_threshold_pack.launches
    with pytest.raises(ValueError, match="no rows"):
        K.decode_threshold_pack(torch.zeros(0, 64, device=cuda),
                                torch.zeros(64, 16, device=cuda),
                                torch.zeros(16, device=cuda),
                                compute_dtype=torch.float32)
    assert K.decode_threshold_pack.launches == before


@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_clip_adam_matches_plain_version(cuda, moments, max_norm):
    """Bit-equal: both round every operation once, in the same order."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    n = 1_000_003
    g = torch.randn(n, generator=gen, device=cuda)
    m = (torch.randn(n, generator=gen, device=cuda) * 0.01).to(moments)
    v = (torch.rand(n, generator=gen, device=cuda) * 1e-4).to(moments)
    p = torch.randn(n, generator=gen, device=cuda)
    scalars = torch.tensor([2.5, 0.271, 0.00399, 1e-3], device=cuda)
    m2, v2, p2 = m.clone(), v.clone(), p.clone()
    K.clip_adam_apply(g, m, v, p, scalars, max_norm)
    torch.cuda.synchronize()
    K.clip_adam_apply_reference(g, m2, v2, p2, scalars, max_norm)
    assert torch.equal(p, p2) and torch.equal(m, m2) and torch.equal(v, v2)


@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
def test_clip_adam_over_the_leaves_one_rank_holds(cuda, moments):
    """Every leaf of a v0 model with its gene slice of the model axis of 2
    (the second rank's: encoder/0/w (27,520, 1,024), decoder/3/w (1,024,
    27,520), decoder/3/b (27,520)): bit-equal to the plain version."""
    from genome_minimizer_2_torch.models import vae
    from genome_minimizer_2_torch.parallel.mesh import Axis

    model = vae.VAE(vae.VAEConfig(55_039, 1024, 64)).shard_genes(Axis(1, 2))
    shapes = {k: tuple(p.shape) for k, p in model.flat_params().items()}
    assert shapes["decoder/3/w"] == (1024, 27_520)
    gen = torch.Generator(device=cuda).manual_seed(11)
    scalars = torch.tensor([2.5, 0.271, 0.00399, 1e-3], device=cuda)
    leaves = []
    for shape in shapes.values():
        g = torch.randn(shape, generator=gen, device=cuda)
        m = (torch.randn(shape, generator=gen, device=cuda) * 0.01).to(moments)
        v = (torch.rand(shape, generator=gen, device=cuda) * 1e-4).to(moments)
        p = torch.randn(shape, generator=gen, device=cuda)
        leaves.append((g, m, v, p))
        m2, v2, p2 = m.clone(), v.clone(), p.clone()
        K.clip_adam_apply(g, m, v, p, scalars, 0.5)
        K.clip_adam_apply_reference(g, m2, v2, p2, scalars, 0.5)
        assert torch.equal(p, p2) and torch.equal(m, m2) and torch.equal(v, v2)
    # every leaf in one launch, the step's entry point
    g, m, v, p = ([t[i] for t in leaves] for i in range(4))
    m2, v2, p2 = ([t.clone() for t in x] for x in (m, v, p))
    before = K.clip_adam_apply_leaves.launches
    K.clip_adam_apply_leaves(g, m, v, p, scalars, 0.5)
    assert K.clip_adam_apply_leaves.launches == before + 1
    K.clip_adam_apply_leaves_reference(g, m2, v2, p2, scalars, 0.5)
    for a, b in zip([*m, *v, *p], [*m2, *v2, *p2]):
        assert torch.equal(a, b)


def _adam_leaves(cuda, sizes, moments, offset=0, seed=13):
    """g, m, v, p of leaves of ``sizes`` values, each a view ``offset``
    values into its own allocation."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    out = []
    for n in sizes:
        make = lambda scale: torch.randn(n + offset, generator=gen,  # noqa: E731
                                         device=cuda) * scale
        g, p = make(1.0)[offset:], make(1.0)[offset:]
        m = make(0.01).to(moments)[offset:]
        v = (make(1e-2) ** 2).to(moments)[offset:]
        out.append((g, m, v, p))
    return [list(t) for t in zip(*out)]


ADAM_SIZES = [1, 7, 8, 1_000_003, 9, 15, 16, 17, 4096]


@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("max_norm", [0.5, 1e6])
@pytest.mark.parametrize("offset", [0, 1, 3, 4])
def test_clip_adam_leaves_matches_plain_version(cuda, moments, max_norm, offset):
    """One launch over ragged leaves (1, 7, 8, 1,000,003 values and more),
    each a view at ``offset`` values (odd offsets put the vector path's
    head and tail on the scalar path; with bf16 moments at offset 1, g and
    p are aligned a value apart from m and v), bit-equal to the plain
    version."""
    g, m, v, p = _adam_leaves(cuda, ADAM_SIZES, moments, offset)
    scalars = torch.tensor([2.5, 0.271, 0.00399, 1e-3], device=cuda)
    m2, v2, p2 = ([t.clone() for t in x] for x in (m, v, p))
    before = K.clip_adam_apply_leaves.launches
    K.clip_adam_apply_leaves(g, m, v, p, scalars, max_norm)
    torch.cuda.synchronize()
    assert K.clip_adam_apply_leaves.launches == before + 1
    K.clip_adam_apply_leaves_reference(g, m2, v2, p2, scalars, max_norm)
    for i, n in enumerate(ADAM_SIZES):
        assert torch.equal(p[i], p2[i]), n
        assert torch.equal(m[i], m2[i]) and torch.equal(v[i], v2[i]), n


def test_clip_adam_leaves_past_one_table(cuda):
    """130 leaves take three launches (64 leaves a table), bit-equal; a
    leaf of no values and mixed moment dtypes are refused, launching
    nothing."""
    sizes = [(i * 37) % 300 + 1 for i in range(130)]
    g, m, v, p = _adam_leaves(cuda, sizes, torch.bfloat16, offset=1)
    scalars = torch.tensor([2.5, 0.271, 0.00399, 1e-3], device=cuda)
    m2, v2, p2 = ([t.clone() for t in x] for x in (m, v, p))
    before = K.clip_adam_apply_leaves.launches
    K.clip_adam_apply_leaves(g, m, v, p, scalars, 1e6)
    torch.cuda.synchronize()
    assert K.clip_adam_apply_leaves.launches == before + 3
    K.clip_adam_apply_leaves_reference(g, m2, v2, p2, scalars, 1e6)
    for a, b in zip([*m, *v, *p], [*m2, *v2, *p2]):
        assert torch.equal(a, b)
    empty = torch.zeros(0, device=cuda)
    with pytest.raises(ValueError, match="no values"):
        K.clip_adam_apply_leaves([g[0], empty], [m[0], empty.bfloat16()],
                                 [v[0], empty.bfloat16()], [p[0], empty],
                                 scalars, 1e6)
    with pytest.raises(ValueError, match="one bf16"):
        K.clip_adam_apply_leaves(g[:2], [m[0], m[1].float()], v[:2], p[:2],
                                 scalars, 1e6)
    assert K.clip_adam_apply_leaves.launches == before + 3


def test_clip_adam_leaves_captured_and_replayed(cuda):
    """The one launch a step, captured into a CUDA graph and replayed
    three times under the sync debug mode that raises on any wait for the
    card: bit-equal to three eager launches from the same state, and the
    capture counts no launch."""
    g, m, v, p = _adam_leaves(cuda, ADAM_SIZES, torch.bfloat16, offset=1)
    scalars = torch.tensor([2.5, 0.271, 0.00399, 1e-3], device=cuda)
    m2, v2, p2 = ([t.clone() for t in x] for x in (m, v, p))
    K.clip_adam_apply_leaves(g, m, v, p, scalars, 0.5)  # builds, occupancy
    K.clip_adam_apply_leaves_reference(g, m2, v2, p2, scalars, 0.5)
    torch.cuda.synchronize()
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    counts = K.launch_counts()
    with torch.cuda.graph(graph, stream=stream):
        K.clip_adam_apply_leaves(g, m, v, p, scalars, 0.5)
    K.set_launch_counts(counts)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for _ in range(3):
        K.clip_adam_apply_leaves_reference(g, m2, v2, p2, scalars, 0.5)
    for a, b in zip([*m, *v, *p], [*m2, *v2, *p2]):
        assert torch.equal(a, b)
    graph.reset()


def test_tensor_parallel_step_on_card_matches_one_process(cuda):
    """Two gloo ranks sharing the card as data 1 x model 2
    (tests/_torch_mp_tp_worker.py; v3, float32): the first step's loss,
    global norm and every leaf's summed gradient, gathered, within 1e-5 of
    one process's on the card (the pre-BatchNorm biases' gradients are
    rounding noise and left out); both ranks report the same finite
    histories and the gene slices they held."""
    from genome_minimizer_2_torch.core import prng
    from genome_minimizer_2_torch.ops.optimizer import global_norm
    from genome_minimizer_2_torch.train import trainer
    from genome_minimizer_2_torch.utils.config import ExperimentConfig

    # the gloo launcher and data of test_torch_port_dp.py, loaded by path:
    # the card's machine may have another package named ``tests``
    spec = importlib.util.spec_from_file_location(
        "_port_dp_helpers", REPO / "tests" / "test_torch_port_dp.py")
    dp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(dp)
    _data, run_ranks = dp._data, dp.run_ranks

    outs = run_ranks(2, {"runs": [{"label": "v3", "version": "v3", "data": 1,
                                   "model": 2, "device": "cuda",
                                   "compute_dtype": "float32"}]},
                     worker=REPO / "tests" / "_torch_mp_tp_worker.py")
    got = outs[0]["v3"]
    assert outs[1]["v3"]["train"] == got["train"]
    assert np.isfinite(got["train"]["total"] + got["val"]["total"]).all()
    assert got["held"]["decoder/3/w"] == [16, 64]
    cfg = ExperimentConfig(hidden_dim=16, latent_dim=4, n_epochs=2, batch_size=8,
                           trainer_version="v3", compute_dtype="float32")
    t = trainer.create_trainer("v3", cfg, 70, device="cuda")
    batch = t.prepare_data(_data()[0])[:8]
    comps, grads, _ = t.loss_and_grads(t.init_state(), batch, 1,
                                       prng.key(7, "cuda"))
    step = got["step"]
    assert abs(step["loss"] - float(comps["total"].detach())) <= \
        1e-5 * abs(float(comps["total"].detach()))
    norm = float(global_norm(grads))
    assert abs(step["norm"] - norm) <= 1e-5 * norm
    for k, g in grads.items():
        if k.split("/")[0] in ("encoder", "decoder") and k.endswith("/b") \
                and k != "decoder/3/b":
            continue
        gap = torch.linalg.norm(torch.tensor(step["grads"][k]) - g.cpu())
        assert float(gap) <= 1e-5 * float(torch.linalg.norm(g)), k


def test_training_on_card_launches_each_kernel(cuda):
    import numpy as np

    from genome_minimizer_2_torch.train import trainer
    from genome_minimizer_2_torch.utils.config import get_v0_config

    cfg = get_v0_config()
    cfg.hidden_dim, cfg.latent_dim, cfg.n_epochs, cfg.batch_size = 32, 4, 2, 256
    cfg.print_every = 1000
    x = (np.random.RandomState(0).rand(520, 300) < 0.4).astype(np.float32)
    t = trainer.create_trainer("v0", cfg, 300, device=cuda)
    K.reset_launch_counts()
    losses, _, epochs = t.train(x, x[:40])
    assert epochs == 2 and np.isfinite(losses).all()
    assert K.gather_row_blocks.launches == 2
    assert K.output_layer_bwd.launches == 2 * 3
    assert K.clip_adam_apply_leaves.launches == 2 * 3  # one a step, 30 leaves
    assert K.weight_grad_bf16.launches == 2 * 3 * 8  # every product but the output's


# ---------------------------------------------------------------------------
# the training epoch as captured CUDA graphs
# ---------------------------------------------------------------------------

# (rows, batch) of the block shuffle (2 batches of 256 + 8) and of the exact
# row permutation (516 rows, not whole 8-row blocks: 2 x 256 + 4)
GRAPH_SHAPES = {True: (520, 256), False: (516, 256)}


def _graph_trainer(cuda, dtype, batch, epochs=3, version="v0"):
    from genome_minimizer_2_torch.train import trainer
    from genome_minimizer_2_torch.utils.config import get_preset_config

    cfg = get_preset_config(version)
    cfg.hidden_dim, cfg.latent_dim, cfg.n_epochs = 32, 4, epochs
    cfg.batch_size, cfg.print_every, cfg.compute_dtype = batch, 1000, dtype
    return trainer.create_trainer(version, cfg, 300, device=cuda)


def _graph_data(n, nv=40, seed=0):
    rng = np.random.RandomState(seed)
    return ((rng.rand(n, 300) < 0.4).astype(np.float32),
            (rng.rand(nv, 300) < 0.4).astype(np.float32))


def _same_state(a, b):
    la, lb = a.leaves(), b.leaves()
    return [k for k in la if not torch.equal(la[k], lb[k])]


@pytest.mark.parametrize("block", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_graphed_epochs_bit_equal_to_eager(cuda, dtype, block):
    """Three training + validation epochs from one state, eager
    (``run_epoch``) against the programs (the first epoch eager on the
    capture stream, then the captures, then two epochs of replays), a
    ragged last batch in each: every state tensor and loss sum bit-equal
    after each epoch, and the replays' launch counts equal the eager
    epoch's."""
    from genome_minimizer_2_torch.train import trainer as T

    n, batch = GRAPH_SHAPES[block]
    t = _graph_trainer(cuda, dtype, batch)
    x, xv = (t.prepare_data(a) for a in _graph_data(n))
    eager, graphed = t.init_state(), t.init_state()
    for epoch in range(3):
        t._epoch.fill_(epoch)
        t._lr.fill_(T.step_lr(1e-3, 1000, 0.5, epoch))
        K.reset_launch_counts()
        want = [t.run_epoch(eager, x, n, epoch, t._lr, train=True),
                t.run_epoch(eager, xv, 40, epoch, t._lr, train=False)]
        counts = K.launch_counts()
        K.reset_launch_counts()
        got = [dict(t.graphed_epoch(graphed, x, n, train=True)),
               t.graphed_epoch(graphed, xv, 40, train=False)]
        torch.cuda.synchronize()
        assert K.launch_counts() == counts, epoch
        assert K.gather_row_blocks.replayed == (epoch > 0 and block)
        assert counts["gather_row_blocks"] == block
        assert counts["output_layer_bwd"] == 3
        assert counts["weight_grad_bf16"] == 3 * 8 * (dtype == "bfloat16")
        for w, g in zip(want, got):
            assert all(torch.equal(w[k], g[k]) for k in w), epoch
        assert _same_state(eager, graphed) == [], epoch
    assert all(p.graphs is not None for p in t._epoch_fns.values())


def test_epoch_makes_no_host_sync(cuda):
    """A training and a validation epoch, eager and replayed, under the
    sync debug mode that raises on any wait for the card (after a first
    epoch, which makes the optimizer's table by a copy)."""
    t = _graph_trainer(cuda, "bfloat16", 256)
    x, xv = (t.prepare_data(a) for a in _graph_data(520))
    state = t.init_state()
    t.graphed_epoch(state, x, 520, train=True)
    t.graphed_epoch(state, xv, 40, train=False)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t.run_epoch(state, x, 520, 1, t._lr, train=True)
        t.run_epoch(state, xv, 40, 1, t._lr, train=False)
        t.graphed_epoch(state, x, 520, train=True)
        t.graphed_epoch(state, xv, 40, train=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_resume_after_capture_on_card(cuda, tmp_path):
    """A run that crashes after epoch 2 and is resumed in the same trainer,
    whose graphs were captured for the state it trained, from the epoch-1
    file: the trainer captures anew for the loaded state and ends bit-equal
    to a straight run, launch counts included (the straight run's counted
    from its initial state on, as a resume's are)."""
    x, xv = _graph_data(520, seed=3)
    straight = _graph_trainer(cuda, "bfloat16", 256, version="v3")
    state = straight.init_state()
    K.reset_launch_counts()
    straight.train(x, xv, state=state)
    straight_counts = K.launch_counts()
    t = _graph_trainer(cuda, "bfloat16", 256, version="v3")

    def crash(epoch, tr, vl):
        if epoch == 1:
            raise RuntimeError("crash")

    with pytest.raises(RuntimeError, match="crash"):
        t.train(x, xv, progress_cb=crash,
                checkpoint_path=str(tmp_path / "s_{epoch}.npz"),
                checkpoint_every=1)
    old = t._epoch_fns[(520, True)]
    assert old.graphs is not None
    state, start = t.resume_from(str(tmp_path / "s_1.npz"))
    K.reset_launch_counts()
    t.train(x, xv, state=state, start_epoch=start)
    assert t._epoch_fns[(520, True)] is not old and old.graphs is None
    assert K.launch_counts() == {k: v * 2 // 3 for k, v in straight_counts.items()}
    assert t.train_losses == straight.train_losses
    assert t.val_losses == straight.val_losses
    assert _same_state(straight.final_state, t.final_state) == []


# (sum, n) where the float32 product with fl(1 / n) is not the quotient:
# found with numpy on the CPU
PRODUCT_IS_NOT_QUOTIENT = [(12892.63, 520), (1234.5677, 40)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_epoch_averages_are_correctly_rounded_quotients(cuda, dtype, monkeypatch):
    """Every loss average that eager (``run_epoch``) and graphed epochs
    report on the card, training and validation, over three epochs (the
    first graphed one eager on the capture stream, then replays): the
    output of ``ops/losses.py::_div``, equal to the host's correctly
    rounded ``np.float32(np.float64(sum) / n)``. ``_div`` itself at sums
    whose product with the reciprocal rounds elsewhere. The numerators a
    capture records hold each replay's sums (the test keeps them alive)."""
    from genome_minimizer_2_torch.ops import losses as L

    for s, n in PRODUCT_IS_NOT_QUOTIENT:
        f = np.float32
        assert f(s) * (f(1) / f(n)) != f(np.float64(f(s)) / n)
        got = L._div(torch.full((), s, device=cuda), n)
        assert float(got) == f(np.float64(f(s)) / n), (s, n)

    calls, div = [], L._div

    def spy(num, d):
        out = div(num, d)
        calls.append((num, d, out))
        return out

    monkeypatch.setattr(L, "_div", spy)
    t = _graph_trainer(cuda, dtype, 256)
    names = t.spec.component_names()
    x, xv = (t.prepare_data(a) for a in _graph_data(520))
    eager, graphed = t.init_state(), t.init_state()
    captured = {}  # rows -> the quotients a capture recorded
    t._lr.fill_(1e-3)
    for epoch in range(3):
        t._epoch.fill_(epoch)
        for rows, data, train in ((520, x, True), (40, xv, False)):
            for way in ("eager", "graphed"):
                calls.clear()
                if way == "eager":
                    avg = t.run_epoch(eager, data, rows, epoch, t._lr, train)
                else:
                    avg = t.graphed_epoch(graphed, data, rows, train)
                quotients = [(num, out) for num, d, out in calls if d == rows]
                if way == "graphed" and quotients:
                    # the first epoch: the eager run's, then the capture's
                    captured[rows] = quotients[len(names):]
                    quotients = quotients[:len(names)]
                elif way == "graphed":
                    quotients = captured[rows]
                torch.cuda.synchronize()
                assert len(quotients) == len(names), (way, train)
                for k, (num, out) in zip(names, quotients):
                    assert torch.equal(avg[k], out), (epoch, way, train, k)
                    want = np.float32(np.float64(float(num)) / rows)
                    assert float(out) == want, (epoch, way, train, k)


@pytest.mark.parametrize("version,overrides", [
    ("v2", {}), ("v3", {}),
    ("v3", dict(T=7, min_beta=0.3, max_beta=0.9, n_epochs=37))])
def test_cosine_beta_on_card_equals_cpu(cuda, version, overrides):
    """The cosine beta of an int32 device epoch and counter on the card,
    for every epoch of the schedule, bit-equal to the port's CPU values
    (which tests/test_torch_train_graph.py and test_torch_train_ops.py hold
    to the host floats and to JAX)."""
    from genome_minimizer_2_torch.ops import losses as L
    from genome_minimizer_2_torch.utils.config import get_preset_config

    spec = L.spec_for_preset(version, get_preset_config(version))
    spec = L.LossSpec(**{**spec.__dict__, **overrides})
    assert spec.scheduler_type == "cosine"
    epochs = torch.arange(spec.n_epochs, dtype=torch.int32)
    for counter in (0, 1, 31, 1000):
        c = torch.tensor(counter, dtype=torch.int32)
        cpu = L.beta_schedule(spec, epochs, c)
        card = L.beta_schedule(spec, epochs.to(cuda), c.to(cuda))
        assert card.dtype == cpu.dtype == torch.float32
        assert torch.equal(card.cpu(), cpu), (counter, (card.cpu() - cpu).abs().max())

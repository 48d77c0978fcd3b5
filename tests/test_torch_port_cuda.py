"""Card-only tests of the port: the hand-written CUDA kernel against its
plain version, and the streaming pipeline on the card. They skip without a
CUDA device. On a machine with one (and without JAX), run them with

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

(``--noconftest``: tests/conftest.py configures JAX, which the port never
needs). This file imports nothing of JAX or the JAX package."""

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
                                    (1, 64, 7), (65, 33, 129)])
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
                                         (1, 40, 300, torch.bfloat16),
                                         (100, 40, 300, torch.bfloat16),
                                         (856, 1024, 55_040, torch.bfloat16),
                                         (512, 1024, 55_040, torch.bfloat16),
                                         (2048, 1024, 55_040, torch.bfloat16)])
@pytest.mark.parametrize("with_g_logits", [False, True])
def test_output_layer_bwd_matches_plain_version(cuda, B, H, D, dtype, with_g_logits):
    """float32 (CUDA cores): dW, db, dh within 1e-4 of the largest plain
    value (float32 sums in another order). bf16 (tensor cores): db within
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
    assert K.clip_adam_apply.launches == 2 * 3 * 30

"""Card-only tests of the port: the hand-written CUDA kernel against its
plain version, and the streaming pipeline on the card. They skip without a
CUDA device. On a machine with one (and without JAX), run them with

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

(``--noconftest``: tests/conftest.py configures JAX, which the port never
needs). This file imports nothing of JAX or the JAX package."""

import math

import numpy as np
import pytest
import torch

from genome_minimizer_2_torch.ops import kernels as K

pytestmark = pytest.mark.cuda

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

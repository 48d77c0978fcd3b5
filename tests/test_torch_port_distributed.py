"""The port's pipeline under torch.distributed (gloo, CPU): with no explicit
process_index/process_count, each rank takes its share of the sample axis
from the process group, and rank 0 merges the shards into the same FASTA a
single process writes."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from genome_minimizer_2_torch import pipeline
from genome_minimizer_2_torch.core import prng
from genome_minimizer_2_torch.genome.minimizer import MinimizerEngine
from genome_minimizer_2_torch.models import vae
from genome_minimizer_2_torch.sample.sampler import Sampler
from genome_minimizer_2_torch.utils import checkpoint as ckpt
from genome_minimizer_2_torch.utils.config import ExperimentConfig

REPO = Path(__file__).resolve().parents[1]
D, N, CHUNK, SEED = 60, 13, 4, 7

WORKER = r"""
import sys
import numpy as np
import torch.distributed as dist
from genome_minimizer_2_torch import pipeline
from genome_minimizer_2_torch.core import prng
from genome_minimizer_2_torch.genome.minimizer import MinimizerEngine
from genome_minimizer_2_torch.sample.sampler import load_sampler

port, rank, world, model, gb, out = sys.argv[1:7]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=int(rank), world_size=int(world))
try:
    sampler, _ = load_sampler(model, device="cpu")
    engine = MinimizerEngine.from_genbank(gb)
    cols = np.array([f"g{i:03d}" for i in range(%(D)d)], dtype=object)
    stats = pipeline.sample_and_minimize(
        sampler, engine, cols, {"g001"}, %(N)d, out,
        key=prng.key(%(SEED)d, "cpu"), chunk_size=%(CHUNK)d, model_name="d")
    print("genomes", stats.genomes)
finally:
    dist.destroy_process_group()
""" % {"D": D, "N": N, "SEED": SEED, "CHUNK": CHUNK}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _write_inputs(tmp_path):
    rng = np.random.RandomState(0)
    genes = [f"g{i:03d}" for i in range(D)]
    lines = ["LOCUS       T                    3000 bp    DNA", "FEATURES"]
    for i, s in enumerate(sorted(rng.choice(2800, 40, replace=False))):
        lines += [f"     gene            {s + 1}..{s + 120}",
                  f'                     /gene="{genes[i]}"']
    seq = "".join(rng.choice(list("acgt"), 3000))
    lines.append("ORIGIN")
    lines += [f"{i + 1:>9} {seq[i:i + 60]}" for i in range(0, 3000, 60)]
    lines.append("//")
    gb = tmp_path / "g.gb"
    gb.write_text("\n".join(lines) + "\n")
    cfg = vae.VAEConfig(input_dim=D, hidden_dim=10, latent_dim=3)
    model = vae.init(cfg, torch.Generator().manual_seed(1))
    path = tmp_path / "m.npz"
    ckpt.save_checkpoint(path, model.flat_params(), model.flat_stats(),
                         ExperimentConfig(hidden_dim=10, latent_dim=3),
                         extra={"input_dim": D})
    return str(path), str(gb), genes


def test_gloo_ranks_shard_and_merge(tmp_path):
    model, gb, genes = _write_inputs(tmp_path)
    merged = tmp_path / "merged.fasta"
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(port), str(r), "2", model, gb,
         str(merged)], cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in (0, 1)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se
    assert sorted(int(so.split()[-1]) for so, _ in outs) == [N // 2, N - N // 2]

    single = tmp_path / "single.fasta"
    sampler = Sampler(model=vae.params_from_flat(
        *ckpt.load_checkpoint(model)[:2],
        vae.VAEConfig(input_dim=D, hidden_dim=10, latent_dim=3), device="cpu"))
    pipeline.sample_and_minimize(
        sampler, MinimizerEngine.from_genbank(gb),
        np.array(genes, dtype=object), {"g001"}, N, str(single),
        key=prng.key(SEED, "cpu"), chunk_size=CHUNK, model_name="d",
        process_index=0, process_count=1)
    strip = lambda p: [l for l in p.read_bytes().split(b"\n")  # noqa: E731
                       if not l.startswith(b"# Generated on")]
    assert strip(merged) == strip(single)
    assert merged.read_text().count(">") == N

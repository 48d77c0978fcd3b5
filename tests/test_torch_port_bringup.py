"""Multi-process bring-up of the port's CLI from torchrun's environment, on
the CPU with gloo: the counterpart of
tests/test_multiprocess.py::test_cli_pipeline_across_two_processes.

Two CLI processes get only torchrun's variables; ``main`` forms the group
(``parallel/distributed.py::maybe_initialize``), prints ``process i/W``,
runs the mode and closes the group. The pipeline's merged FASTA, the
sample mode's packed file and the experiment's loss history must equal a
one-process run: byte for byte for the first two (each row's bits do not
depend on which rank decoded it), and within the JAX contract's rtol 2e-4
/ atol 1e-5 for the losses (sums over the ranks in another order).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from genome_minimizer_2_torch import cli
from genome_minimizer_2_torch.parallel import distributed as tdist
from genome_minimizer_2_torch.utils import checkpoint as tckpt
from tests.test_torch_port_dp import free_port

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "_torch_mp_cli_worker.py"
EXPERIMENT = ("--mode experiment --device cpu --trainer-version v1 "
              "--hidden-dim 16 --latent-dim 4 --batch-size 8 --n-epochs 2 "
              "--no-generate-plots --checkpoint-every 1 --experiment-name {}")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A tiny GM2_ROOT with the essential positions and a random v0
    checkpoint at its gene width."""
    from genome_minimizer_2_torch.data import synthetic
    from genome_minimizer_2_torch.data.dataset import load_gene_vocab
    from genome_minimizer_2_torch.explore.essential_genes import EssentialGeneProcessor
    from genome_minimizer_2_torch.models import vae
    from genome_minimizer_2_torch.utils.config import ExperimentConfig

    base = tmp_path_factory.mktemp("bringup_root")
    info = synthetic.make_dataset_root(base, n_samples=40, n_genes=120,
                                       genome_length=4000, seed=0)
    cols = load_gene_vocab(info["presence_absence"])
    EssentialGeneProcessor(info["presence_absence"], info["phylogroups"],
                           info["essential_genes"],
                           base / "data" / "essential_genes").process()
    model = vae.init(vae.VAEConfig(input_dim=len(cols), hidden_dim=8,
                                   latent_dim=2),
                     torch.Generator().manual_seed(3))
    ck = base / "m.npz"
    tckpt.save_checkpoint(ck, model.flat_params(), model.flat_stats(),
                          ExperimentConfig(hidden_dim=8, latent_dim=2,
                                           trainer_version="v0"),
                          extra={"input_dim": len(cols)})
    return {**info, "ckpt": str(ck)}


def run_two(root, *calls):
    """Both ranks of the CLI, each call on a fresh port; their stdout."""
    args = [f"{free_port()}:{c}" for c in calls]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), "2", root["root"], *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    outs = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"rank {r}:\n{out[-2000:]}\n{err[-3000:]}"
            assert out.count(f"CLI_OK rank={r} rc=0") == len(calls)
            assert out.count(f"(process {r + 1}/2, gloo)") == len(calls)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _body(path) -> bytes:
    return b"".join(line for line in open(path, "rb")
                    if not line.startswith(b"# Generated on"))


def test_cli_pipeline_across_two_processes(root, tmp_path, monkeypatch):
    out = tmp_path / "merged.fasta"
    flags = (f"--mode pipeline --device cpu --model-path {root['ckpt']} "
             "--num-samples 10 --model-name mp --chunk-size 4 --seed 9")
    run_two(root, f"{flags} --data-parallel 2 --output-file {out}")
    assert not list(tmp_path.glob("*.done"))  # sentinels cleared by rank 0
    monkeypatch.setenv("GM2_ROOT", root["root"])
    solo = tmp_path / "solo.fasta"
    assert cli.main(f"{flags} --data-parallel 0 --output-file {solo}".split()) == 0
    assert _body(out).count(b">Minimized_") == 10
    assert _body(out) == _body(solo)


def test_cli_experiment_and_sample_across_two_processes(root, tmp_path,
                                                        monkeypatch):
    sample = (f"--mode sample --device cpu --model-path {root['ckpt']} "
              "--num-samples 9 --save-dtype packed --no-csv "
              "--no-generate-plots --seed 3 --data-parallel {}")
    run_two(root, EXPERIMENT.format("dp2") + " --data-parallel 0",
            sample.format(2))
    base = Path(root["root"])
    made = base / "models" / "v0_model" / "sampling_results" / \
        "v0_binary_samples_default.npz"
    two = made.read_bytes()
    made.unlink()

    monkeypatch.setenv("GM2_ROOT", root["root"])
    assert cli.main(sample.format(0).split()) == 0
    assert made.read_bytes() == two
    assert cli.main((EXPERIMENT.format("solo") + " --data-parallel 1").split()) == 0
    hist = {}
    for name in ("dp2", "solo"):
        state = base / "models" / "trained_models" / name / "train_state_2.npz"
        with np.load(state) as z:
            extra = json.loads(bytes(z["__config_json__"]).decode())["extra"]
        hist[name] = (extra["train_losses"]["total"], extra["val_losses"]["total"])
    for a, b in zip(hist["dp2"], hist["solo"]):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-5)


def test_data_parallel_other_than_zero_or_world_raises(root, monkeypatch):
    from genome_minimizer_2_torch.parallel import mesh

    monkeypatch.setenv("GM2_ROOT", root["root"])
    monkeypatch.setattr(mesh, "rank_and_world", lambda: (0, 2))
    for mode in ("pipeline", "sample"):
        with pytest.raises(ValueError, match="pass 0 or 2"):
            cli.main(["--mode", mode, "--device", "cpu", "--model-path",
                      root["ckpt"], "--data-parallel", "3"])
    with pytest.raises(ValueError, match="pass 0 or 2"):
        cli.main((EXPERIMENT.format("bad") + " --data-parallel 1").split())
    assert mesh.data_axis_size(0) == mesh.data_axis_size(2) == 2


def test_no_torchrun_environment_forms_no_group(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert tdist.maybe_initialize("cpu") is False
    assert tdist.rank_and_world() == (0, 1) and tdist.host_shard(10) == (0, 10)

"""The PyTorch/CUDA port stands alone: it imports neither ``jax`` nor the
JAX package, and its entry points run on the CUDA device unless the caller
asks for the CPU."""

import ast
import inspect
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "genome_minimizer_2_torch"
PORT_FILES = sorted(p.relative_to(REPO).as_posix() for p in PORT.rglob("*.py")
                    if "build" not in p.parts) + ["chip_smoke.py"]
# tests/ holds the generator of the JAX package's answers
# (tests/_torch_jax_golden.py), which imports JAX
FORBIDDEN = ("jax", "jaxlib", "genome_minimizer_2_tpu", "tests",
             "_torch_jax_golden")


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "for name in ('jax', 'jaxlib', 'genome_minimizer_2_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import genome_minimizer_2_torch as P\n"
        "names = [m.name for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 36


@pytest.mark.parametrize("relpath", PORT_FILES)
def test_no_jax_or_jax_package_import(relpath):
    tree = ast.parse((REPO / relpath).read_text(), filename=relpath)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for mod in mods:
            assert mod.split(".")[0] not in FORBIDDEN, (relpath, node.lineno, mod)


def _jax_api() -> list:
    import genome_minimizer_2_tpu  # its __init__ imports no JAX

    return sorted(genome_minimizer_2_tpu._API)


def test_public_api_resolves_with_jax_blocked():
    """Every name of the JAX package's lazy public API resolves in the port,
    on first access, with JAX and the JAX package blocked."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'genome_minimizer_2_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import genome_minimizer_2_torch as P\n"
        f"names = {_jax_api()!r}\n"
        "assert not any(n in vars(P) for n in names)  # lazy\n"
        "missing = [n for n in names if n not in dir(P) or getattr(P, n) is None]\n"
        "assert not missing, missing\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) == 20


@pytest.mark.parametrize("relpath", PORT_FILES)
def test_no_call_names_the_jax_answers_generator(relpath):
    """Neither the port nor chip_smoke.py runs or loads the generator of
    the JAX package's answers by name (importlib, runpy, exec, open)."""
    tree = ast.parse((REPO / relpath).read_text(), filename=relpath)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            for arg in ast.walk(node):
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    assert "_torch_jax_golden" not in arg.value, (relpath, node.lineno)


def test_golden_file_is_read_only_as_json():
    """The JAX package's answers reach the card only as JSON: the port never
    names the file, and chip_smoke.py names it once, as the default of
    ``load_golden``, which only parses it with ``json.loads``."""
    name = "torch_port_jax_v0.json"
    for relpath in PORT_FILES[:-1]:
        assert name not in (REPO / relpath).read_text(), relpath
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    uses = [n for n in ast.walk(tree) if isinstance(n, ast.Name) and n.id == "GOLDEN"]
    assert len(uses) == 2  # its assignment and load_golden's default
    (load,) = [n for n in ast.walk(tree)
               if isinstance(n, ast.FunctionDef) and n.name == "load_golden"]
    assert [a.arg for a in load.args.args] == ["path"]
    assert load.args.defaults[0].id == "GOLDEN"
    calls = {ast.unparse(c.func) for c in ast.walk(load) if isinstance(c, ast.Call)}
    assert calls == {"json.loads", "Path", "Path(path).read_text"}


def _entry_points():
    from genome_minimizer_2_torch import experiments
    from genome_minimizer_2_torch.core import dtypes, prng
    from genome_minimizer_2_torch.models import vae
    from genome_minimizer_2_torch.sample import sampler
    from genome_minimizer_2_torch.train import trainer

    return {
        "sampler.load_sampler": sampler.load_sampler,
        "vae.params_from_flat": vae.params_from_flat,
        "prng.key": prng.key,
        "dtypes.resolve_device": dtypes.resolve_device,
        "VAEConfig.feature_mask": vae.VAEConfig.feature_mask,
        "trainer.VAETrainer": trainer.VAETrainer,
        "trainer.create_trainer": trainer.create_trainer,
        "trainer.VAETrainerBuilder": trainer.VAETrainerBuilder,
        "experiments.IntegratedExperimentRunner":
            experiments.IntegratedExperimentRunner,
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_point_device_defaults_to_cuda(name):
    fn = _entry_points()[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"


# the modules of the staged workflow: each is imported with JAX blocked and
# has its imports scanned above
STAGED_MODULES = [
    "genome_minimizer_2_torch/explore/__init__.py",
    "genome_minimizer_2_torch/explore/essential_genes.py",
    "genome_minimizer_2_torch/explore/exploration.py",
    "genome_minimizer_2_torch/genome/object_npy.py",
    "genome_minimizer_2_torch/utils/profiling.py",
    "genome_minimizer_2_torch/utils/torch_import.py",
]


@pytest.mark.parametrize("relpath", STAGED_MODULES)
def test_staged_modules_are_covered(relpath):
    assert relpath in PORT_FILES


# the modules of elastic restarts, the trace, the bring-up and the data axis
PARALLEL_MODULES = [
    "genome_minimizer_2_torch/parallel/distributed.py",
    "genome_minimizer_2_torch/parallel/mesh.py",
    "genome_minimizer_2_torch/utils/elastic.py",
]


@pytest.mark.parametrize("relpath", PARALLEL_MODULES)
def test_parallel_modules_are_covered(relpath):
    assert relpath in PORT_FILES


@pytest.mark.parametrize("mode", ["pipeline", "training", "experiment", "sample",
                                  "convert-samples", "minimizer", "preprocess",
                                  "explore"])
def test_cli_device_defaults_to_cuda(mode):
    from genome_minimizer_2_torch import cli

    assert cli.parse_arguments(["--mode", mode]).device == "cuda"
    assert cli.parse_arguments(["--mode", mode, "--device", "cpu"]).device == "cpu"


def test_training_entry_points_raise_without_a_card(monkeypatch):
    from genome_minimizer_2_torch.experiments import IntegratedExperimentRunner
    from genome_minimizer_2_torch.train import trainer
    from genome_minimizer_2_torch.utils.config import get_v0_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: trainer.create_trainer("v0", get_v0_config(), 10),
                  lambda: trainer.VAETrainerBuilder(get_v0_config(), 10).build(),
                  lambda: IntegratedExperimentRunner(get_v0_config())):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()


def test_cuda_without_a_card_raises(monkeypatch):
    from genome_minimizer_2_torch.core.dtypes import resolve_device
    from genome_minimizer_2_torch.sample.sampler import load_sampler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_sampler("unused.npz")  # fails on the device before the file
    assert resolve_device("cpu").type == "cpu"


def test_kernel_wrapper_refuses_other_devices():
    """A CPU tensor takes the plain version; anything that is neither CPU
    nor CUDA raises — there is no quiet fallback."""
    from genome_minimizer_2_torch.ops import kernels as K

    h = torch.zeros(2, 4, device="meta")
    w = torch.zeros(4, 16, device="meta")
    b = torch.zeros(16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        K.decode_threshold_pack(h, w, b, compute_dtype=torch.float32)
    before = K.decode_threshold_pack.launches
    K.decode_threshold_pack(torch.zeros(2, 4), torch.zeros(4, 16),
                            torch.zeros(16), compute_dtype=torch.float32)
    assert K.decode_threshold_pack.launches == before  # CPU: no kernel launch

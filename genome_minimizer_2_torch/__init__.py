"""genome_minimizer_2_torch — the PyTorch/CUDA port of genome_minimizer_2_tpu.

The JAX package beside it is the reference; this package mirrors its layout
(``core/``, ``ops/``, ``models/``, ``train/``, ``sample/``, ``genome/``,
``eval/``, ``explore/``, ``parallel/``, ``utils/``, ``data/``,
``pipeline.py``, ``experiments.py``, ``cli.py``) so each module has an
obvious counterpart, and it never imports ``jax`` or
``genome_minimizer_2_tpu``.

It does what the JAX package does: VAE training (v0-v3 presets, data and
gene-axis tensor parallelism, elastic restarts, the epoch as CUDA graphs on
one card), sampling, conversion and minimization to FASTA, the streaming
pipeline, data exploration and evaluation, through every mode of
``python -m genome_minimizer_2_torch.cli``. Each Pallas kernel of the JAX
package is a hand-written CUDA kernel for sm_90a (``csrc/``), each with a
plain PyTorch version that CPU tensors take.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``--device cpu`` on the CLI); asking for CUDA on a host
without a card raises.
"""

__version__ = "0.1.0"

# Lazy public API, the JAX package's names: attribute access imports the
# submodule on first use, so `import genome_minimizer_2_torch` stays light.
_API = {
    "ExperimentConfig": "utils.config",
    "get_preset_config": "utils.config",
    "load_and_validate_data": "data.dataset",
    "load_matrix": "data.dataset",
    "load_gene_vocab": "data.dataset",
    "three_way_split": "data.split",
    "VAETrainer": "train.trainer",
    "create_trainer": "train.trainer",
    "Sampler": "sample.sampler",
    "load_sampler": "sample.sampler",
    "count_essential_genes": "sample.sampler",
    "MinimizerEngine": "genome.minimizer",
    "GenomeMinimiser": "genome.minimizer",
    "parse_genbank": "genome.genbank",
    "masks_to_gene_lists": "genome.converter",
    "check_essential_genes": "genome.converter",
    "convert_samples_streaming": "genome.converter",
    "save_packed_npz": "genome.converter",
    "sample_and_minimize": "pipeline",
    "IntegratedExperimentRunner": "experiments",
}


def __getattr__(name):
    if name in _API:
        import importlib

        module = importlib.import_module(f".{_API[name]}", __name__)
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_API))

"""Command line of the PyTorch/CUDA port.

    python -m genome_minimizer_2_torch.cli --mode experiment \
        --trainer-version v0 --hidden-dim 1024 --latent-dim 64 \
        --batch-size 2048 --n-epochs 2
    python -m genome_minimizer_2_torch.cli --mode training --preset v0
    python -m genome_minimizer_2_torch.cli --mode pipeline \
        --model-path model.npz --num-samples 4096 --output-file out.fasta

Ported so far: ``--mode training`` (a preset experiment), ``--mode
experiment`` (a custom config: every config field is a flag) and ``--mode
pipeline`` (streaming sample -> convert -> minimize to one FASTA), with
``main.py``'s flags for those modes plus ``--device`` (``cuda`` by default;
``cpu`` runs the plain PyTorch versions of the kernels). Data files are
found under ``GM2_ROOT`` as for ``main.py``.
"""

from __future__ import annotations

import argparse
import os

from .utils import directories
from .utils.config import (add_config_arguments, get_preset_config,
                           setup_experiment_config)


def parse_arguments(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="genome-minimizer-2, PyTorch/CUDA port")
    parser.add_argument("--mode", choices=["training", "experiment", "pipeline"],
                        default="pipeline",
                        help="Run mode: a preset training experiment, a "
                             "custom-config experiment, or the streaming "
                             "sample->convert->minimize pipeline")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="Device to run on (cpu runs the kernels' "
                             "plain PyTorch versions)")
    parser.add_argument("--preset", choices=["v0", "v1", "v2", "v3"], default="v3",
                        help="Which model preset to run (for training mode)")
    parser.add_argument("--epochs", type=int, default=None,
                        help="Override number of epochs (training mode)")
    parser.add_argument("--chunk-size", type=int, default=512,
                        help="Device chunk size (genomes per decode)")
    parser.add_argument("--transfer", choices=["auto", "packed", "feature-bits"],
                        default="auto",
                        help="Device->host transfer: packed gene bitmasks "
                             "('feature-bits' is not ported yet)")
    parser.add_argument("--model-path", type=str,
                        help="Trained model checkpoint (.npz)")
    parser.add_argument("--genome-path", type=str,
                        default=directories.wild_type_sequence(),
                        help="GenBank genome file (.gb or .genbank)")
    parser.add_argument("--output-file", type=str,
                        help="Output FASTA path")
    parser.add_argument("--model-name", type=str, default="default",
                        help="Model name for the FASTA header and file name")
    parser.add_argument("--num-samples", type=int, default=1,
                        help="Number of genomes to generate")
    parser.add_argument("--sampling-mode", choices=["default", "focused"],
                        default="default", help="Sampling mode")
    parser.add_argument("--noise-level", type=float, default=0.1,
                        help="Noise level for focused sampling")
    parser.add_argument("--no-merge", action="store_true",
                        help="Multi-process: keep each rank's FASTA shard "
                             "(output_file.shard{K}) instead of merging")
    parser.add_argument("--seed", type=int, default=0, help="PRNG seed")

    known_args, _ = parser.parse_known_args(argv)
    if known_args.mode == "experiment":
        add_config_arguments(parser)
    else:
        parser.add_argument("--data-parallel", type=int, default=1,
                            help="Data-parallel size (only 1 is ported)")
        parser.add_argument("--model-parallel", type=int, default=1,
                            help="Model-parallel size (only 1 is ported)")
    return parser.parse_args(argv)


def check_data_availability() -> bool:
    required = {
        "Main Dataset": directories.ten_k_dataset(),
        "Phylogroups": directories.ten_k_dataset_phylogroups(),
        "Essential Genes": directories.paper_essential_genes(),
    }
    missing = [f"{name}: {path}" for name, path in required.items()
               if not os.path.exists(path)]
    if missing:
        print("✗  Missing required data files:")
        for f in missing:
            print(f"   - {f}")
        print("- Point GM2_ROOT at a directory containing data/.")
        return False
    print("✓ All required data files found")
    return True


def run_pipeline(args):
    """Run ``--mode pipeline``; returns its PipelineStats, or None when an
    input is missing."""
    print("\n" + "=" * 80)
    print("STREAMING SAMPLE->CONVERT->MINIMIZE PIPELINE")
    print("=" * 80)
    if not args.model_path or not os.path.exists(args.model_path):
        print("✗ --model-path required (trained .npz checkpoint)")
        return None
    if not os.path.exists(args.genome_path):
        print(f"✗ Genome file not found: {args.genome_path}")
        return None
    if args.transfer == "feature-bits":
        print("✗ --transfer feature-bits is not ported yet (ROADMAP.md "
              "Queue 1: make_feature_decoder / --transfer feature-bits)")
        return None

    from .core import prng
    from .data.dataset import load_gene_vocab
    from .genome.converter import load_essential_set
    from .genome.minimizer import MinimizerEngine
    from .parallel.barrier import shard_file
    from .parallel.distributed import rank_and_world
    from .pipeline import sample_and_minimize
    from .sample.sampler import load_sampler

    cols = load_gene_vocab()
    essential_set = load_essential_set(directories.paper_essential_genes())
    sampler, _ = load_sampler(args.model_path, input_dim=len(cols),
                              device=args.device)
    engine = MinimizerEngine.from_genbank(args.genome_path)
    out = args.output_file or f"minimized_genomes_{args.model_name}.fasta"

    stats = sample_and_minimize(
        sampler, engine, cols, essential_set, args.num_samples, out,
        key=prng.key(args.seed, sampler.device), chunk_size=args.chunk_size,
        model_name=args.model_name, transfer=args.transfer,
        sampling_mode=args.sampling_mode, noise_level=args.noise_level,
        merge=not args.no_merge)
    rank, world = rank_and_world()
    if args.no_merge and world > 1:
        print(f"\n✓ PIPELINE COMPLETE: {stats.genomes} genomes -> "
              f"{shard_file(out, rank)} (per-shard output, no merge)")
    else:
        print(f"\n✓ PIPELINE COMPLETE: {stats.genomes} genomes -> {out}")
    print(f"- Throughput: {stats.rate():.1f} genomes/s whole-run, "
          f"{stats.steady_rate():.1f} genomes/s steady-state "
          f"(sample {stats.sample_s:.1f}s, "
          f"convert+minimize {stats.minimize_s:.1f}s, "
          f"total {stats.total_s:.1f}s) on {sampler.device}")
    return stats


def _report(config, results) -> None:
    print(f"\n{config.experiment_name.upper()} COMPLETED!")
    if "f1_overall" in results:
        print(f"F1 Score: {results['f1_overall']:.3f}")
        print(f"Accuracy: {results['accuracy_overall']:.3f}")


def _announce(config) -> None:
    print(f"\n{'=' * 80}")
    print(f"Running {config.experiment_name} experiment")
    print(f"Hidden dim: {config.hidden_dim}, Latent dim: {config.latent_dim}")
    print(f"Epochs: {config.n_epochs}, Trainer: {config.trainer_version}")
    print(f"{'=' * 80}")


def run_single_experiment(args):
    """Preset training experiment (``main.py:331-357``)."""
    print("\n" + "=" * 80)
    print("TRAINING EXPERIMENT RUN")
    print("=" * 80)
    from .experiments import IntegratedExperimentRunner

    config = get_preset_config(args.preset)
    if args.epochs:
        config.n_epochs = args.epochs
    config.seed = args.seed
    config.data_parallel = getattr(args, "data_parallel", 1)
    config.model_parallel = getattr(args, "model_parallel", 1)
    _announce(config)
    results = IntegratedExperimentRunner(config, device=args.device
                                         ).run_complete_experiment()
    _report(config, results)
    return results


def run_custom_experiment(args):
    """Custom-config experiment (``main.py:360-379``)."""
    print("\n" + "=" * 80)
    print("CUSTOM EXPERIMENT RUN")
    print("=" * 80)
    from .experiments import IntegratedExperimentRunner

    config = setup_experiment_config(args)
    _announce(config)
    results = IntegratedExperimentRunner(config, device=args.device
                                         ).run_complete_experiment()
    _report(config, results)
    return results


def main(argv=None) -> int:
    args = parse_arguments(argv)
    if args.device == "cuda":
        import torch

        # float32 products must be IEEE float32: set once here, never
        # flipped by library code (which only checks it)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    print(f"\nRunning in {args.mode} mode on {args.device}")
    if not check_data_availability():
        print("\n✗ Cannot proceed without required data files")
        return 1
    modes = {"training": run_single_experiment,
             "experiment": run_custom_experiment, "pipeline": run_pipeline}
    if modes[args.mode](args) is None:
        return 1
    print("\n" + "=" * 80)
    print("PROCESS COMPLETED!")
    print("=" * 80)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

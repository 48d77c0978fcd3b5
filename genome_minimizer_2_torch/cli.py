"""Command line of the PyTorch/CUDA port.

    python -m genome_minimizer_2_torch.cli --mode pipeline \\
        --model-path model.npz --num-samples 4096 --output-file out.fasta

Ported so far: ``--mode pipeline`` (streaming sample -> convert -> minimize
to one FASTA), with ``main.py``'s flags for that mode plus ``--device``
(``cuda`` by default; ``cpu`` runs the plain PyTorch versions of the
kernels). Data files are found under ``GM2_ROOT`` as for ``main.py``.
"""

from __future__ import annotations

import argparse
import os

from .utils import directories


def parse_arguments(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="genome-minimizer-2, PyTorch/CUDA port")
    parser.add_argument("--mode", choices=["pipeline"], default="pipeline",
                        help="Run mode (streaming sample->convert->minimize)")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="Device to decode on (cpu runs the kernels' "
                             "plain PyTorch versions)")
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


def main(argv=None) -> int:
    args = parse_arguments(argv)
    print(f"\nRunning in {args.mode} mode on {args.device}")
    if not check_data_availability():
        print("\n✗ Cannot proceed without required data files")
        return 1
    if run_pipeline(args) is None:
        return 1
    print("\n" + "=" * 80)
    print("PROCESS COMPLETED!")
    print("=" * 80)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

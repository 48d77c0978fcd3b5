"""Command line of the PyTorch/CUDA port.

    python -m genome_minimizer_2_torch.cli --mode experiment \
        --trainer-version v0 --hidden-dim 1024 --latent-dim 64 \
        --batch-size 2048 --n-epochs 2
    python -m genome_minimizer_2_torch.cli --mode training --preset v0
    python -m genome_minimizer_2_torch.cli --mode pipeline \
        --model-path model.npz --num-samples 4096 --output-file out.fasta
    python -m genome_minimizer_2_torch.cli --mode sample \
        --model-path saved_VAE_v0.pt --num-samples 4096 --save-dtype packed
    python -m genome_minimizer_2_torch.cli --mode convert-samples \
        --genes-path v0_binary_samples_default.npz --output-file ids.npy
    python -m genome_minimizer_2_torch.cli --mode minimizer --single-file \
        --genes-path ids_with_essentials.npy --output-file out.fasta

The eight modes of ``main.py`` with its flags: ``training`` (a preset
experiment), ``experiment`` (a custom config: every config field is a
flag), ``pipeline`` (streaming sample -> convert -> minimize to one FASTA,
``--transfer packed`` or ``feature-bits``), the staged workflow ``sample``
-> ``convert-samples`` -> ``minimizer`` (the same FASTA as ``pipeline`` at
the same ``--seed``), ``preprocess`` (essential-gene positions) and
``explore`` (figures + report). Beyond ``main.py``: ``--device`` (``cuda``
by default, raising without a card; ``cpu`` runs the plain PyTorch
versions of the kernels) and sample mode's ``--no-generate-plots`` (skips
the figure files only). ``--model-path`` takes the framework ``.npz`` or a
reference ``.pt`` state dict in sample and pipeline modes. Data files are
found under ``GM2_ROOT`` as for ``main.py``.

Multi-process: start one process per card with torchrun (``torchrun
--nproc-per-node 4 -m genome_minimizer_2_torch.cli --mode experiment
--data-parallel 0 ...``); :func:`main` forms the group from torchrun's
environment before any mode runs (NCCL on ``cuda``, gloo on ``cpu``) and
prints ``process i/W``. ``--data-parallel`` is the data axis: 0 means the
group's size W, and any other value must equal W. Training and experiment
modes train data-parallel over the global batch, sample mode decodes each
chunk's rows across the ranks, and pipeline mode partitions the genomes;
rank 0 writes the outputs.
"""

from __future__ import annotations

import argparse
import os
import pickle
import time
from pathlib import Path

from .utils import directories
from .utils.config import (add_config_arguments, get_preset_config,
                           setup_experiment_config)

MODES = ["training", "experiment", "minimizer", "explore", "preprocess",
         "sample", "convert-samples", "pipeline"]
# modes that read the dataset tree (main.py checks the same ones)
DATA_MODES = ("training", "experiment", "explore", "preprocess", "sample",
              "pipeline")


def parse_arguments(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="genome-minimizer-2, PyTorch/CUDA port")
    parser.add_argument("--mode", choices=MODES, default="pipeline",
                        help="Run mode ('pipeline' = streaming sample->"
                             "convert->minimize; 'sample', 'convert-samples' "
                             "and 'minimizer' are its three stages)")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="Device to run on (cpu runs the kernels' "
                             "plain PyTorch versions)")
    parser.add_argument("--chunk-size", type=int, default=512,
                        help="Pipeline device chunk size (genomes per "
                             "decode); also the row-chunk size of "
                             "convert-samples (0 = 1024)")
    parser.add_argument("--transfer", choices=["auto", "packed", "feature-bits"],
                        default="auto",
                        help="Pipeline device->host transfer: 'packed' gene "
                             "bitmasks (the default via auto) or "
                             "'feature-bits' (~14x less link traffic)")
    parser.add_argument("--preset", choices=["v0", "v1", "v2", "v3"], default="v3",
                        help="Which model preset to run (for training mode)")
    parser.add_argument("--epochs", type=int, default=None,
                        help="Override number of epochs (training mode)")
    parser.add_argument("--model-path", type=str,
                        help="Trained model checkpoint (.npz, or a reference "
                             ".pt state dict) for sampling")
    parser.add_argument("--genome-path", type=str,
                        default=directories.wild_type_sequence(),
                        help="GenBank genome file (.gb or .genbank)")
    parser.add_argument("--genes-path", type=str,
                        help="Gene lists (.npy) for the minimizer, the masks "
                             "file for convert-samples, or the "
                             "essential-positions pickle for sample mode")
    parser.add_argument("--output-dir", type=str, default="./minimized_genomes",
                        help="Output directory for minimized genomes "
                             "(multiple files)")
    parser.add_argument("--output-file", type=str,
                        help="Output file path (FASTA, or the gene lists of "
                             "convert-samples)")
    parser.add_argument("--single-file", action="store_true",
                        help="Minimizer: one FASTA file instead of one per "
                             "genome")
    parser.add_argument("--model-name", type=str, default="default",
                        help="Model name for the FASTA header and file name")
    parser.add_argument("--num-samples", type=int, default=1,
                        help="Number of genomes to generate")
    parser.add_argument("--sampling-mode", choices=["default", "focused"],
                        default="default", help="Sampling mode")
    parser.add_argument("--save-dtype", choices=["float32", "uint8", "packed"],
                        default="float32",
                        help="Format of sample mode's binary_samples file "
                             "(float32 .npy; uint8 .npy is 4x smaller; "
                             "'packed' writes the bitmask .npz, ~32x "
                             "smaller; convert-samples reads all three)")
    parser.add_argument("--noise-level", type=float, default=0.1,
                        help="Noise level for focused sampling")
    parser.add_argument("--no-merge", action="store_true",
                        help="Multi-process: keep each rank's FASTA shard "
                             "(output_file.shard{K}) instead of merging")
    parser.add_argument("--no-csv", action="store_true",
                        help="Sample mode: skip the genes x samples CSV")
    parser.add_argument("--force-reprocess", action="store_true",
                        help="Force reprocessing of essential gene positions")
    parser.add_argument("--seed", type=int, default=0, help="PRNG seed")

    known_args, _ = parser.parse_known_args(argv)
    if known_args.mode == "experiment":
        add_config_arguments(parser)
    else:
        if known_args.mode == "sample":
            parser.add_argument("--no-generate-plots", action="store_false",
                                dest="generate_plots",
                                help="Skip the figure files")
        parser.add_argument("--data-parallel", type=int, default=1,
                            help="Data axis: the process group's size W "
                                 "(0 = W; one process per card)")
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


def _banner(title: str) -> None:
    print("\n" + "=" * 80)
    print(title)
    print("=" * 80)


def _data_axis(args):
    """The data axis of sample and pipeline modes: a DataAxis for W > 1
    ranks, else None. ``--data-parallel`` must be 0 or W;
    ``--model-parallel`` above 1 raises (not ported)."""
    from .parallel.mesh import DataAxis, check_model_parallel, data_axis_size

    check_model_parallel(getattr(args, "model_parallel", 1))
    world = data_axis_size(getattr(args, "data_parallel", 1))
    return DataAxis.from_group() if world > 1 else None


def _model_path(args) -> str:
    """The checkpoint to load: a reference .pt converts to its cached
    ``.pt.npz`` sibling."""
    from .utils.torch_import import ensure_npz

    model_path = ensure_npz(args.model_path)
    if model_path != args.model_path:
        print(f"✓ Converted torch checkpoint -> {model_path}")
    return model_path


def run_data_exploration(args):
    """``--mode explore``: figures (when matplotlib is installed) and the
    summary report."""
    _banner("DATA EXPLORATION AND ANALYSIS")
    from .explore import exploration

    exploration.main()
    print("✓ Data exploration completed successfully")
    return True


def run_preprocessing(args):
    """``--mode preprocess``: the essential-gene positions pickle and its
    summary, unless they exist (``--force-reprocess``)."""
    _banner("DATA PREPROCESSING")
    positions_path = directories.essential_genes_positions()
    if os.path.exists(positions_path) and not args.force_reprocess:
        print(f"✓ Essential gene positions already exist: {positions_path}")
        print("Use --force-reprocess to regenerate\n")
        return True
    from .explore import essential_genes

    essential_genes.main()
    print("✓ Essential gene positions generated successfully")
    print(f"Saved to: {positions_path}\n")
    return True


def run_sampling(args):
    """``--mode sample``: sample genomes (kept packed), count genome sizes
    and essential genes per chunk as the chunks drain, plot, encode the test
    split for the latent PCA, and save the samples. Returns a dict of the
    outputs, or None when an input is missing."""
    _banner("MODEL SAMPLING")
    if not args.model_path:
        print("✗ Model path required for sampling mode")
        return None
    if not os.path.exists(args.model_path):
        print(f"✗ Model file not found: {args.model_path}")
        return None
    genes_path = args.genes_path or directories.essential_genes_positions()
    if not os.path.exists(genes_path):
        print(f"✗ Essential positions file not found: {genes_path}. "
              "Run preprocessing first.")
        return None
    axis = _data_axis(args)
    writer = axis is None or axis.rank == 0

    import numpy as np

    from .core import prng
    from .data import dataset as D
    from .data import split as S
    from .eval import visualise as V
    from .genome.converter import save_packed_npz
    from .sample import sampler as SMP
    from .utils.profiling import Throughput

    print("Loading dataset...")
    matrix = D.load_matrix()
    with open(genes_path, "rb") as f:
        essential_gene_positions = pickle.load(f)
    sp = S.three_way_split(matrix.n_samples, 0.3, 0.3333, 12345)
    test_x = matrix.data[sp.test_idx]
    test_labels = matrix.phylogroups[sp.test_idx]

    print(f"Detected input dimension: {matrix.n_genes}")
    print(f"Loading model from: {args.model_path}")
    sampler, config = SMP.load_sampler(_model_path(args),
                                       input_dim=matrix.n_genes,
                                       device=args.device, axis=axis)
    model_name = config.trainer_version
    output_dir = (directories.project_root() / "models" / f"{model_name}_model"
                  / "sampling_results")
    output_dir.mkdir(parents=True, exist_ok=True)
    print(f"✓ Created output_dir: {output_dir}")

    print(f"\n{'=' * 80}")
    print("Sampling Configuration:")
    print(f"- Model: {Path(args.model_path).name}")
    print(f"- Architecture: {matrix.n_genes} -> {config.hidden_dim} -> {config.latent_dim}")
    print(f"- Samples: {args.num_samples}")
    print(f"- Mode: {args.sampling_mode}")
    print(f"- Device: {sampler.device}")
    print(f"- Output: {output_dir}")
    print(f"{'=' * 80}")

    # Samples stay packed (N, ceil(D/8)); genome sizes and essential counts
    # are taken per chunk as it drains, while the device decodes the next
    meter = Throughput()
    key = prng.key(args.seed, sampler.device)
    counter = SMP.make_essential_counter_packed(essential_gene_positions,
                                                width=matrix.n_genes)
    size_parts, ess_parts = [], []

    def analyze_chunk(lo, hi, chunk):
        size_parts.append(SMP.popcount_rows(chunk))
        ess_parts.append(counter(chunk))

    with meter.phase("sample+analyze", args.num_samples):
        if args.sampling_mode == "default":
            print("Generating default samples...")
            packed, _ = sampler.sample_packed(key, args.num_samples,
                                              on_chunk=analyze_chunk)
        else:
            print("Generating focused samples...")
            packed, _ = sampler.sample_focused_packed(
                key, args.num_samples, noise_level=args.noise_level,
                on_chunk=analyze_chunk)
        genome_sizes = np.concatenate(size_parts)
        essential_counts = np.concatenate(ess_parts)
    print("\n✓ Sampling Results:")
    print(f"- Generated samples: {packed.shape[0]}")
    print(f"- Median genome size: {np.median(genome_sizes):.0f} genes")
    print(f"- Genome size range: {np.min(genome_sizes):.0f} - {np.max(genome_sizes):.0f}")
    print(f"- Median essential genes: {np.median(essential_counts):.0f}")
    print(f"- Essential range: {np.min(essential_counts):.0f} - {np.max(essential_counts):.0f}")

    stem = f"{model_name}_{{}}_{args.sampling_mode}.pdf"
    if args.generate_plots and writer:
        print("\nGenerating analysis plots...")
        V.plot_samples_distribution(
            genome_sizes,
            str(output_dir / stem.format("genome_size_distribution")),
            "dodgerblue", 3000, 5000)
        V.plot_essential_genes_distribution(
            essential_counts,
            str(output_dir / stem.format("essential_genes_distribution")),
            "violet", int(np.min(essential_counts) * 0.9),
            int(np.max(essential_counts) * 1.1))
        V.plot_essential_vs_total(
            essential_counts, genome_sizes,
            str(output_dir / stem.format("essential_vs_total")))
    else:
        print("\nSkipping the figure files (--no-generate-plots)")

    print("Analyzing latent space...")
    latents = sampler.encode_means(test_x)
    V.plot_latent_space_pca(latents, test_labels, config, str(output_dir),
                            n_components=2,
                            show_plot=args.generate_plots and writer)

    print("Saving results..." if writer else "Rank 0 saves the results")
    base = output_dir / f"{model_name}_binary_samples_{args.sampling_mode}"
    samples_path = str(base) + (".npz" if args.save_dtype == "packed" else ".npy")
    with meter.phase("save", args.num_samples if writer else 0):
        if writer and args.save_dtype == "packed":
            save_packed_npz(packed, matrix.n_genes, samples_path)
        elif writer:
            SMP.save_binary_npy_stream(packed, matrix.n_genes, samples_path,
                                       dtype=np.dtype(args.save_dtype))
        if writer and not args.no_csv:
            SMP.write_samples_csv_stream(
                packed, matrix.genes,
                str(output_dir / f"{model_name}_data_full_samples_df.csv"))
    print("\n✓ SAMPLING COMPLETE!")
    print(f"- Results saved to: {output_dir}")
    print(meter.report())
    return {"output_dir": str(output_dir), "samples_path": samples_path,
            "genome_sizes": genome_sizes, "essential_counts": essential_counts,
            "latents": latents, "meter": meter}


def run_genome_minimizer(args):
    """``--mode minimizer``: minimize every gene list of ``--genes-path``
    into one FASTA (``--single-file`` / ``--output-file``) or one file per
    genome. Returns the statistics, or None when an input is missing."""
    _banner("GENOME MINIMIZER RUN")
    if not os.path.exists(args.genome_path):
        print(f"✗ Genome file not found: {args.genome_path}")
        return None
    if not args.genes_path:
        print("✗ Genes path required for genome minimizer")
        return None
    if not os.path.exists(args.genes_path):
        print(f"✗ Genes file not found: {args.genes_path}")
        return None

    from .genome.minimizer import (process_multiple_genomes_multiple_files,
                                   process_multiple_genomes_single_file)
    from .utils.profiling import Throughput

    print(f"\n{'=' * 80}")
    print(f"Processing genome: {Path(args.genome_path).name}")
    print(f"Using genes from: {Path(args.genes_path).name}")
    print(f"Model name: {args.model_name}")
    print(f"{'=' * 80}")

    if args.output_file:
        output_dir = Path(args.output_file).parent
        output_filename = Path(args.output_file).name
    elif args.single_file:
        output_dir = Path(args.output_dir)
        output_filename = f"minimized_genomes_{args.model_name}.fasta"
    else:
        output_dir = Path(args.output_dir)
        output_filename = None
    output_dir.mkdir(parents=True, exist_ok=True)
    print(f"✓ Created output directory: {output_dir}")

    meter = Throughput()
    t0 = time.perf_counter()
    if args.single_file or args.output_file:
        output_file = output_dir / output_filename
        print(f"Generating single FASTA file: {output_file}")
        result = process_multiple_genomes_single_file(
            genome_path=args.genome_path, genes_path=args.genes_path,
            model_name=args.model_name, output_file=str(output_file))
        print("\n✓ GENOME MINIMIZATION COMPLETED!")
        print(f"- Single file generated: {output_file}")
    else:
        print(f"Generating multiple files in: {output_dir}")
        result = process_multiple_genomes_multiple_files(
            genome_path=args.genome_path, genes_path=args.genes_path,
            model_name=args.model_name, output_dir=str(output_dir))
        print("\n✓ GENOME MINIMIZATION COMPLETED!")
    meter.add("minimize", result["genome_count"], time.perf_counter() - t0)
    print(f"- Processed: {result['genome_count']} genomes")
    print(f"- Average percentage reduction: {result['average_reduction_pct']:.1f}%")
    print(f"- Average genome length: {result['average_length_bp']:,.1f} bp")
    print(f"- Throughput: {meter.report()}")
    return result


def run_binary_converter(args):
    """``--mode convert-samples``: the masks file of ``--genes-path`` (any
    format sample mode saves) to per-sample gene lists, and the lists with
    the essentials filled in. Returns their paths, or None when the input
    is missing."""
    from .data.dataset import load_gene_vocab
    from .genome.converter import convert_samples_streaming, load_essential_set

    if not args.genes_path:
        print("✗ --genes-path is required in convert-samples mode (input masks .npy)")
        return None
    if not os.path.exists(args.genes_path):
        print(f"✗ Input masks file not found: {args.genes_path}")
        return None

    out_path = args.output_file or "seq_out.npy"
    cols = load_gene_vocab()  # the gene vocabulary only, cache-backed
    print(f"Gene vocabulary: {len(cols)} genes")
    essential_set = load_essential_set(directories.paper_essential_genes())
    out_path, filled_path, n = convert_samples_streaming(
        args.genes_path, cols, out_path, essential_set=essential_set,
        chunk_size=args.chunk_size or 1024)
    print("✓ Binary conversion complete")
    print(f"- Gene lists: {out_path}")
    print(f"- Gene lists (essentials filled): {filled_path}")
    return {"gene_lists": out_path, "with_essentials": filled_path,
            "samples": n}


def run_pipeline(args):
    """Run ``--mode pipeline``; returns its PipelineStats, or None when an
    input is missing."""
    _banner("STREAMING SAMPLE->CONVERT->MINIMIZE PIPELINE")
    if not args.model_path or not os.path.exists(args.model_path):
        print("✗ --model-path required (trained checkpoint)")
        return None
    if not os.path.exists(args.genome_path):
        print(f"✗ Genome file not found: {args.genome_path}")
        return None
    _data_axis(args)  # the ranks partition the genomes: 0 or W

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
    sampler, _ = load_sampler(_model_path(args), input_dim=len(cols),
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
    _banner("TRAINING EXPERIMENT RUN")
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
    _banner("CUSTOM EXPERIMENT RUN")
    from .experiments import IntegratedExperimentRunner

    config = setup_experiment_config(args)
    _announce(config)
    results = IntegratedExperimentRunner(config, device=args.device
                                         ).run_complete_experiment()
    _report(config, results)
    return results


MODE_RUNNERS = {
    "training": run_single_experiment, "experiment": run_custom_experiment,
    "minimizer": run_genome_minimizer, "explore": run_data_exploration,
    "preprocess": run_preprocessing, "sample": run_sampling,
    "convert-samples": run_binary_converter, "pipeline": run_pipeline,
}


def main(argv=None) -> int:
    args = parse_arguments(argv)
    import torch.distributed as dist

    from .core.dtypes import resolve_device
    from .parallel.distributed import maybe_initialize

    resolve_device(args.device)  # --device cuda without a card raises here
    # multi-process: the group forms here, from torchrun's environment,
    # before any mode runs; one process: no-op
    formed = not dist.is_initialized() and maybe_initialize(args.device)
    try:
        return _run(args)
    finally:
        if formed:
            dist.destroy_process_group()


def _run(args) -> int:
    import torch.distributed as dist

    from .core.dtypes import resolve_device
    from .parallel.distributed import rank_and_world

    device = resolve_device(args.device)
    if args.device == "cuda":
        import torch

        # float32 products must be IEEE float32: set once here, never
        # flipped by library code (which only checks it)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mode_line = f"\nRunning in {args.mode} mode on {device}"
    if dist.is_initialized():
        rank, world = rank_and_world()
        mode_line += f" (process {rank + 1}/{world}, {dist.get_backend()})"
    print(mode_line)
    if args.mode in DATA_MODES and not check_data_availability():
        print("\n✗ Cannot proceed without required data files")
        return 1
    if MODE_RUNNERS[args.mode](args) is None:
        return 1
    print("\n" + "=" * 80)
    print("PROCESS COMPLETED!")
    print("=" * 80)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Experiment configuration: the port's own copy of the JAX package's
``utils/config.py`` (the dataclass with its dict / JSON / argparse /
interactive loading, the v0-v3 presets and the config report).

Checkpoints carry ``ExperimentConfig.to_dict()`` as JSON, so the field set
is kept identical (including the JAX-specific fields such as
``use_pallas_gather``) for checkpoints to round-trip between the packages.
"""

from __future__ import annotations

import argparse
import json
from dataclasses import dataclass, fields
from pathlib import Path
from typing import Any, Dict


@dataclass
class ExperimentConfig:
    """Configuration for experiments (reference parity: custom_config.py:13-54)."""

    # Model parameters
    hidden_dim: int = 512
    latent_dim: int = 32

    # Training parameters
    n_epochs: int = 1
    batch_size: int = 32
    learning_rate: float = 1e-3
    max_norm: float = 1.0
    lambda_l1: float = 0.01

    # Loss scheduling parameters
    min_beta: float = 0.0
    max_beta: float = 1.0
    gamma_start: float = 1.0
    gamma_end: float = 0.1
    weight: float = 1.0  # for v3

    # Trainer version
    trainer_version: str = "v2"  # v0, v1, v2, v3

    # Scheduler parameters
    scheduler_step_size: int = 20
    scheduler_gamma: float = 0.5

    # Data split parameters
    test_size: float = 0.3
    val_ratio: float = 0.3333
    random_state: int = 12345

    # Output parameters
    experiment_name: str = "experiment"
    save_model: bool = True
    generate_plots: bool = True
    calculate_metrics: bool = True
    explore_latent_space: bool = True

    # --- Extensions over the reference (fields of the JAX package; the
    # training and mesh fields are carried for checkpoint round-trips and
    # are not read by the port's sampling path yet) ---
    seed: int = 0                 # root PRNG seed
    compute_dtype: str = "auto"   # 'auto' (bf16 on CUDA, f32 on CPU) / explicit
    data_parallel: int = 1
    model_parallel: int = 1
    pad_features: bool = True     # pad the gene axis to a multiple of 128
    shard_data: bool = True
    use_pallas_gather: bool = True
    use_fused_optimizer: bool = True
    adam_state_dtype: str = "auto"

    # Early stopping
    patience: int = 10
    min_delta: float = 1e-4
    print_every: int = 100

    # Fault tolerance / observability
    checkpoint_every: int = 0
    resume_from: str = ""
    max_restarts: int = 0
    profile_dir: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    def update_from_dict(self, overrides: Dict[str, Any], verbose: bool = True):
        """Update from a dict with type coercion (custom_config.py:109-142)."""
        updated, invalid = [], []
        ftypes = {f.name: f.type for f in fields(self)}
        for key, value in overrides.items():
            if key not in ftypes:
                invalid.append(f"{key}: parameter not found")
                continue
            try:
                ftype = ftypes[key]
                if ftype in (bool, "bool") and isinstance(value, str):
                    value = value.lower() in ["true", "t", "1", "yes", "y"]
                elif ftype in (int, "int") and isinstance(value, str):
                    value = int(value)
                elif ftype in (float, "float") and isinstance(value, str):
                    value = float(value)
                setattr(self, key, value)
                updated.append(f"{key}: {value}")
            except (ValueError, TypeError) as e:
                invalid.append(f"{key}: {e}")
        if verbose and updated:
            print("\n✓ Updated parameters:")
            for p in updated:
                print(f"  {p}")
        if verbose and invalid:
            print("\n✗ Invalid parameters:")
            for p in invalid:
                print(f"  {p}")

    def save_to_json(self, filepath: str):
        with open(filepath, "w") as f:
            json.dump(self.to_dict(), f, indent=2)
        print(f"Configuration saved to {filepath}")

    def load_from_json(self, filepath: str):
        if not Path(filepath).exists():
            print(f"Configuration file {filepath} not found.")
            return
        with open(filepath) as f:
            self.update_from_dict(json.load(f))
        print(f"Configuration loaded from {filepath}")

    def interactive_override(self):
        """Interactive REPL override (custom_config.py:56-107)."""
        print("\n" + "=" * 60)
        print("INTERACTIVE PARAMETER OVERRIDE")
        print("=" * 60)
        print("Press Enter to keep default value, or type new value to override.")
        print("Type 'skip' to skip all remaining parameters.")
        print("-" * 60)
        for finfo in fields(self):
            current = getattr(self, finfo.name)
            if finfo.type in (bool, "bool"):
                prompt = f"{finfo.name} [{current}] (true/false): "
            elif finfo.name == "trainer_version":
                prompt = f"{finfo.name} [{current}] (v0/v1/v2/v3): "
            else:
                prompt = f"{finfo.name} [{current}]: "
            try:
                user_input = input(prompt).strip()
                if user_input.lower() == "skip":
                    print("Skipping remaining parameters...")
                    break
                if user_input == "":
                    continue
                self.update_from_dict({finfo.name: user_input}, verbose=False)
                print(f"✓ Updated {finfo.name} to {getattr(self, finfo.name)}")
            except ValueError as e:
                print(f"✗ Invalid input for {finfo.name}: {e}")
            except KeyboardInterrupt:
                print("\n\n✗ Process interrupted by user")
                break

    @classmethod
    def from_args(cls, args: argparse.Namespace) -> "ExperimentConfig":
        config = cls()
        args_dict = {k: v for k, v in vars(args).items() if v is not None}
        for arg in ("mode", "config_file", "interactive"):
            args_dict.pop(arg, None)
        valid = {f.name for f in fields(cls)}
        args_dict = {k: v for k, v in args_dict.items() if k in valid}
        if args_dict:
            config.update_from_dict(args_dict)
        return config


# ---------------------------------------------------------------------------
# Presets (reference parity: experiments.py:42-114)
# ---------------------------------------------------------------------------

def get_v0_config() -> ExperimentConfig:
    """v0: 1024 hidden, 64 latent, linear KL annealing."""
    return ExperimentConfig(
        hidden_dim=1024, latent_dim=64, n_epochs=10000,
        min_beta=0.1, max_beta=1.0, lambda_l1=0.0,
        trainer_version="v0", experiment_name="v0_model",
    )


def get_v1_config() -> ExperimentConfig:
    """v1: 512 hidden, 32 latent, linear annealing + gene abundance + L1."""
    return ExperimentConfig(
        hidden_dim=512, latent_dim=32, n_epochs=10000,
        min_beta=0.1, max_beta=1.0, gamma_start=1.0, gamma_end=0.1,
        lambda_l1=0.01, trainer_version="v1", experiment_name="v1_model",
    )


def get_v2_config() -> ExperimentConfig:
    """v2: 512 hidden, 32 latent, cosine annealing + gene abundance + L1."""
    return ExperimentConfig(
        hidden_dim=512, latent_dim=32, n_epochs=10000,
        min_beta=0.0, max_beta=1.0, gamma_start=1.0, gamma_end=0.1,
        lambda_l1=0.01, trainer_version="v2", experiment_name="v2_model",
    )


def get_v3_config() -> ExperimentConfig:
    """v3: 512 hidden, 32 latent, cosine annealing + weighted abundance + L1."""
    return ExperimentConfig(
        hidden_dim=512, latent_dim=32, n_epochs=10000,
        min_beta=0.1, max_beta=1.0, gamma_start=2.0, gamma_end=0.1,
        weight=1.0, lambda_l1=0.01, trainer_version="v3",
        experiment_name="v3_model", patience=20,
    )


PRESETS = {
    "v0": get_v0_config,
    "v1": get_v1_config,
    "v2": get_v2_config,
    "v3": get_v3_config,
}


def get_preset_config(name: str) -> ExperimentConfig:
    try:
        return PRESETS[name]()
    except KeyError:
        raise ValueError(f"Unknown preset {name!r}; expected one of {sorted(PRESETS)}")


# ---------------------------------------------------------------------------
# argparse integration (reference parity: custom_config.py:184-266)
# ---------------------------------------------------------------------------

def add_config_arguments(parser: argparse.ArgumentParser):
    """Register every config field as a CLI flag (custom_config.py:184-244)."""
    model_group = parser.add_argument_group("Model Parameters")
    model_group.add_argument("--hidden-dim", type=int, help="Hidden dimension size")
    model_group.add_argument("--latent-dim", type=int, help="Latent dimension size")

    train_group = parser.add_argument_group("Training Parameters")
    train_group.add_argument("--n-epochs", type=int, help="Number of training epochs")
    train_group.add_argument("--batch-size", type=int, help="Batch size")
    train_group.add_argument("--learning-rate", type=float, help="Learning rate")
    train_group.add_argument("--max-norm", type=float, help="Max gradient norm")
    train_group.add_argument("--lambda-l1", type=float, help="L1 regularization weight")

    loss_group = parser.add_argument_group("Loss Scheduling Parameters")
    loss_group.add_argument("--min-beta", type=float, help="Minimum beta value")
    loss_group.add_argument("--max-beta", type=float, help="Maximum beta value")
    loss_group.add_argument("--gamma-start", type=float, help="Starting gamma value")
    loss_group.add_argument("--gamma-end", type=float, help="Ending gamma value")
    loss_group.add_argument("--weight", type=float, help="Weight parameter for v3")

    trainer_group = parser.add_argument_group("Trainer Parameters")
    trainer_group.add_argument("--trainer-version", choices=["v0", "v1", "v2", "v3"],
                               help="Trainer version")

    sched_group = parser.add_argument_group("Scheduler Parameters")
    sched_group.add_argument("--scheduler-step-size", type=int, help="Scheduler step size")
    sched_group.add_argument("--scheduler-gamma", type=float, help="Scheduler gamma")

    data_group = parser.add_argument_group("Data Split Parameters")
    data_group.add_argument("--test-size", type=float, help="Test split size")
    data_group.add_argument("--val-ratio", type=float, help="Validation ratio")
    data_group.add_argument("--random-state", type=int, help="Random state seed")

    output_group = parser.add_argument_group("Output Parameters")
    output_group.add_argument("--experiment-name", type=str, help="Experiment name")
    output_group.add_argument("--save-model", action="store_true", default=None)
    output_group.add_argument("--no-save-model", action="store_false", dest="save_model")
    output_group.add_argument("--generate-plots", action="store_true", default=None)
    output_group.add_argument("--no-generate-plots", action="store_false", dest="generate_plots")
    output_group.add_argument("--calculate-metrics", action="store_true", default=None)
    output_group.add_argument("--no-calculate-metrics", action="store_false", dest="calculate_metrics")
    output_group.add_argument("--explore-latent-space", action="store_true", default=None)
    output_group.add_argument("--no-explore-latent-space", action="store_false",
                              dest="explore_latent_space")

    dev_group = parser.add_argument_group("Device Parameters")
    # (--seed is owned by the host CLI, which defines it for every mode)
    dev_group.add_argument("--compute-dtype",
                           choices=["auto", "float32", "bfloat16"],
                           help="Matmul compute dtype ('auto' = bfloat16 on "
                                "CUDA, float32 on the CPU)")
    dev_group.add_argument("--data-parallel", type=int,
                           help="Data axis: the process group's size W over "
                                "the model axis (0 = W / model; one process "
                                "per card)")
    dev_group.add_argument("--model-parallel", type=int,
                           help="Model axis: ranks that split the gene axis "
                                "(must divide W; fastest-varying)")

    ft_group = parser.add_argument_group("Fault Tolerance / Observability")
    ft_group.add_argument("--checkpoint-every", type=int,
                          help="Write a full train-state checkpoint every N epochs")
    ft_group.add_argument("--resume-from", type=str,
                          help="Resume training from a train-state checkpoint")
    ft_group.add_argument("--max-restarts", type=int,
                          help="Auto-resume from the newest checkpoint after "
                               "crashes, up to N times (needs "
                               "--checkpoint-every)")
    ft_group.add_argument("--profile-dir", type=str,
                          help="Write a torch.profiler trace of training "
                               "here (or set GM2_PROFILE_DIR)")

    config_group = parser.add_argument_group("Configuration Options")
    config_group.add_argument("--config-file", type=str, help="Load configuration from JSON file")
    config_group.add_argument("--interactive", action="store_true",
                              help="Interactive parameter override mode")


def setup_experiment_config(args: argparse.Namespace) -> ExperimentConfig:
    """Build a config from defaults -> JSON file -> CLI flags -> interactive."""
    config = ExperimentConfig.from_args(args)
    if getattr(args, "config_file", None):
        config.load_from_json(args.config_file)
        # CLI flags win over file values
        cli = {k: v for k, v in vars(args).items() if v is not None}
        valid = {f.name for f in fields(ExperimentConfig)}
        config.update_from_dict({k: v for k, v in cli.items() if k in valid}, verbose=False)
    if getattr(args, "interactive", False):
        config.interactive_override()
    return config


def config_report(config: ExperimentConfig) -> str:
    """Formatted configuration report (experiments.py:147-193)."""
    import datetime

    lines = ["=" * 80, "EXPERIMENT CONFIGURATION", "=" * 80,
             f"Generated on: {datetime.datetime.now().strftime('%Y-%m-%d %H:%M:%S')}", ""]
    categories = {
        "Model Parameters": ["hidden_dim", "latent_dim"],
        "Training Parameters": ["n_epochs", "batch_size", "learning_rate", "max_norm", "lambda_l1"],
        "Loss Scheduling": ["min_beta", "max_beta", "gamma_start", "gamma_end", "weight"],
        "Trainer": ["trainer_version"],
        "Scheduler": ["scheduler_step_size", "scheduler_gamma"],
        "Data Split": ["test_size", "val_ratio", "random_state"],
        "Output": ["experiment_name", "save_model", "generate_plots",
                   "calculate_metrics", "explore_latent_space"],
        "Device": ["seed", "compute_dtype", "data_parallel", "model_parallel", "pad_features"],
    }
    for category, params in categories.items():
        lines.append(f"{category}:")
        lines.append("-" * len(category))
        for param in params:
            if hasattr(config, param):
                lines.append(f"  {param:<20}: {getattr(config, param)}")
        lines.append("")
    lines.append("=" * 80)
    return "\n".join(lines)

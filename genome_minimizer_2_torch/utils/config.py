"""Experiment configuration: the port's own copy of the JAX package's
``utils/config.py`` dataclass and its v0-v3 presets.

Checkpoints carry ``ExperimentConfig.to_dict()`` as JSON, so the field set
is kept identical (including the JAX-specific fields such as
``use_pallas_gather``) for checkpoints to round-trip between the packages.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
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

"""Checkpoint save/load in the JAX package's framework-neutral format.

One ``.npz`` holding '/'-joined pytree paths (``params/decoder/3/w``,
``batch_stats/encoder/0/mean``, ...) plus a ``__config_json__`` blob with
the experiment config and extras (genome_minimizer_2_tpu/utils/
checkpoint.py:80-114). The port reads the JAX package's checkpoints as they
are and writes the same layout, so either package loads the other's files;
``models.vae.params_from_flat`` carries the arrays into a model. Under
tensor parallelism the files hold full leaves too: a train state's gene
slices are gathered over the model axis on save (every rank calls the
save, rank 0 writes) and cut to each rank's slice on load
(``train/trainer.py::state_to_flat`` / ``state_from_flat``).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..parallel.distributed import rank_and_world
from .config import ExperimentConfig

_CONFIG_KEY = "__config_json__"


def _write_npz(path: Path, arrays: Dict[str, np.ndarray]) -> bool:
    """Rank-0-only atomic write (tmp file + fsync + rename), so an
    interrupted save never leaves a truncated checkpoint. Returns whether
    this process wrote it."""
    if rank_and_world()[0] != 0:
        return False
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.suffix != ".npz":  # np.savez's extension coercion
        path = path.with_name(path.name + ".npz")
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return True


def _to_numpy(flat: Dict[str, Any]) -> Dict[str, np.ndarray]:
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in flat.items()}


def save_checkpoint(
    path: str | Path,
    params: Dict[str, Any],
    batch_stats: Dict[str, Any],
    config: ExperimentConfig,
    extra: Dict[str, Any] | None = None,
) -> None:
    """Write flat {path: array-or-tensor} params and batch stats (e.g.
    ``model.flat_params()`` / ``model.flat_stats()``) with the config."""
    arrays = {}
    arrays.update({"params/" + k: v for k, v in _to_numpy(params).items()})
    arrays.update({"batch_stats/" + k: v
                   for k, v in _to_numpy(batch_stats).items()})
    meta = {"config": config.to_dict(), "extra": extra or {}}
    arrays[_CONFIG_KEY] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    _write_npz(Path(path), arrays)


def load_checkpoint(path: str | Path) -> Tuple[Dict, Dict, ExperimentConfig, Dict]:
    """Returns (flat_params, flat_batch_stats, config, extra), the flat
    dicts mapping '/'-joined paths to numpy arrays."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays.pop(_CONFIG_KEY)).decode("utf-8"))
    config = ExperimentConfig()
    config.update_from_dict(meta["config"], verbose=False)
    params = {k[len("params/"):]: v for k, v in arrays.items()
              if k.startswith("params/")}
    stats = {k[len("batch_stats/"):]: v for k, v in arrays.items()
             if k.startswith("batch_stats/")}
    return params, stats, config, meta.get("extra", {})


def save_train_state(path: str | Path, state, config: ExperimentConfig,
                     epoch: int, extra: Dict[str, Any] | None = None) -> None:
    """Full mid-training checkpoint in the JAX package's layout
    (``checkpoint.py:117-136``): params, batch stats, the optax
    ``(EmptyState, ScaleByAdamState(count, mu, nu))`` optimizer state as
    ``opt_state/1/.count`` / ``.mu/...`` / ``.nu/...``, the cosine-beta
    ``counter`` and the PRNG ``rng_key_data``. ``state`` is a
    ``train.trainer.TrainState``; bf16 moments are written widened to
    float32 (exact)."""
    from ..train.trainer import state_to_flat

    arrays = state_to_flat(state)
    meta = {"config": config.to_dict(), "extra": dict(extra or {}, epoch=epoch)}
    arrays[_CONFIG_KEY] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    _write_npz(Path(path), arrays)


def load_train_state(path: str | Path, trainer):
    """Rebuild a TrainState for ``trainer`` from a train-state file written
    by either package. Returns (state, epoch, extra)."""
    from ..train.trainer import state_from_flat

    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays.pop(_CONFIG_KEY)).decode("utf-8"))
    extra = meta.get("extra", {})
    return state_from_flat(trainer, arrays), int(extra.get("epoch", 0)), extra

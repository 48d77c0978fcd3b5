"""VAE trainer: the port of the JAX package's ``train/trainer.py`` (:63-622).

Semantics kept from the JAX trainer (and through it from the reference):

- per-epoch losses are summed over batches, then divided by the dataset
  size; the remainder batch is trained on at its true shape (exact
  BatchNorm statistics);
- one shuffle per train epoch from ``split(state.rng)``: on a CUDA device
  with batch >= 256 and n % 8 == 0 it permutes 8-row blocks through the
  ``gather_row_blocks`` kernel (``permutation(n // 8)``), as the JAX trainer
  does on a TPU; otherwise it is the exact row permutation
  ``permutation(n)`` and a row gather;
- each step: ``rng, key = split(rng)``, train-mode forward with eps drawn
  from ``key``, the loss bundle, autograd (the output layer's backward is
  the ``output_layer_bwd`` kernel), then the fused clip + Adam + apply
  (``clip_adam_apply``, one launch per leaf);
- validation steps run BatchNorm in eval mode but still draw eps, and bump
  the cosine-beta counter;
- StepLR per epoch, early stopping on the validation total, and a single
  host sync per epoch (the loss sums).

On W > 1 data-parallel ranks (``config.data_parallel`` 0 or W, the process
group as the data axis, ``parallel/mesh.py``) the trainer computes over the
global batch, as the JAX trainer does under GSPMD (trainer.py:116-168,
262-299): each rank holds its contiguous share of the rows
(``shard_data``); every epoch, train and validation, takes the exact row
order (the permutation ``permutation(n)`` of the whole set, or the
identity) and each rank receives its contiguous share of every batch from
the ranks that hold those rows, once per epoch; BatchNorm, the noise draw
and the losses see the global batch (``RowShare``); every leaf's gradient
is summed over the ranks before the global norm and the update, so every
rank applies the same update; the epoch's loss sums are summed over the
ranks. At W = 1 it is the one-process code.

The state is updated in place (the JAX TrainState is immutable). Its
checkpoint layout is the JAX package's, so a train-state file written by
either package resumes in the other (``utils/checkpoint.py``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..core import prng
from ..core.dtypes import resolve_device, resolve_policy
from ..models import vae
from ..ops import kernels as K
from ..ops import losses as L
from ..ops.optimizer import AdamState, clip_adam_step
from ..parallel.mesh import (DataAxis, RowShare, check_model_parallel,
                             data_axis_size, local_row_range)
from ..utils.config import ExperimentConfig


@dataclasses.dataclass
class TrainState:
    """Model (parameters + BatchNorm running statistics), optimizer state,
    the per-loss-call counter (cosine beta) and the PRNG key."""

    model: vae.VAE
    opt: AdamState
    counter: torch.Tensor  # int32, 0-dim
    rng: torch.Tensor      # threefry key data (2,) int64

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self.model.flat_params()

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return self.model.flat_stats()


@dataclasses.dataclass
class EarlyStopping:
    """Early stopping utility (reference parity: trainer.py:65-81)."""

    patience: int = 10
    min_delta: float = 1e-4
    best_loss: float = float("inf")
    epochs_no_improve: int = 0

    def should_stop(self, val_loss: float) -> bool:
        if val_loss < self.best_loss - self.min_delta:
            self.best_loss = val_loss
            self.epochs_no_improve = 0
            return False
        self.epochs_no_improve += 1
        return self.epochs_no_improve >= self.patience


def step_lr(base_lr: float, step_size: int, gamma: float, epoch: int) -> float:
    """torch StepLR: lr at a given epoch (scheduler stepped per epoch)."""
    return base_lr * (gamma ** (epoch // step_size))


class VAETrainer:
    """Drives training of a VAE on a (train, val) split on one device, or
    on every rank of the data axis.

    ``train()`` returns ``(train_total_losses, val_total_losses,
    epochs_run)``; per-component histories live in ``train_losses`` /
    ``val_losses`` and the host wall time of each epoch in
    ``epoch_seconds``.
    """

    def __init__(self, model_cfg: vae.VAEConfig, spec: L.LossSpec,
                 config: ExperimentConfig, device: str | torch.device = "cuda"):
        check_model_parallel(getattr(config, "model_parallel", 1))
        world = data_axis_size(getattr(config, "data_parallel", 1))
        self.axis = DataAxis.from_group() if world > 1 else None
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.spec = spec
        self.config = config
        names = spec.component_names()
        self.train_losses: Dict[str, List[float]] = {n: [] for n in names}
        self.val_losses: Dict[str, List[float]] = {n: [] for n in names}
        self.epoch_seconds: List[float] = []
        self.early_stopping = EarlyStopping(config.patience, config.min_delta)
        self.final_state: TrainState | None = None
        self._mask = model_cfg.feature_mask(self.device)

    # -- state ------------------------------------------------------------

    def _moment_dtype(self) -> torch.dtype:
        """Adam moment storage: config.adam_state_dtype, where 'auto'
        follows the compute policy (bf16 on CUDA, float32 on the CPU)."""
        name = getattr(self.config, "adam_state_dtype", "auto")
        return (self.model_cfg.policy.compute_dtype if name == "auto"
                else getattr(torch, name))

    def init_state(self, seed: int | None = None) -> TrainState:
        """The JAX key order: ``init_key, rng = split(key(seed))``, params
        from ``init_key`` (bit-equal to JAX ``vae.init``), zero moments,
        counter 0."""
        seed = self.config.seed if seed is None else seed
        init_key, rng = prng.split(prng.key(seed, self.device))
        model = vae.init_from_key(self.model_cfg, init_key)
        opt = AdamState.zeros(model.flat_params(), self._moment_dtype())
        return TrainState(model, opt,
                          torch.zeros((), dtype=torch.int32, device=self.device),
                          rng)

    # -- core step functions ----------------------------------------------

    def loss_and_grads(self, state: TrainState, batch: torch.Tensor,
                       epoch: int, key: torch.Tensor,
                       share: RowShare | None = None):
        """Train-mode forward with eps from ``key``, the loss bundle and its
        gradients: (components, {path: grad}, new batch stats). With
        ``share`` they are this rank's terms of the global batch's."""
        params = state.model.flat_params()
        h, mu, logvar, new_stats = state.model.forward_hidden(batch, key, True,
                                                              share)
        total, comps = L.compute_losses(
            self.spec, params, h, batch, mu, logvar, epoch, state.counter,
            self._mask, self.model_cfg.policy, share)
        grads = torch.autograd.grad(total, list(params.values()))
        return comps, dict(zip(params, grads)), new_stats

    def _sum_over_ranks(self, grads: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        """Every leaf's gradient summed over the ranks, in one all-reduce."""
        flat = torch.cat([g.reshape(-1) for g in grads.values()])
        self.axis.all_reduce_(flat)
        out, off = {}, 0
        for k, g in grads.items():
            out[k] = flat[off: off + g.numel()].view_as(g)
            off += g.numel()
        return out

    def _train_step(self, state: TrainState, batch: torch.Tensor, epoch: int,
                    lr: torch.Tensor, share: RowShare | None = None
                    ) -> Dict[str, torch.Tensor]:
        rng, key = prng.split(state.rng)
        comps, grads, new_stats = self.loss_and_grads(state, batch, epoch, key,
                                                      share)
        if share is not None:
            grads = self._sum_over_ranks(grads)
        clip_adam_step(state.model.flat_params(), grads, state.opt, lr,
                       self.config.max_norm)
        with torch.no_grad():
            for k, t in state.model.flat_stats().items():
                t.copy_(new_stats[k])
        state.counter = state.counter + 1
        state.rng = rng
        return {k: v.detach() for k, v in comps.items()}

    @torch.no_grad()
    def _val_step(self, state: TrainState, batch: torch.Tensor,
                  epoch: int, share: RowShare | None = None
                  ) -> Dict[str, torch.Tensor]:
        # model.eval(): running BN stats, but the reparameterization still
        # samples noise (reference validate_epoch calls model(data))
        rng, key = prng.split(state.rng)
        params = state.model.flat_params()
        h, mu, logvar, _ = state.model.forward_hidden(batch, key, False, share)
        _, comps = L.compute_losses(
            self.spec, params, h, batch, mu, logvar, epoch, state.counter,
            self._mask, self.model_cfg.policy, share)
        state.counter = state.counter + 1
        state.rng = rng
        return comps

    def _platform(self) -> str:
        """Device type the epoch runs on (the JAX trainer's _mesh_platform)."""
        return self.device.type

    def _use_block_shuffle(self, n: int) -> bool:
        """The JAX trainer's gate (trainer.py:254-267) with CUDA in place of
        the TPU: 8-row blocks mix well enough for batches >= 256; smaller
        batches keep the exact row permutation."""
        return (getattr(self.config, "use_pallas_gather", True)
                and self.config.batch_size >= 256
                and n % K.GATHER_BLOCK == 0
                and self._platform() == "cuda"
                and self.axis is None)

    def _shard_rows(self, data: torch.Tensor, n: int, order: torch.Tensor):
        """W > 1: this rank's rows of an epoch taken in ``order`` (global
        row ids), batch by batch, and (lo, hi, share) of each batch in
        them. Batch i is ``order[i*B : min((i+1)*B, n)]``; rank r takes its
        contiguous share of it. Held rows come from their holders in one
        exchange (``shard_data``), else from the full local copy."""
        B, axis = self.config.batch_size, self.axis
        spans = [(lo, min(lo + B, n)) for lo in range(0, n, B)]
        need = [torch.cat([order[lo + q * (hi - lo) // axis.world:
                                 lo + (q + 1) * (hi - lo) // axis.world]
                           for lo, hi in spans]) for q in range(axis.world)]
        if getattr(self.config, "shard_data", True):
            rows = axis.exchange_rows(data, n, need)
        else:
            rows = data.index_select(0, need[axis.rank])
        batches, off = [], 0
        for lo, hi in spans:
            a, e = local_row_range(hi - lo, axis.rank, axis.world)
            batches.append((off, off + e - a, RowShare(axis, a, hi - lo)))
            off += e - a
        return rows, batches

    def run_epoch(self, state: TrainState, data: torch.Tensor, n: int,
                  epoch: int, lr: torch.Tensor, train: bool
                  ) -> Dict[str, torch.Tensor]:
        """One epoch over the n rows of a set (``data``: the device tensor
        of its first n rows, or on W > 1 ranks this rank's rows of it):
        full batches, then the remainder at its true shape. Returns the
        per-component sums divided by n, as device tensors (on W > 1
        ranks, the global sums)."""
        B = self.config.batch_size
        names = self.spec.component_names()
        sums = {k: torch.zeros((), dtype=torch.float32, device=self.device)
                for k in names}
        batches = None
        if train:
            with record_function("gm2/shuffle"):
                rng, perm_key = prng.split(state.rng)
                state.rng = rng
                if self._use_block_shuffle(n):
                    bperm = prng.permutation(perm_key, n // K.GATHER_BLOCK)
                    data = K.gather_row_blocks(data, bperm)
                elif self.axis is None:
                    data = data.index_select(0, prng.permutation(perm_key, n))
                else:
                    data, batches = self._shard_rows(
                        data, n, prng.permutation(perm_key, n))
        elif self.axis is not None:
            data, batches = self._shard_rows(
                data, n, torch.arange(n, dtype=torch.int64, device=self.device))
        if batches is None:
            batches = [(lo, min(lo + B, n), None) for lo in range(0, n, B)]
        for lo, hi, share in batches:
            if train:
                with record_function("gm2/train_step"):
                    comps = self._train_step(state, data[lo:hi], epoch, lr, share)
            else:
                comps = self._val_step(state, data[lo:hi], epoch, share)
            for k in names:
                sums[k] = sums[k] + comps[k]
        if self.axis is not None:
            total = self.axis.all_reduce_(torch.stack([sums[k] for k in names]))
            sums = dict(zip(names, total.unbind()))
        return {k: v / n for k, v in sums.items()}

    # -- public API --------------------------------------------------------

    def prepare_data(self, x) -> torch.Tensor:
        """Pad the gene axis and place on the device. {0,1} data is stored
        as bf16 under the bf16 policy (exact, half the bytes; the matmul
        rounds to bf16 anyway), as the JAX trainer does (trainer.py:352-377).
        On W > 1 ranks with ``shard_data`` (the default) a rank keeps only
        its contiguous share of the rows (:func:`local_row_range`)."""
        x = np.asarray(x, np.float32)
        if self.axis is not None and getattr(self.config, "shard_data", True):
            lo, hi = local_row_range(x.shape[0], self.axis.rank, self.axis.world)
            x = x[lo:hi]
        t = torch.from_numpy(x)
        if (self.model_cfg.policy.compute_dtype == torch.bfloat16
                and bool(((x == 0) | (x == 1)).all())):
            t = t.to(torch.bfloat16)
        return self.model_cfg.pad_inputs(t.to(self.device)).contiguous()

    def train(self, train_x, val_x, state: TrainState | None = None,
              progress_cb=None, start_epoch: int = 0,
              checkpoint_path: str | None = None, checkpoint_every: int = 0,
              ) -> Tuple[List[float], List[float], int]:
        """Main training loop (reference parity: trainer.py:158-189), with
        resume (pass a state from :meth:`resume_from` and its epoch) and a
        full train-state checkpoint every ``checkpoint_every`` epochs
        (``checkpoint_path`` may contain ``{epoch}``). On W > 1 ranks every
        rank passes the whole host arrays and keeps its rows of them; rank 0
        alone writes the checkpoints."""
        cfg = self.config
        if state is None:
            state = self.init_state()
        if self.axis is not None and (isinstance(train_x, torch.Tensor)
                                      or isinstance(val_x, torch.Tensor)):
            raise ValueError("data-parallel training takes the whole host "
                             "arrays; each rank keeps its rows of them")
        n_train, n_val = int(train_x.shape[0]), int(val_x.shape[0])
        if not isinstance(train_x, torch.Tensor):
            train_x = self.prepare_data(train_x)
        if not isinstance(val_x, torch.Tensor):
            val_x = self.prepare_data(val_x)

        epoch = start_epoch
        t0 = time.perf_counter()
        for epoch in range(start_epoch, cfg.n_epochs):
            t_epoch = time.perf_counter()
            lr_value = step_lr(cfg.learning_rate, cfg.scheduler_step_size,
                               cfg.scheduler_gamma, epoch)
            # a fill on the device, not a host copy: no sync
            lr = torch.full((), lr_value, dtype=torch.float32, device=self.device)
            tr = self.run_epoch(state, train_x, n_train, epoch, lr, train=True)
            with record_function("gm2/validation"):
                vl = self.run_epoch(state, val_x, n_val, epoch, lr, train=False)
            # single host sync per epoch
            names = list(tr)
            values = torch.stack([tr[k] for k in names] +
                                 [vl[k] for k in names]).tolist()
            tr = dict(zip(names, values[: len(names)]))
            vl = dict(zip(names, values[len(names):]))
            self.epoch_seconds.append(time.perf_counter() - t_epoch)
            for k in names:
                self.train_losses[k].append(tr[k])
                self.val_losses[k].append(vl[k])

            if (epoch + 1) % cfg.print_every == 0:
                dt = time.perf_counter() - t0
                next_lr = step_lr(cfg.learning_rate, cfg.scheduler_step_size,
                                  cfg.scheduler_gamma, epoch + 1)
                print(f"Epoch {epoch + 1}:")
                print(f"  Learning Rate: {next_lr}")
                print(f"  Train Loss: {tr['total']}")
                print(f"  Validation Loss: {vl['total']}")
                print(f"  Throughput: {(epoch + 1 - start_epoch) * n_train / dt:,.0f} examples/s")
            if progress_cb is not None:
                progress_cb(epoch, tr, vl)

            if checkpoint_every and checkpoint_path and \
                    (epoch + 1) % checkpoint_every == 0:
                from ..utils import checkpoint as ckpt

                with record_function("gm2/checkpoint"):
                    ckpt.save_train_state(
                        checkpoint_path.format(epoch=epoch + 1), state, cfg,
                        epoch + 1, extra={
                            "early_best": self.early_stopping.best_loss,
                            "early_no_improve":
                                self.early_stopping.epochs_no_improve,
                            "train_losses": self.train_losses,
                            "val_losses": self.val_losses,
                        })

            if self.early_stopping.should_stop(vl["total"]):
                print(f"Early stopping triggered after {epoch + 1} epochs")
                break

        self.final_state = state
        return (self.train_losses["total"], self.val_losses["total"], epoch + 1)

    def resume_from(self, checkpoint_path: str) -> Tuple[TrainState, int]:
        """Load a train-state checkpoint (either package's); returns (state,
        start_epoch) and restores early stopping and the loss histories."""
        from ..utils import checkpoint as ckpt

        state, start_epoch, extra = ckpt.load_train_state(checkpoint_path, self)
        self.early_stopping.best_loss = extra.get("early_best", float("inf"))
        self.early_stopping.epochs_no_improve = extra.get("early_no_improve", 0)
        for k, hist in extra.get("train_losses", {}).items():
            self.train_losses[k] = list(hist)
        for k, hist in extra.get("val_losses", {}).items():
            self.val_losses[k] = list(hist)
        return state, start_epoch


def state_from_flat(trainer: VAETrainer, flat: Dict[str, Any]) -> TrainState:
    """A TrainState for ``trainer`` from the JAX package's flat train-state
    arrays (``params/...``, ``batch_stats/...``, ``opt_state/1/.count``,
    ``opt_state/1/.mu/...``, ``opt_state/1/.nu/...``, ``counter``,
    ``rng_key_data``): the weights, the optimizer state and the keys, poured
    unchanged (moments are cast to the trainer's moment dtype)."""
    state = trainer.init_state()
    sub = lambda prefix: {k[len(prefix):]: v for k, v in flat.items()
                          if k.startswith(prefix)}
    vae.pour(sub("params/"), state.model.flat_params())
    vae.pour(sub("batch_stats/"), state.model.flat_stats())
    vae.pour(sub("opt_state/1/.mu/"), state.opt.mu, "Optimizer state")
    vae.pour(sub("opt_state/1/.nu/"), state.opt.nu, "Optimizer state")
    dev = trainer.device
    state.opt.count = torch.tensor(int(np.asarray(flat["opt_state/1/.count"])),
                                   dtype=torch.int32, device=dev)
    state.counter = torch.tensor(int(np.asarray(flat["counter"])),
                                 dtype=torch.int32, device=dev)
    state.rng = torch.as_tensor(np.asarray(flat["rng_key_data"]).astype(np.int64),
                                device=dev)
    return state


def state_to_flat(state: TrainState) -> Dict[str, np.ndarray]:
    """The inverse of :func:`state_from_flat`, in the JAX file's layout
    (moments widened to float32, which is exact for bf16)."""
    host = lambda t: t.detach().float().cpu().numpy()
    flat = {"params/" + k: host(v) for k, v in state.model.flat_params().items()}
    flat.update({"batch_stats/" + k: host(v)
                 for k, v in state.model.flat_stats().items()})
    flat["opt_state/1/.count"] = np.asarray(int(state.opt.count), np.int32)
    flat.update({"opt_state/1/.mu/" + k: host(v) for k, v in state.opt.mu.items()})
    flat.update({"opt_state/1/.nu/" + k: host(v) for k, v in state.opt.nu.items()})
    flat["counter"] = np.asarray(int(state.counter), np.int32)
    flat["rng_key_data"] = state.rng.cpu().numpy().astype(np.uint32)
    return flat


# ---------------------------------------------------------------------------
# Preset factories (reference parity: trainer.py:193-290)
# ---------------------------------------------------------------------------

def _model_cfg(config: ExperimentConfig, input_dim: int,
               device: torch.device) -> vae.VAEConfig:
    return vae.VAEConfig(
        input_dim=input_dim, hidden_dim=config.hidden_dim,
        latent_dim=config.latent_dim, pad_features=config.pad_features,
        policy=resolve_policy(config.compute_dtype, device.type))


def create_trainer(version: str, config: ExperimentConfig, input_dim: int,
                   device: str | torch.device = "cuda") -> VAETrainer:
    """Build the preset trainer (create_v{0..3}_trainer, trainer.py:193-257)."""
    device = resolve_device(device)
    return VAETrainer(_model_cfg(config, input_dim, device),
                      L.spec_for_preset(version, config), config, device)


def _preset_train(version: str, train_x, val_x, *, input_dim: int | None = None,
                  device: str | torch.device = "cuda", **overrides):
    from ..utils.config import get_preset_config

    config = get_preset_config(version)
    for k, v in overrides.items():
        setattr(config, k, v)
    dim = input_dim if input_dim is not None else np.shape(train_x)[1]
    return create_trainer(version, config, dim, device).train(train_x, val_x)


def v0(train_x, val_x, **overrides):
    """Train with the v0 loss bundle (trainer.py:261-266); keyword
    overrides go to the preset config. Returns (train_losses, val_losses,
    epochs_run)."""
    return _preset_train("v0", train_x, val_x, **overrides)


def v1(train_x, val_x, **overrides):
    """v1 bundle: + gene abundance + L1 (trainer.py:269-274)."""
    return _preset_train("v1", train_x, val_x, **overrides)


def v2(train_x, val_x, **overrides):
    """v2 bundle: cosine KL annealing (trainer.py:277-282)."""
    return _preset_train("v2", train_x, val_x, **overrides)


def v3(train_x, val_x, **overrides):
    """v3 bundle: weighted abundance, T=50 cosine (trainer.py:285-290)."""
    return _preset_train("v3", train_x, val_x, **overrides)


class VAETrainerBuilder:
    """Fluent builder over LossSpec/config (reference: trainer.py:294-372)."""

    def __init__(self, config: ExperimentConfig, input_dim: int,
                 device: str | torch.device = "cuda"):
        self._config = config
        self._input_dim = input_dim
        self._device = device
        self._spec_kwargs: Dict[str, Any] = {"n_epochs": config.n_epochs}

    def epochs(self, n_epochs: int):
        self._config.n_epochs = n_epochs
        self._spec_kwargs["n_epochs"] = n_epochs
        return self

    def gradient_clipping(self, max_norm: float):
        self._config.max_norm = max_norm
        return self

    def early_stopping(self, patience: int = 10, min_delta: float = 1e-4):
        self._config.patience = patience
        self._config.min_delta = min_delta
        return self

    def print_every(self, epochs: int):
        self._config.print_every = epochs
        return self

    def with_reconstruction_loss(self):
        return self  # reconstruction is always active

    def with_kl_loss(self, scheduler_type: str = "linear", min_beta: float = 0.0,
                     max_beta: float = 1.0, T: int = 10):
        self._spec_kwargs.update(
            scheduler_type=scheduler_type, min_beta=min_beta, max_beta=max_beta, T=T)
        return self

    def with_gene_abundance_loss(self, gamma_start: float = 0.0,
                                 gamma_end: float = 1.0, weight: float = 1.0):
        self._spec_kwargs.update(
            use_abundance=True, gamma_start=gamma_start, gamma_end=gamma_end,
            weight=weight)
        return self

    def with_l1_regularization(self, lambda_l1: float):
        self._spec_kwargs.update(use_l1=True, lambda_l1=lambda_l1)
        self._config.lambda_l1 = lambda_l1
        return self

    def with_l2_regularization(self, lambda_l2: float):
        self._spec_kwargs.update(use_l2=True, lambda_l2=lambda_l2)
        return self

    def build(self) -> VAETrainer:
        device = resolve_device(self._device)
        return VAETrainer(_model_cfg(self._config, self._input_dim, device),
                          L.LossSpec(**self._spec_kwargs), self._config, device)

"""VAE trainer: the port of the JAX package's ``train/trainer.py`` (:63-622).

Semantics kept from the JAX trainer (and through it from the reference):

- per-epoch losses are summed over batches, then divided by the dataset
  size, a float32 quotient rounded once (``ops/losses.py::_div``: on CUDA
  a division by a Python number is a product with its reciprocal); the
  remainder batch is trained on at its true shape (exact BatchNorm
  statistics);
- one shuffle per train epoch from ``split(state.rng)``: on a CUDA device
  with batch >= 256 and n % 8 == 0 it permutes 8-row blocks through the
  ``gather_row_blocks`` kernel (``permutation(n // 8)``), as the JAX trainer
  does on a TPU; otherwise it is the exact row permutation
  ``permutation(n)`` and a row gather;
- each step: ``rng, key = split(rng)``, train-mode forward with eps drawn
  from ``key``, the loss bundle, autograd (the output layer's backward is
  the ``output_layer_bwd`` kernel), then the fused clip + Adam + apply
  (``clip_adam_apply_leaves``, one launch over every leaf);
- validation steps run BatchNorm in eval mode but still draw eps, and bump
  the cosine-beta counter;
- StepLR per epoch, early stopping on the validation total, and a single
  host sync per epoch (the loss sums).

An epoch has one body, :class:`EpochProgram`, the port's counterpart of
the JAX trainer's whole-epoch program (trainer.py:271-320, one ``jit`` per
``(n, train)`` with the epoch and the learning rate as traced arguments):
the shuffle, then every step with its loss sums. It runs eagerly or is
captured. :meth:`VAETrainer.run_epoch` runs an unbound program eagerly:
on the CPU and on W > 1 grids (gloo's collectives cannot be captured, and
NCCL's across cards are untested). On a CUDA device with no grid each
``(n, train)`` has a program bound to storage that outlives it (the
state, updated in place; the set's device tensor; an epoch buffer the
shuffle writes; the trainer's int32 epoch and float32 learning-rate
scalars; its loss sums). Its first epoch runs eagerly on the stream it is
then captured on, which builds the kernels, sets their attributes and
makes cuBLAS's workspace and the optimizer's table before the capture;
every later epoch replays it: a training epoch as two graphs (the
shuffle, then every step of the epoch with its loss sums), a validation
epoch as one. The replays launch exactly the kernels the eager epoch
launches, so the two give the same bits. A capture or replay that fails
raises; there is no eager fallback.

On W > 1 ranks (a grid of ``config.data_parallel`` x
``config.model_parallel`` ranks, the model axis fastest,
``parallel/mesh.py::make_grid``) the trainer computes over the global
batch, as the JAX trainer does under GSPMD (trainer.py:116-168, 262-299,
325-343): each rank holds its contiguous share of the rows
(``shard_data``) and, under a model axis, only its gene slice of the
columns, of the first encoder weight's rows, of the output layer's
columns and bias, and of their Adam moments; every epoch, train and
validation, takes the exact row order (the permutation ``permutation(n)``
of the whole set, or the identity) and each rank receives its contiguous
share of every batch from the ranks of its data axis that hold those rows,
once per epoch; BatchNorm, the noise draw and the losses see the global
batch (``RowShare``), the first encoder layer's partial products are
summed over the model axis; each rank's loss is one term of the global
loss (``ops/losses.py::compute_losses``), so the gene-sliced leaves'
gradients are summed over the data axis and every other leaf's over the
whole grid before the global norm (its gene-sliced squares summed over
the model axis) and the update, so every rank applies the same update to
what it holds; the epoch's loss sums are summed over the grid. At W = 1
it is the one-process code.

The state is updated in place (the JAX TrainState is immutable). Its
checkpoint layout is the JAX package's, full leaves whatever the grid
(gathered on save, sliced on load), so a train-state file written by
either package resumes in the other (``utils/checkpoint.py``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..core.dtypes import resolve_device, resolve_policy
from ..models import vae
from ..ops import kernels as K
from ..ops import losses as L
from ..ops import prng
from ..ops.optimizer import AdamState, clip_adam_step
from ..parallel.mesh import (RowShare, gather_genes, gene_slice,
                             local_row_range, make_grid, slice_genes)
from ..utils.config import ExperimentConfig
from ..utils.profiling import span


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

    def leaves(self) -> Dict[str, torch.Tensor]:
        """Every tensor of the state, by its name in a train-state file
        (:func:`state_to_flat`; this rank's gene slices under a model
        axis)."""
        out = {"params/" + k: v for k, v in self.params.items()}
        out.update({"batch_stats/" + k: v for k, v in self.batch_stats.items()})
        for name, moments in ((".mu/", self.opt.mu), (".nu/", self.opt.nu)):
            out.update({"opt_state/1/" + name + k: v for k, v in moments.items()})
        out["opt_state/1/.count"] = self.opt.count
        out["counter"] = self.counter
        out["rng_key_data"] = self.rng
        return out

    def clone(self) -> "TrainState":
        """A copy of a one-process state (no gene slices) in storage of
        its own: steps on it leave this state as it is."""
        src = self.model
        with torch.device(self.counter.device):
            model = type(src)(src.cfg)
        with torch.no_grad():
            for dst, orig in ((model.flat_params(), src.flat_params()),
                              (model.flat_stats(), src.flat_stats())):
                for k, t in dst.items():
                    t.copy_(orig[k])
        copy = lambda d: {k: v.clone() for k, v in d.items()}  # noqa: E731
        opt = AdamState(self.opt.count.clone(), copy(self.opt.mu),
                        copy(self.opt.nu))
        return TrainState(model, opt, self.counter.clone(), self.rng.clone())


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


def _storage(state: TrainState, data: torch.Tensor) -> Dict[str, tuple]:
    """Where a state's tensors and a set's data live: what a captured graph
    reads and writes."""
    where = {k: (t.data_ptr(), tuple(t.shape), t.dtype)
             for k, t in state.leaves().items()}
    where["data"] = (data.data_ptr(), tuple(data.shape), data.dtype)
    return where


class EpochProgram:
    """One epoch over the n rows of one set, the trainer's one epoch body:
    the JAX trainer's ``_get_epoch_fn`` program (trainer.py:271-320). A
    training epoch shuffles the set (``gm2/shuffle``), then runs every step,
    the full batches and the remainder at its true shape, summing the loss
    components (``gm2/train_step``); a validation epoch runs its steps over
    the set in its order. On W > 1 ranks a rank steps over its share of
    every batch. A program ``bound`` to its state and data tensor (no grid)
    shuffles into an epoch buffer of its own, so that it can be captured
    into CUDA graphs (:meth:`capture`) and replayed (:meth:`replay`); an
    unbound one (:meth:`VAETrainer.run_epoch`) lets the shuffle allocate.
    It holds no reference to the trainer, so dropping it frees its graphs."""

    def __init__(self, trainer: "VAETrainer", state: TrainState,
                 data: torch.Tensor, n: int, train: bool, bound: bool = True):
        if bound and data.shape[0] != n:
            raise ValueError(f"an epoch program takes the set's {n} rows, "
                             f"got {data.shape[0]}")
        self.state, self.data, self.n, self.train = state, data, n, train
        self.storage = _storage(state, data) if bound else None
        self.block = train and trainer._use_block_shuffle(n)
        self.names = trainer.spec.component_names()
        self.sums = {k: torch.zeros((), dtype=torch.float32, device=trainer.device)
                     for k in self.names}
        self.buf = torch.empty_like(data) if bound and train else None
        # the rows the steps read and the (lo, hi, share) of each batch in
        # them; a training epoch's shuffle replaces them
        B = trainer.config.batch_size
        self.rows = data
        self.batches = [(lo, min(lo + B, n), None) for lo in range(0, n, B)]
        if trainer.grid is not None and not train:
            self.rows, self.batches = trainer._shard_rows(
                data, n, torch.arange(n, dtype=torch.int64, device=trainer.device))
        self.graphs = None  # [(range, CUDAGraph, {kernel: launches})]

    def bound_to(self, state: TrainState, data: torch.Tensor) -> bool:
        """Whether ``state`` and ``data`` are the storage this program
        reads and writes."""
        return _storage(state, data) == self.storage

    def check_bound(self, state: TrainState, data: torch.Tensor) -> None:
        if not self.bound_to(state, data):
            raise RuntimeError(
                "this epoch program was built for another train state or "
                "data tensor; a loaded state needs a new program "
                "(VAETrainer.drop_epoch_programs)")

    def shuffle(self, trainer: "VAETrainer") -> None:
        """``rng, key = split(rng)`` and the set permuted: 8-row blocks by
        the gather kernel, or the exact row permutation by ``index_select``,
        into the epoch buffer where there is one; on a grid, this rank's
        share of every batch of the permutation (``_shard_rows``)."""
        rng, key = prng.split(self.state.rng)
        self.state.rng.copy_(rng)
        if self.block:
            bperm = prng.permutation(key, self.n // K.GATHER_BLOCK)
            self.rows = K.gather_row_blocks(self.data, bperm, out=self.buf)
        elif trainer.grid is None:
            self.rows = torch.index_select(
                self.data, 0, prng.permutation(key, self.n), out=self.buf)
        else:
            self.rows, self.batches = trainer._shard_rows(
                self.data, self.n, prng.permutation(key, self.n))

    def steps(self, trainer: "VAETrainer", epoch: int | torch.Tensor,
              lr: torch.Tensor) -> None:
        """Every step of the epoch; the component sums (on a grid, summed
        over it) divided by n into ``self.sums``."""
        sums = {k: torch.zeros((), dtype=torch.float32, device=trainer.device)
                for k in self.names}
        for lo, hi, share in self.batches:
            batch = self.rows[lo:hi]
            if self.train:
                comps = trainer._train_step(self.state, batch, epoch, lr, share)
            else:
                comps = trainer._val_step(self.state, batch, epoch, share)
            for k in self.names:
                sums[k] = sums[k] + comps[k]
        if trainer.grid is not None:
            total = trainer.grid.everyone.all_reduce_(
                torch.stack([sums[k] for k in self.names]))
            sums = dict(zip(self.names, total.unbind()))
        for k in self.names:
            self.sums[k].copy_(L._div(sums[k], self.n))

    def _parts(self, trainer: "VAETrainer", epoch, lr):
        steps = lambda: self.steps(trainer, epoch, lr)  # noqa: E731
        if self.train:
            return (("gm2/shuffle", lambda: self.shuffle(trainer)),
                    ("gm2/train_step", steps))
        return ((None, steps),)

    def run(self, trainer: "VAETrainer", epoch: int | torch.Tensor,
            lr: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The epoch eagerly; returns the static loss sums."""
        for name, part in self._parts(trainer, epoch, lr):
            with span(name):
                part()
        return self.sums

    def capture(self, trainer: "VAETrainer", pool, stream) -> None:
        """Capture each part, at the trainer's epoch and learning-rate
        scalars, into a CUDA graph on ``stream`` in the memory pool
        ``pool``. Capture runs none of the work; the launches the
        wrappers count while it records are taken back and kept, to be
        counted at each replay."""
        graphs = []
        for name, part in self._parts(trainer, trainer._epoch, trainer._lr):
            graph = torch.cuda.CUDAGraph()
            before = K.launch_counts()
            try:
                with torch.cuda.graph(graph, pool=pool, stream=stream):
                    part()
            finally:
                recorded = K.launch_counts()
                K.set_launch_counts(before)
            graphs.append((name, graph, {k: recorded[k] - before[k]
                                         for k in recorded}))
        self.graphs = graphs

    def replay(self) -> Dict[str, torch.Tensor]:
        """One epoch as replays of the captured graphs on the current
        stream; returns the static loss sums."""
        for name, graph, launches in self.graphs:
            with span(name):
                graph.replay()
            K.add_launch_counts(launches)
        return self.sums

    def release(self) -> None:
        for _, graph, _ in self.graphs or ():
            graph.reset()
        self.graphs = None


class VAETrainer:
    """Drives training of a VAE on a (train, val) split on one device, or
    on every rank of a data x model grid.

    ``train()`` returns ``(train_total_losses, val_total_losses,
    epochs_run)``; per-component histories live in ``train_losses`` /
    ``val_losses`` and the host wall time of each epoch in
    ``epoch_seconds``.
    """

    def __init__(self, model_cfg: vae.VAEConfig, spec: L.LossSpec,
                 config: ExperimentConfig, device: str | torch.device = "cuda"):
        self.grid = make_grid(getattr(config, "data_parallel", 1),
                              getattr(config, "model_parallel", 1),
                              model_cfg.padded_dim)
        self.genes = (gene_slice(model_cfg.padded_dim, self.grid.model.rank,
                                 self.grid.model.world)
                      if self.grid is not None else (0, model_cfg.padded_dim))
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
        lo, hi = self.genes
        self._mask = model_cfg.feature_mask(self.device)[lo:hi]
        # the epoch programs by (n, train), their graphs' one memory pool
        # and capture stream, and the epoch and learning-rate scalars
        # every epoch reads
        self._epoch_fns: Dict[Tuple[int, bool], EpochProgram] = {}
        self._pool = None
        self._capture_stream = None
        self._epoch = torch.zeros((), dtype=torch.int32, device=self.device)
        self._lr = torch.zeros((), dtype=torch.float32, device=self.device)

    # -- state ------------------------------------------------------------

    def _moment_dtype(self) -> torch.dtype:
        """Adam moment storage: config.adam_state_dtype, where 'auto'
        follows the compute policy (bf16 on CUDA, float32 on the CPU)."""
        name = getattr(self.config, "adam_state_dtype", "auto")
        return (self.model_cfg.policy.compute_dtype if name == "auto"
                else getattr(torch, name))

    def init_state(self, seed: int | None = None) -> TrainState:
        """The JAX key order: ``init_key, rng = split(key(seed))``, params
        from ``init_key`` (bit-equal to JAX ``vae.init``; under a model
        axis this rank's gene slice of them), zero moments, counter 0."""
        seed = self.config.seed if seed is None else seed
        init_key, rng = prng.split(prng.key(seed, self.device))
        model = vae.init_from_key(self.model_cfg, init_key)
        if self.grid is not None and self.grid.model.world > 1:
            model.shard_genes(self.grid.model)
        opt = AdamState.zeros(model.flat_params(), self._moment_dtype())
        return TrainState(model, opt,
                          torch.zeros((), dtype=torch.int32, device=self.device),
                          rng)

    # -- core step functions ----------------------------------------------

    def _forward_losses(self, state: TrainState, batch: torch.Tensor,
                        epoch: int | torch.Tensor, key: torch.Tensor,
                        train: bool, share: RowShare | None):
        """The forward with eps from ``key``, BatchNorm in train or eval
        mode, and the loss bundle: (params, total, components, new batch
        stats). A training step's phases are ``gm2/step/*`` ranges."""
        params = state.model.flat_params()
        with span("gm2/step/forward" if train else None):
            h, mu, logvar, new_stats = state.model.forward_hidden(batch, key, train,
                                                                  share)
        with span("gm2/step/loss" if train else None):
            total, comps = L.compute_losses(
                self.spec, params, h, batch, mu, logvar, epoch, state.counter,
                self._mask, self.model_cfg.policy, share)
        return params, total, comps, new_stats

    def loss_and_grads(self, state: TrainState, batch: torch.Tensor,
                       epoch: int, key: torch.Tensor,
                       share: RowShare | None = None):
        """Train-mode forward with eps from ``key``, the loss bundle and its
        gradients: (components, {path: grad}, new batch stats). With
        ``share`` they are this rank's terms of the global batch's."""
        params, total, comps, new_stats = self._forward_losses(
            state, batch, epoch, key, True, share)
        with span("gm2/step/backward"):
            grads = torch.autograd.grad(total, list(params.values()))
        return comps, dict(zip(params, grads)), new_stats

    def _sum_over_ranks(self, grads: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        """Each rank's gradient terms summed: the gene-sliced leaves' over
        the data axis, every other leaf's over the whole grid, one
        all-reduce each."""
        grid, out = self.grid, {}
        sliced = [k for k in grads if grid.holds_slice(k)]
        whole = [k for k in grads if not grid.holds_slice(k)]
        for keys, axis in ((sliced, grid.data), (whole, grid.everyone)):
            if not keys:
                continue
            flat = axis.all_reduce_(torch.cat([grads[k].reshape(-1)
                                               for k in keys]))
            off = 0
            for k in keys:
                out[k] = flat[off: off + grads[k].numel()].view_as(grads[k])
                off += grads[k].numel()
        return {k: out[k] for k in grads}

    @torch.no_grad()
    def _advance(self, state: TrainState, rng: torch.Tensor, new_stats=None):
        """A step's end: a training step's BatchNorm statistics, the counter
        bumped, the split's first key kept."""
        if new_stats is not None:
            for k, t in state.model.flat_stats().items():
                t.copy_(new_stats[k])
        state.counter.add_(1)
        state.rng.copy_(rng)

    def _train_step(self, state: TrainState, batch: torch.Tensor,
                    epoch: int | torch.Tensor, lr: torch.Tensor,
                    share: RowShare | None = None) -> Dict[str, torch.Tensor]:
        """One step, every update in the state's storage (a captured graph
        replays it there). Its phases are ``gm2/step/*`` ranges
        (``utils/profiling.py``)."""
        with span("gm2/step/forward"):
            rng, key = prng.split(state.rng)
        comps, grads, new_stats = self.loss_and_grads(state, batch, epoch, key,
                                                      share)
        if share is not None:
            grads = self._sum_over_ranks(grads)
        clip_adam_step(state.model.flat_params(), grads, state.opt, lr,
                       self.config.max_norm, gene_axis=state.model.gene_axis)
        with span("gm2/step/stats"):
            self._advance(state, rng, new_stats)
        return {k: v.detach() for k, v in comps.items()}

    def train_step(self, state: TrainState,
                   batch: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One eager train step of a one-process trainer on ``batch``
        (padded rows on the trainer's device) at the epoch and
        learning-rate scalars :meth:`train` fills each epoch; returns the
        loss components."""
        return self._train_step(state, batch, self._epoch, self._lr)

    @torch.no_grad()
    def _val_step(self, state: TrainState, batch: torch.Tensor,
                  epoch: int | torch.Tensor, share: RowShare | None = None
                  ) -> Dict[str, torch.Tensor]:
        # model.eval(): running BN stats, but the reparameterization still
        # samples noise (reference validate_epoch calls model(data))
        rng, key = prng.split(state.rng)
        _, _, comps, _ = self._forward_losses(state, batch, epoch, key, False,
                                              share)
        self._advance(state, rng)
        return comps

    def _platform(self) -> str:
        """Device type the epoch runs on (the JAX trainer's _mesh_platform)."""
        return self.device.type

    def _use_block_shuffle(self, n: int) -> bool:
        """The JAX trainer's gate (trainer.py:254-267) with CUDA in place of
        the TPU: 8-row blocks mix well enough for batches >= 256; smaller
        batches, and any grid of more than one rank, keep the exact row
        permutation."""
        return (getattr(self.config, "use_pallas_gather", True)
                and self.config.batch_size >= 256
                and n % K.GATHER_BLOCK == 0
                and self._platform() == "cuda"
                and self.grid is None)

    def _shard_rows(self, data: torch.Tensor, n: int, order: torch.Tensor):
        """W > 1: this rank's rows of an epoch taken in ``order`` (global
        row ids), batch by batch, and (lo, hi, share) of each batch in
        them. Batch i is ``order[i*B : min((i+1)*B, n)]``; data rank r
        takes its contiguous share of it. Held rows come from their holders
        on the data axis in one exchange (``shard_data``), else from the
        full local copy."""
        B, axis = self.config.batch_size, self.grid.data
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
            batches.append((off, off + e - a,
                            RowShare(axis, a, hi - lo, self.grid.model)))
            off += e - a
        return rows, batches

    def run_epoch(self, state: TrainState, data: torch.Tensor, n: int,
                  epoch: int, lr: torch.Tensor, train: bool
                  ) -> Dict[str, torch.Tensor]:
        """One epoch over the n rows of a set (``data``: the device tensor
        of its first n rows, or on W > 1 ranks this rank's rows and gene
        slice of it), eagerly, as an :class:`EpochProgram` bound to no
        storage. Returns the per-component sums divided by n, as device
        tensors (on W > 1 ranks, the global sums)."""
        return EpochProgram(self, state, data, n, train, bound=False).run(
            self, epoch, lr)

    # -- the epoch as CUDA graphs -------------------------------------------

    def _graphed(self) -> bool:
        """Epochs run as captured graphs on a CUDA device with no grid."""
        return self.device.type == "cuda" and self.grid is None

    def _get_epoch_graph(self, n: int, train: bool, state: TrainState,
                         data: torch.Tensor) -> EpochProgram:
        """The cached program of ``(n, train)`` (JAX trainer.py:127,
        271-275), built for ``state`` and ``data`` at first use; raises if
        it was built for another state or data tensor."""
        prog = self._epoch_fns.get((n, train))
        if prog is None:
            prog = EpochProgram(self, state, data, n, train)
            self._epoch_fns[(n, train)] = prog
        prog.check_bound(state, data)
        return prog

    def graphed_epoch(self, state: TrainState, data: torch.Tensor, n: int,
                      train: bool) -> Dict[str, torch.Tensor]:
        """One epoch through the program of ``(n, train)``, the trainer's
        epoch and learning-rate scalars already filled: its first epoch
        eagerly on the capture stream, then the capture; every later epoch
        a replay. Returns the program's loss sums (divided by n)."""
        prog = self._get_epoch_graph(n, train, state, data)
        if prog.graphs is not None:
            return prog.replay()
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        stream, main = self._capture_stream, torch.cuda.current_stream(self.device)
        # the eager epoch makes, on the capture stream, what a capture
        # cannot: the kernels' builds and attributes, cuBLAS's workspace
        # for that stream, the optimizer's table
        stream.wait_stream(main)
        with torch.cuda.stream(stream), span("gm2/warm_epoch"):
            sums = prog.run(self, self._epoch, self._lr)
        main.wait_stream(stream)
        try:
            with span("gm2/capture"):
                prog.capture(self, self._pool, stream)
        except BaseException:
            del self._epoch_fns[(n, train)]
            raise
        return sums

    def drop_epoch_programs(self) -> None:
        """Forget every epoch program and free their graphs (a loaded state
        or new data tensors need new ones)."""
        for prog in self._epoch_fns.values():
            prog.release()
        self._epoch_fns.clear()
        self._capture_stream = self._pool = None

    # -- public API --------------------------------------------------------

    def prepare_data(self, x) -> torch.Tensor:
        """Pad the gene axis and place on the device. {0,1} data is stored
        as bf16 under the bf16 policy (exact, half the bytes; the matmul
        rounds to bf16 anyway), as the JAX trainer does (trainer.py:352-377).
        On W > 1 ranks with ``shard_data`` (the default) a rank keeps only
        its contiguous share of the rows (:func:`local_row_range` on the
        data axis), and under a model axis only its gene slice of the
        padded columns, cut on the host."""
        x = np.asarray(x, np.float32)
        if self.grid is not None and getattr(self.config, "shard_data", True):
            lo, hi = self.grid.data.share(x.shape[0])
            x = x[lo:hi]
        lo, hi = self.genes
        whole = hi - lo == self.model_cfg.padded_dim
        if not whole:
            cols = x[:, lo:hi]
            x = np.pad(cols, ((0, 0), (0, hi - lo - cols.shape[1])))
        t = torch.from_numpy(x)
        if (self.model_cfg.policy.compute_dtype == torch.bfloat16
                and bool(((x == 0) | (x == 1)).all())):
            t = t.to(torch.bfloat16)
        t = t.to(self.device)
        return (self.model_cfg.pad_inputs(t) if whole else t).contiguous()

    def train(self, train_x, val_x, state: TrainState | None = None,
              progress_cb=None, start_epoch: int = 0,
              checkpoint_path: str | None = None, checkpoint_every: int = 0,
              ) -> Tuple[List[float], List[float], int]:
        """Main training loop (reference parity: trainer.py:158-189), with
        resume (pass a state from :meth:`resume_from` and its epoch) and a
        full train-state checkpoint every ``checkpoint_every`` epochs
        (``checkpoint_path`` may contain ``{epoch}``). On W > 1 ranks every
        rank passes the whole host arrays and keeps its rows (and gene
        slice) of them; rank 0 alone writes the checkpoints."""
        cfg = self.config
        if state is None:
            state = self.init_state()
        if self.grid is not None and (isinstance(train_x, torch.Tensor)
                                      or isinstance(val_x, torch.Tensor)):
            raise ValueError("multi-process training takes the whole host "
                             "arrays; each rank keeps its part of them")
        n_train, n_val = int(train_x.shape[0]), int(val_x.shape[0])
        if not isinstance(train_x, torch.Tensor):
            train_x = self.prepare_data(train_x)
        if not isinstance(val_x, torch.Tensor):
            val_x = self.prepare_data(val_x)

        graphed = self._graphed()
        if graphed and any(
                not p.bound_to(state, train_x if train else val_x)
                for (_, train), p in self._epoch_fns.items()):
            self.drop_epoch_programs()  # built for another state or data
        epoch = start_epoch
        t0 = time.perf_counter()
        for epoch in range(start_epoch, cfg.n_epochs):
            t_epoch = time.perf_counter()
            # fills on the device, not host copies: no sync
            with span("gm2/epoch_begin"):
                self._epoch.fill_(epoch)
                self._lr.fill_(step_lr(cfg.learning_rate, cfg.scheduler_step_size,
                                       cfg.scheduler_gamma, epoch))
            if graphed:
                tr = self.graphed_epoch(state, train_x, n_train, train=True)
                with span("gm2/validation"):
                    vl = self.graphed_epoch(state, val_x, n_val, train=False)
            else:
                tr = self.run_epoch(state, train_x, n_train, epoch, self._lr,
                                    train=True)
                with span("gm2/validation"):
                    vl = self.run_epoch(state, val_x, n_val, epoch, self._lr,
                                        train=False)
            # single host sync per epoch
            names = list(tr)
            with span("gm2/epoch_sync"):
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

                with span("gm2/checkpoint"):
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
    unchanged (moments are cast to the trainer's moment dtype); under a
    model axis the full leaves are cut to the rank's gene slice."""
    state = trainer.init_state()
    sub = lambda prefix: slice_genes({k[len(prefix):]: v for k, v in flat.items()
                                      if k.startswith(prefix)},
                                     state.model.genes)
    vae.pour(sub("params/"), state.model.flat_params())
    vae.pour(sub("batch_stats/"), state.model.flat_stats())
    vae.pour(sub("opt_state/1/.mu/"), state.opt.mu, "Optimizer state")
    vae.pour(sub("opt_state/1/.nu/"), state.opt.nu, "Optimizer state")
    state.opt.count.fill_(int(np.asarray(flat["opt_state/1/.count"])))
    state.counter.fill_(int(np.asarray(flat["counter"])))
    state.rng.copy_(torch.from_numpy(
        np.asarray(flat["rng_key_data"]).astype(np.int64)))
    return state


def state_to_flat(state: TrainState) -> Dict[str, np.ndarray]:
    """The inverse of :func:`state_from_flat`, in the JAX file's layout
    (moments widened to float32, which is exact for bf16); under a model
    axis the gene slices of the parameters and moments are gathered over
    it (a collective: every rank calls it)."""
    host = lambda t: t.detach().float().cpu().numpy()
    axis = state.model.gene_axis
    flat = {"params/" + k: host(v) for k, v in state.model.full_params().items()}
    flat.update({"batch_stats/" + k: host(v)
                 for k, v in state.model.flat_stats().items()})
    flat["opt_state/1/.count"] = np.asarray(int(state.opt.count), np.int32)
    for name, moments in ((".mu/", state.opt.mu), (".nu/", state.opt.nu)):
        flat.update({"opt_state/1/" + name + k: host(v)
                     for k, v in gather_genes(moments, axis).items()})
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

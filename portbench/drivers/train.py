"""Training cells: the program's ``VAETrainer.train`` over the window.

Set-up makes the genomes and the weights from the seed on the card, builds
the trainer and its state, and warms them with one epoch through
``VAETrainer.train`` itself: on a card that epoch runs eagerly, then the
trainer captures its CUDA graphs. Then the seed's data, weights, moments,
counters and key are written back into the same tensors, in place, so the
window starts from the seed's initial state with the graphs built. The
window hands that trainer and state to ``VAETrainer.train`` from epoch 0
and ends with the first epoch that finishes past ``--seconds`` (the second
at the least), by a stop the benchmark raises from the trainer's progress
callback, which the trainer calls after its one host sync of the epoch.

What is checked comes from the window's own epochs (on a card, replays of
the captured graphs). Taps on the trainer's step and the model's forward
(:class:`Taps`) copy, on the device, each epoch's first steps' losses,
the first step's ``mu`` and ``logvar``, the first moment after step 1 (the
first gradient as the optimizer got it), each leaf's change over the
first three steps, and the gene counts of the epoch's first batch into
tensors of their own; the graphs capture those copies with the step, so
every replay writes them. The callback reads them after the window's first
epoch (and the counts after its second). Once the window has closed and the
program's state is freed, the reference follows the same first steps from
the same inputs in float32 and works out which rows the second epoch
starts with, and the gaps (``reference/train.py::gaps``) are held to the
cell's limits; an epoch of the window whose losses are not finite fails
the run as well.
"""

from __future__ import annotations

import contextlib
import gc
import math
import sys
import time

import numpy as np
import torch

from portbench import harness, inputs, trace
from portbench.reference import train as RT
from portbench.reference import vae as RV

# the numbers a cell may compare (its limits name those it does); the later
# steps' losses (``loss_gap``) swing with the signs Adam's first steps give
# near-zero gradients and are printed only
CHECKED = ("first_latent_gap", "first_loss_gap", "first_grad_gap", "change_gap",
           "epoch1_rows_mismatch", "nonfinite_epochs")
ADAM_B1 = 0.9
SEED_STREAMS = {"data": 0, "weights": 1}


class WindowClosed(Exception):
    """Raised from the progress callback to end the window."""


def _sub_seed(seed: int, what: str) -> int:
    return int(inputs.prng_key(seed, 10 + SEED_STREAMS[what]).view("uint64")[0])


def program_config(cell):
    """The program's ExperimentConfig of the cell: the preset, every key of
    the configuration's file that the config has, then the traffic's."""
    from genome_minimizer_2_torch.utils.config import get_preset_config

    config = get_preset_config(cell.config["preset"])
    for k, v in cell.config["experiment"].items():
        if not hasattr(config, k):
            raise KeyError(f"the program's config has no key {k!r}")
        setattr(config, k, v)
    for k in ("batch_size", "compute_dtype", "adam_state_dtype"):
        setattr(config, k, cell.traffic[k])
    return config


def make_matrix(cell, seed: int, device, dtype) -> torch.Tensor:
    """Every genome's presence/absence row, from the seed."""
    cfg = cell.config
    gen = inputs.generator(_sub_seed(seed, "data"), device)
    return inputs.presence_matrix(gen, cfg["genomes"], cfg["input_dim"], dtype)


def make_weights(cell, seed: int, device) -> tuple[dict, dict]:
    cfg = cell.config
    gen = inputs.generator(_sub_seed(seed, "weights"), device)
    return inputs.vae_weights(gen, cfg["input_dim"], cfg["experiment"]["hidden_dim"],
                              cfg["experiment"]["latent_dim"], trained=False)


class Taps:
    """Device copies of the first ``steps`` steps of every epoch, written
    by wrappers of the trainer's step and the model's forward into tensors
    made before the warm epoch, so that a captured epoch writes them at
    each replay. A step's place in its epoch is its call's count modulo
    the epoch's steps (the wrapper runs once a step eagerly and once a step
    while a graph is captured, never in a replay)."""

    def __init__(self, trainer, state, train_rows: int, steps: int = RT.STEPS):
        batch, latent = trainer.config.batch_size, trainer.model_cfg.latent_dim
        self.per_epoch, self.steps, self.calls, self.first = (
            -(-train_rows // batch), steps, 0, False)
        self.trainer, self.model = trainer, state.model
        params, dev = state.params, state.counter.device
        zero = lambda: torch.zeros((), dtype=torch.float32, device=dev)  # noqa: E731
        self.start = {k: torch.empty_like(p) for k, p in params.items()}
        self.grad = {k: zero() for k in params}
        self.change = {k: zero() for k in params}
        self.losses = [{k: zero() for k in trainer.spec.component_names()}
                       for _ in range(steps)]
        self.latent = {k: torch.zeros((batch, latent), dtype=torch.float32, device=dev)
                       for k in ("mu", "logvar")}
        self.counts = torch.zeros(batch, dtype=torch.float32, device=dev)
        inner, forward = trainer._train_step, state.model.forward_hidden

        def forward_hidden(x, key, train, share=None):
            out = forward(x, key, train, share)
            if self.first:  # rows the step left out read as 0, so count as missing
                for k, t in (("mu", out[1]), ("logvar", out[2])):
                    n = t.shape[0]
                    self.latent[k][:n].copy_(t.detach())
                    self.latent[k][n:].zero_()
            return out

        @torch.no_grad()
        def _copy_norms(dst, tensors, scale=1.0):
            for k, t in tensors.items():
                dst[k].copy_(torch.linalg.vector_norm(t, dtype=torch.float32) * scale)

        def step(st, batch, epoch, lr, share=None):
            i = self.calls % self.per_epoch
            self.calls += 1
            if i == 0:
                for k, p in st.params.items():
                    self.start[k].copy_(p.detach())
                self.counts.copy_(batch.float().sum(dim=1))
            self.first = i == 0
            try:
                comps = inner(st, batch, epoch, lr, share)
            finally:
                self.first = False
            if i < self.steps:
                for k, v in comps.items():
                    self.losses[i][k].copy_(v)
            if i == 0:
                _copy_norms(self.grad, st.opt.mu, 1.0 / (1.0 - ADAM_B1))
            if i == self.steps - 1:
                _copy_norms(self.change, {k: p.detach() - self.start[k]
                                          for k, p in st.params.items()})
            return comps

        trainer._train_step = step
        state.model.forward_hidden = forward_hidden

    def read(self) -> dict:
        """What the last epoch's first steps wrote."""
        return {"latent": {k: v.to("cpu", copy=True) for k, v in self.latent.items()},
                "losses": [{k: float(v) for k, v in s.items()} for s in self.losses],
                "grad": {k: float(v) for k, v in self.grad.items()},
                "change": {k: float(v) for k, v in self.change.items()}}

    def close(self) -> None:
        del self.trainer._train_step
        del self.model.forward_hidden


def setup(cell, seed: int, device, parts: dict) -> dict:
    """Everything up to the window: the library, the trainer, its state and
    data tensors, the warm epoch (eager, then the capture) and the seed's
    start written back (:func:`load_seed`)."""
    from genome_minimizer_2_torch.models import vae
    from genome_minimizer_2_torch.ops import kernels as K
    from genome_minimizer_2_torch.ops.optimizer import AdamState
    from genome_minimizer_2_torch.train import trainer as TR

    t = time.perf_counter()
    if device.type == "cuda":
        K.load_library()
    parts["load"] = time.perf_counter() - t

    t = time.perf_counter()
    config = program_config(cell)
    dtype = getattr(torch, cell.traffic["compute_dtype"])
    trainer = TR.create_trainer(cell.config["preset"], config,
                                cell.config["input_dim"], device)
    e = cell.config["experiment"]
    tr_idx, va_idx = RT.split_indices(cell.config["genomes"], e["test_size"],
                                      e["val_ratio"], e["random_state"])
    width = trainer.model_cfg.padded_dim
    with torch.device(device):
        model = vae.VAE(trainer.model_cfg)
        s = {"trainer": trainer, "kernels": K, "dtype": dtype,
             "rows": (torch.from_numpy(tr_idx).to(device),
                      torch.from_numpy(va_idx).to(device)),
             "train_x": torch.empty((len(tr_idx), width), dtype=dtype),
             "val_x": torch.empty((len(va_idx), width), dtype=dtype),
             "state": TR.TrainState(
                 model, AdamState.zeros(model.flat_params(), trainer._moment_dtype()),
                 torch.zeros((), dtype=torch.int32),
                 torch.zeros(2, dtype=torch.int64))}
    s["taps"] = Taps(trainer, s["state"], len(tr_idx))
    load_seed(s, cell, seed)
    parts["data_and_weights"] = time.perf_counter() - t

    t = time.perf_counter()
    epochs = config.n_epochs
    config.n_epochs = 1
    with contextlib.redirect_stdout(sys.stderr):
        trainer.train(s["train_x"], s["val_x"], state=s["state"])
    config.n_epochs = epochs
    load_seed(s, cell, seed)
    if device.type == "cuda":
        torch.cuda.synchronize()
    parts["warm"] = time.perf_counter() - t
    return s


@torch.no_grad()
def load_seed(s: dict, cell, seed: int) -> None:
    """The seed's rows, weights, zero moments and counters and its key,
    written into the program's tensors in place (the storage its epoch
    programs read)."""
    state, trainer = s["state"], s["trainer"]
    device = state.counter.device
    matrix = make_matrix(cell, seed, device, s["dtype"])
    pad = trainer.model_cfg.pad_inputs
    for x, rows in zip((s["train_x"], s["val_x"]), s["rows"]):
        x.copy_(pad(matrix[rows]))
    del matrix
    params, stats = make_weights(cell, seed, device)
    for src, dst in ((params, state.params), (stats, state.batch_stats)):
        for k, p in dst.items():
            p.zero_()
            p[tuple(slice(0, n) for n in src[k].shape)] = src[k]
    for moments in (state.opt.mu, state.opt.nu):
        for t in moments.values():
            t.zero_()
    state.opt.count.zero_()
    state.counter.zero_()
    state.rng.copy_(torch.from_numpy(inputs.prng_key(seed, 0).astype(np.int64)))
    trainer.early_stopping.best_loss = float("inf")
    trainer.early_stopping.epochs_no_improve = 0


def window(s: dict, seconds: float, traced: bool, trace_epochs: int) -> dict:
    """Epochs from epoch 0 until one past the first ends past ``seconds``;
    with ``traced``, then ``trace_epochs`` more under the profiler. The
    taps' readings of epoch 0 go to ``readings``, the gene counts of epoch
    1's first batch to ``epoch1_counts``."""
    trainer, taps, K = s["trainer"], s["taps"], s["kernels"]
    ends, bad, sl = [], [0], None
    left = [0]
    launches, readings = {}, {}

    def progress(epoch, tr, vl):
        now = time.perf_counter()
        if sl is not None and sl.seconds is None and left[0]:
            left[0] -= 1
            if left[0] == 0:
                sl.stop()
                after = K.launch_counts()
                launches.update({k: after[k] - launches[k] for k in after})
                raise WindowClosed
            return
        if epoch == 0:
            readings.update(taps.read())
        elif epoch == 1:
            readings["epoch1_counts"] = taps.counts.to("cpu", copy=True)
        ends.append(now)
        if not all(math.isfinite(v) for v in (*tr.values(), *vl.values())):
            bad[0] += 1
        if now - t0 >= seconds and epoch >= 1:
            if not traced:
                raise WindowClosed
            launches.update(K.launch_counts())
            sl.start()
            left[0] = trace_epochs

    if traced:
        sl = trace.Slice()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        try:
            trainer.train(s["train_x"], s["val_x"], state=s["state"],
                          progress_cb=progress, start_epoch=0)
        except WindowClosed:
            pass
    starts = [t0] + ends[:-1]
    rec = {"window_s": ends[-1] - t0, "epochs": len(ends), "failed": bad[0],
           "epoch_s": [b - a for a, b in zip(starts, ends)], "readings": readings}
    if traced:
        rec["trace"] = dict(trace.summarize(sl.events()), seconds=sl.seconds,
                            epochs=trace_epochs, launches=launches)
    return rec


def release(s: dict) -> None:
    s["taps"].close()
    s["trainer"].drop_epoch_programs()
    s.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference_readings(cell, seed: int, device, precision: str = "float32",
                       half_batch: bool = False) -> dict:
    """The reference's first steps of the run of ``seed``, and the gene
    counts of the rows epoch 1 starts with."""
    RV.set_ieee_float32()
    cfg, e = cell.config, cell.config["experiment"]
    tr_idx, va_idx = RT.split_indices(cfg["genomes"], e["test_size"],
                                      e["val_ratio"], e["random_state"])
    matrix = make_matrix(cell, seed, device, torch.float32)
    rows = matrix[torch.from_numpy(tr_idx).to(device)]
    del matrix
    batch = cell.traffic["batch_size"]
    blocks = (device.type == "cuda" and batch >= RT.BLOCK_MIN_BATCH
              and rows.shape[0] % RT.SHUFFLE_BLOCK == 0)
    key = inputs.prng_key(seed, 0)
    first = RT.first_batch_rows(len(tr_idx), len(va_idx), key, batch, blocks, 1)
    counts = rows[torch.from_numpy(first).to(device)].sum(dim=1).cpu()
    steps = RT.step_inputs(rows, key, batch, e["latent_dim"], blocks)
    del rows
    params, _ = make_weights(cell, seed, device)
    out = RT.follow(params, steps, cfg["loss"], e["learning_rate"], e["max_norm"],
                    precision, half_batch)
    del steps, params
    out["epoch1_counts"] = counts
    return out


def shapes(cell) -> dict:
    """What the metrics need to count: widths, rows, each step's batch."""
    from genome_minimizer_2_torch.core.dtypes import round_up

    cfg, e = cell.config, cell.config["experiment"]
    n = cfg["genomes"]
    n_test = math.ceil(e["test_size"] * n)
    n_train = math.floor((1 - e["test_size"]) * n)
    n_val = math.floor((1 - e["val_ratio"]) * n_test)
    b = cell.traffic["batch_size"]
    return {"genes": cfg["input_dim"], "genes_padded": round_up(cfg["input_dim"], 128),
            "hidden": e["hidden_dim"], "latent": e["latent_dim"],
            "train_rows": n_train, "val_rows": n_val,
            "train_batches": [min(b, n_train - lo) for lo in range(0, n_train, b)],
            "compute_dtype": cell.traffic["compute_dtype"],
            "moment_dtype": cell.traffic["adam_state_dtype"]}


def run(cell, args, device, clock: dict) -> tuple[dict, dict]:
    """(record for the metrics, checks) of one run."""
    parts = {"import": clock["import"]}
    s = setup(cell, args.seed, device, parts)
    setup_s = clock["age"] + time.perf_counter() - clock["t0"]
    harness.log("setup parts (s): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
                + f"; process start to the window {setup_s:.3f}")
    rec = window(s, args.seconds, bool(args.trace), cell.traffic["trace_epochs"])
    rec.update(setup_s=setup_s, driver="train", **shapes(cell))
    ms = sorted(1e3 * t for t in rec["epoch_s"])
    harness.log(f"window: {rec['epochs']} epochs in {rec['window_s']:.4f} s, "
                f"{rec['failed']} with non-finite losses; epoch times (ms) "
                f"{ms[0]:.2f} to {ms[-1]:.2f}, median {ms[len(ms) // 2]:.2f}, "
                f"p90 {1e3 * harness.p90(rec['epoch_s']):.2f} over {len(ms)}")
    readings = rec.pop("readings")
    if device.type == "cuda":
        rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    release(s)
    t = time.perf_counter()
    g = RT.gaps(readings, reference_readings(cell, args.seed, device))
    g["nonfinite_epochs"] = rec["failed"]
    harness.log(f"reference: {time.perf_counter() - t:.3f} s; worst leaves "
                f"{g['worst_grad_leaf']} (first gradient), {g['worst_change_leaf']} "
                f"(change); left out of the change: {g['quiet_leaves']}; gap of "
                f"every step's losses {g['loss_gap']!r} (not compared)")
    checks = {k: {"value": g[k], "limit": cell.limits[k]} for k in CHECKED
              if k in cell.limits}
    return rec, checks

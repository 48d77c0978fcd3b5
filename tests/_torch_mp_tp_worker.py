"""One rank of the port's gene-axis tensor parallelism on a gloo group
(CPU), for tests/test_torch_port_tp.py and tests/test_torch_port_elastic.py:
the port's counterpart of the ``tp`` case of tests/_mp_worker.py. Trains
the tiny VAE (D = 70, hidden 16, latent 4, batch 8, 44 training and 13
validation rows, 2 epochs) through ``VAETrainer.train`` on a grid of
``data x model`` ranks, once per run of the spec, and prints one JSON
line: each run's loss histories by component, its first step (the global
loss, the global norm and every leaf's gradient), the grid place and the
shapes this rank held (and its gene slices' values), its test-set F1,
accuracy, reconstructed bits and loss breakdown (9 test rows), and the
checkpoints it wrote.

A run may start from a state whose ``encoder/0/b`` is ``bias`` (not 0),
so that where that bias is added matters; it may name a ``trap``, a wrong
implementation patched in here (never in the package), so that the test
can show its checks fail on it:

- ``bias``: the first encoder layer's bias added on every model rank,
  before the model-axis sum;
- ``kl``: the KL term counted on every model rank;
- ``l1``: the L1 term of the replicated leaves counted on every model rank;
- ``norm``: the replicated leaves' squares summed over the model axis in
  the global norm (counted ``model`` times).

A run may name its ``device`` (``cpu`` by default; ``cuda``: the ranks
share the card, gloo copying through the host) and ``compute_dtype``.
A ``restart`` run trains 3 epochs with a checkpoint every epoch through
``utils/elastic.py::train_with_restarts`` (``max_restarts`` 1), once
uninterrupted and once crashing on every rank after the epoch-1
checkpoint, and reports whether histories, parameters and moments are
bit-equal.

Usage: _torch_mp_tp_worker.py <rank> <world> <port> <spec json>
"""

import json
import os
import sys

rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
spec = json.loads(sys.argv[4])
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from genome_minimizer_2_torch.core import prng  # noqa: E402
from genome_minimizer_2_torch.eval import metrics as ME  # noqa: E402
from genome_minimizer_2_torch.models import vae  # noqa: E402
from genome_minimizer_2_torch.ops import losses as L  # noqa: E402
from genome_minimizer_2_torch.ops import optimizer as O  # noqa: E402
from genome_minimizer_2_torch.parallel.mesh import (all_reduce_sum,  # noqa: E402
                                                    gather_genes)
from genome_minimizer_2_torch.train import trainer as T  # noqa: E402
from genome_minimizer_2_torch.utils import checkpoint as ckpt  # noqa: E402
from genome_minimizer_2_torch.utils import elastic  # noqa: E402
from genome_minimizer_2_torch.utils.config import ExperimentConfig  # noqa: E402

D = 70


def data():
    rng = np.random.RandomState(0)
    return (rng.rand(44, D).round().astype(np.float32),
            rng.rand(13, D).round().astype(np.float32))


def test_rows():
    return np.random.RandomState(1).rand(9, D).round().astype(np.float32)


def patch_trap(trap):
    """Install the wrong implementation; returns its undo."""
    if trap is None:
        return lambda: None
    if trap == "bias":
        orig = vae.Linear.forward

        def early_bias(self, x, policy):
            if self.gene_axis is None:
                return orig(self, x, policy)
            return all_reduce_sum(vae.matmul(x, self.w, policy) + self.b,
                                  self.gene_axis)

        vae.Linear.forward = early_bias
        return lambda: setattr(vae.Linear, "forward", orig)
    if trap == "norm":
        orig = O.global_norm

        def every_square_summed(grads, gene_axis=None):
            squares = torch.stack([g.float().square().sum()
                                   for g in grads.values()])
            return gene_axis.all_reduce_(squares).sum().double().sqrt().float()

        O.global_norm = every_square_summed
        return lambda: setattr(O, "global_norm", orig)
    orig = L.compute_losses

    def wrong(*args):
        spec_, params, share = args[0], args[1], args[10]
        if share is None:
            return orig(*args)
        if trap == "kl":  # every model rank as model rank 0 (v0: no L1)
            return orig(*args[:10], dataclasses.replace(share, model=None))
        # l1: the L1 term of every leaf this rank holds, on every model rank
        total, comps = orig(dataclasses.replace(spec_, lambda_l1=0.0), *args[1:])
        if share.axis.rank == 0:
            l1 = spec_.lambda_l1 * L.l1_penalty(params.values())
            comps[L.L1_REGULARIZATION] = l1
            total = total + l1
            comps[L.TOTAL] = total
        return total, comps

    L.compute_losses = wrong
    return lambda: setattr(L, "compute_losses", orig)


def config(run):
    return ExperimentConfig(hidden_dim=16, latent_dim=4,
                            n_epochs=run.get("epochs", 2), batch_size=8,
                            trainer_version=run["version"], print_every=1000,
                            data_parallel=run["data"],
                            model_parallel=run["model"],
                            compute_dtype=run.get("compute_dtype", "auto"))


def trainer_for(run):
    return T.create_trainer(run["version"], config(run), D,
                            device=run.get("device", "cpu"))


def start(trainer, run):
    state = trainer.init_state()
    if run.get("bias"):
        with torch.no_grad():
            state.model.encoder[0].b.fill_(run["bias"])
    return state


def first_step(trainer, run):
    """The first 8 training rows as one global batch, from the initial
    state: the global loss, the global norm of the summed gradients and
    every leaf's gradient, gathered whole."""
    train_x, _ = data()
    state = start(trainer, run)
    rows, batches = trainer._shard_rows(
        trainer.prepare_data(train_x), len(train_x),
        torch.arange(len(train_x), dtype=torch.int64))
    lo, hi, share = batches[0]
    comps, grads, _ = trainer.loss_and_grads(state, rows[lo:hi], 1,
                                             prng.key(7, trainer.device), share)
    grads = trainer._sum_over_ranks(grads)
    norm = O.global_norm(grads, state.model.gene_axis)
    loss = trainer.grid.everyone.all_reduce_(comps[L.TOTAL].detach().clone())
    return {"loss": float(loss), "norm": float(norm),
            "grads": {k: v.cpu().tolist() for k, v in
                      gather_genes(grads, state.model.gene_axis).items()}}


def train_run(run, wrote):
    train_x, val_x = data()
    undo = patch_trap(run.get("trap"))
    try:
        trainer = trainer_for(run)
        step = first_step(trainer, run)
        wrote.clear()
        ck = run.get("ckpt")
        trainer.train(train_x, val_x, state=start(trainer, run),
                      checkpoint_every=1 if ck else 0,
                      checkpoint_path=(os.path.join(ck, "tp_{epoch}.npz")
                                       if ck else None))
        st = trainer.final_state
        key = prng.key(1, trainer.device)
        f1, acc, _, _ = ME.calculate_reconstruction_metrics(st.model, test_rows(),
                                                            key, batch_size=8)
        bits = ME.reconstruct_binary(st.model, test_rows(), key, batch_size=8)
        breakdown = ME.calculate_reconstruction_loss_breakdown(
            st.model, test_rows(), key, batch_size=8)
        if ck:
            ckpt.save_checkpoint(os.path.join(ck, "model.npz"),
                                 st.model.full_params(), st.batch_stats,
                                 trainer.config, extra={"input_dim": D})
    finally:
        undo()
    g = trainer.grid
    return {"train": trainer.train_losses, "val": trainer.val_losses,
            "grid": [g.data.rank, g.data.world, g.model.rank, g.model.world],
            "genes": list(st.model.genes),
            "held": {k: list(v.shape) for k, v in st.params.items()},
            "slices": {k: v.detach().cpu().tolist() for k, v in st.params.items()
                       if trainer.grid.holds_slice(k)},
            "moments": {k: list(v.shape) for k, v in st.opt.mu.items()},
            "rows": list(trainer.prepare_data(train_x).shape),
            "counter": int(st.counter), "f1": f1, "accuracy": acc,
            "bits": bits.tolist(), "breakdown": breakdown, "step": step,
            "wrote": list(wrote)}


def restart_run(run, directory):
    """Uninterrupted and crashed runs through train_with_restarts."""
    train_x, val_x = data()
    final = {}
    for name in ("straight", "crashed"):
        trainer = trainer_for(run)
        crashed = []
        if name == "crashed":
            def boom(epoch, tr, vl):
                if epoch == 1 and not crashed:
                    crashed.append(epoch)
                    raise RuntimeError("injected failure on every rank")

            def train(*args, **kwargs):
                kwargs["progress_cb"] = boom
                return T.VAETrainer.train(trainer, *args, **kwargs)

            trainer.train = train
        pattern = os.path.join(directory, name + "_{epoch}.npz")
        tl, vl, epochs, restarts = elastic.train_with_restarts(
            trainer, train_x, val_x, checkpoint_path=pattern,
            checkpoint_every=1, max_restarts=1)
        st = trainer.final_state
        final[name] = {"hist": (trainer.train_losses, trainer.val_losses),
                       "restarts": restarts, "crashed": crashed,
                       "leaves": {**{"p/" + k: v for k, v in st.params.items()},
                                  **{"mu/" + k: v for k, v in st.opt.mu.items()},
                                  **{"nu/" + k: v for k, v in st.opt.nu.items()}}}
    a, b = final["straight"], final["crashed"]
    return {"restarts": [a["restarts"], b["restarts"]], "crashed": b["crashed"],
            "same_history": a["hist"] == b["hist"],
            "different_leaves": [k for k in a["leaves"]
                                 if not torch.equal(a["leaves"][k], b["leaves"][k])],
            "held": {k: list(v.shape) for k, v in b["leaves"].items()},
            "train": a["hist"][0]["total"]}


def main():
    torch.backends.cuda.matmul.allow_tf32 = False  # IEEE float32 on a card
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        results = {"rank": rank}
        wrote = []
        orig_write = ckpt._write_npz

        def recording_write(path, arrays):
            if orig_write(path, arrays):
                wrote.append(os.path.basename(str(path)))

        ckpt._write_npz = recording_write
        for run in spec["runs"]:
            if run.get("restart"):
                results[run["label"]] = restart_run(run, run["restart"])
            else:
                results[run["label"]] = train_run(run, wrote)
        print(json.dumps(results), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()

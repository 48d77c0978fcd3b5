"""One rank of the port's data-parallel training on a gloo group (CPU),
for tests/test_torch_port_dp.py: the port's counterpart of
tests/_mp_worker.py. Trains the tiny VAE (D = 70, hidden 16, latent 4,
batch 8, 44 training and 13 validation rows, 2 epochs) through
``VAETrainer.train`` once per run of the spec and prints one JSON line:
each run's loss histories by component, the rows this rank held and the
checkpoints this rank wrote. A run may take the first ``n_train`` training
rows only.

A run may name a ``trap``, a wrong implementation patched in here (never in
the package) so that the test can show its checks fail on it:

- ``bn``: BatchNorm with each rank's own batch statistics;
- ``l1``: the L1 term counted on every rank (W times in the gradient);
- ``abundance``: the gene-abundance term of the global batch counted on
  every rank;
- ``abundance_per_rank``: each rank's own rows' abundance, |sum| per rank,
  counted on every rank, as a per-rank DDP port would compute it.

Usage: _torch_mp_dp_worker.py <rank> <world> <port> <spec json>
"""

import dataclasses
import json
import os
import sys

rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
spec = json.loads(sys.argv[4])
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

from genome_minimizer_2_torch.models import vae  # noqa: E402
from genome_minimizer_2_torch.ops import losses as L  # noqa: E402
from genome_minimizer_2_torch.parallel.mesh import DataAxis, RowShare  # noqa: E402
from genome_minimizer_2_torch.train import trainer as T  # noqa: E402
from genome_minimizer_2_torch.utils import checkpoint as ckpt  # noqa: E402
from genome_minimizer_2_torch.utils.config import ExperimentConfig  # noqa: E402

D = 70


def data():
    rng = np.random.RandomState(0)
    return (rng.rand(44, D).round().astype(np.float32),
            rng.rand(13, D).round().astype(np.float32))


def patch_trap(trap):
    """Install the wrong implementation; returns its undo."""
    if trap is None:
        return lambda: None
    if trap == "bn":
        orig = vae.Block.forward
        vae.Block.forward = lambda self, x, policy, train=False, share=None: \
            orig(self, x, policy, train, None)
        return lambda: setattr(vae.Block, "forward", orig)
    orig = L.compute_losses

    def wrong(*args):
        spec_, params, share = args[0], args[1], args[10]
        if share is None:
            return orig(*args)
        if trap == "l1":
            total, comps = orig(*args)
            if share.axis.rank != 0:
                l1 = spec_.lambda_l1 * L.l1_penalty(params.values())
                comps[L.L1_REGULARIZATION] = l1
                total = total + l1
                comps[L.TOTAL] = total
            return total, comps
        # every rank counts the abundance: as rank 0 (the global one) or
        # alone (its own rows); the L1 term stays on rank 0
        if trap == "abundance":
            counted = RowShare(DataAxis(0, share.axis.world), share.offset,
                               share.total)
        else:
            counted = None
        total, comps = orig(dataclasses.replace(spec_, lambda_l1=0.0),
                            *args[1:10], counted)
        if share.axis.rank == 0 and spec_.use_l1:
            l1 = spec_.lambda_l1 * L.l1_penalty(params.values())
            comps[L.L1_REGULARIZATION] = l1
            total = total + l1
            comps[L.TOTAL] = total
        return total, comps

    L.compute_losses = wrong
    return lambda: setattr(L, "compute_losses", orig)


def main():
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        train_x, val_x = data()
        results = {"rank": rank}
        wrote = []
        orig_write = ckpt._write_npz

        def recording_write(path, arrays):
            if orig_write(path, arrays):
                wrote.append(os.path.basename(str(path)))

        ckpt._write_npz = recording_write
        for run in spec["runs"]:
            cfg = ExperimentConfig(hidden_dim=16, latent_dim=4, n_epochs=2,
                                   batch_size=8, trainer_version=run["version"],
                                   print_every=1000, data_parallel=0,
                                   shard_data=run.get("shard", True))
            undo = patch_trap(run.get("trap"))
            try:
                trainer = T.create_trainer(run["version"], cfg, D, device="cpu")
                wrote.clear()
                ck = run.get("ckpt")
                rows = train_x[: run.get("n_train", len(train_x))]
                trainer.train(rows, val_x, checkpoint_every=1 if ck else 0,
                              checkpoint_path=(os.path.join(ck, "dp_{epoch}.npz")
                                               if ck else None))
            finally:
                undo()
            results[run["label"]] = {
                "train": trainer.train_losses, "val": trainer.val_losses,
                "local_rows": int(trainer.prepare_data(rows).shape[0]),
                "world": trainer.axis.world if trainer.axis else 1,
                "wrote": list(wrote),
                "counter": int(trainer.final_state.counter)}
        print(json.dumps(results), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()

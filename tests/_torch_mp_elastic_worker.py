"""One rank of the port's multi-process crash-restart drill
(tests/test_torch_port_elastic.py): the counterpart of
tests/_mp_elastic_worker.py, on a gloo group (CPU).

Runs the elastic recipe of ``utils/elastic.py`` for processes: resume from
the newest shared checkpoint if there is one, then train data-parallel
(v3, D = 70, hidden 16, latent 4, batch 8, 4 epochs) with a checkpoint
every epoch, which rank 0 writes atomically. With ``crash_epoch`` >= 0,
rank 1 dies mid-train (``os._exit(17)``) at that epoch, between its compute
and its checkpoint; the test then kills the survivor and relaunches both.
Prints one JSON line: the epoch resumed from and the loss histories.

Usage: _torch_mp_elastic_worker.py <rank> <world> <port> <dir> <crash_epoch>
"""

import json
import os
import sys

rank, world, port, shared_dir, crash_epoch = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
    int(sys.argv[5]))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

from genome_minimizer_2_torch.train import trainer as T  # noqa: E402
from genome_minimizer_2_torch.utils import elastic  # noqa: E402
from genome_minimizer_2_torch.utils.config import ExperimentConfig  # noqa: E402

D = 70


def crash_cb(epoch, tr, vl):
    if crash_epoch >= 0 and rank == 1 and epoch == crash_epoch:
        os._exit(17)


def main():
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    rng = np.random.RandomState(0)
    train_x = rng.rand(44, D).round().astype(np.float32)
    val_x = rng.rand(13, D).round().astype(np.float32)
    cfg = ExperimentConfig(hidden_dim=16, latent_dim=4, n_epochs=4,
                           batch_size=8, trainer_version="v3",
                           print_every=1000, data_parallel=0)
    trainer = T.create_trainer("v3", cfg, D, device="cpu")
    pattern = os.path.join(shared_dir, "es_{epoch}.npz")
    ck = elastic.latest_checkpoint(pattern)
    state, start_epoch = (trainer.resume_from(ck) if ck is not None
                          else (None, 0))
    tl, vl, epochs = trainer.train(
        train_x, val_x, state=state, start_epoch=start_epoch,
        checkpoint_path=pattern, checkpoint_every=1, progress_cb=crash_cb)
    print(json.dumps({"rank": rank, "resumed_from": start_epoch,
                      "epochs": epochs, "train": tl, "val": vl}), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()

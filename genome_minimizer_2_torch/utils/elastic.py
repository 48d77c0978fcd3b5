"""Elastic training: crash detection and automatic resume; the port's own
copy of the JAX package's ``utils/elastic.py`` (its restart loop over the
trainer's bit-exact resume).

- **single-controller**: :func:`train_with_restarts` wraps
  ``VAETrainer.train``; on an exception it rebuilds the training state from
  the newest complete checkpoint (writes are atomic: a crash mid-save leaves
  the previous checkpoint intact) and continues, up to ``max_restarts``
  times. Because resume is bit-exact, a crashed-and-restarted run ends in
  the SAME final state as an uninterrupted one.
- **multi-process** (one process per card): an in-process restart cannot
  recover a lost rank (a torch.distributed group has no rejoin), so the
  restart unit is the PROCESS:

  1. run every rank under a supervisor (torchrun's ``--max-restarts``,
     systemd, a k8s restartPolicy, ``while ! train; do :; done``) with
     ``--checkpoint-every N`` and ``--max-restarts`` (or ``--resume-from
     <latest>``);
  2. on ANY rank's failure all ranks exit (their collectives fail), the
     supervisor relaunches them all, :func:`~genome_minimizer_2_torch.
     parallel.distributed.maybe_initialize` forms the group again, and
     every rank resumes from the newest shared checkpoint, which rank 0
     wrote atomically;
  3. the shard-merge sentinel barrier (parallel/barrier.py) makes the
     generation pipeline restart-safe the same way: an interrupted shard
     leaves no ``.done`` sentinel, so a merge never reads partial output.
"""

from __future__ import annotations

import glob
import logging
import os
import re
from typing import Tuple

logger = logging.getLogger(__name__)


def latest_checkpoint(pattern_path: str) -> str | None:
    """Newest complete checkpoint for a ``...{epoch}...`` path template.

    Picks the highest epoch number; ignores in-flight ``.tmp`` files (the
    atomic writer's scratch).
    """
    glob_pat = pattern_path.replace("{epoch}", "*")
    candidates = []
    rx = re.compile(re.escape(os.path.basename(pattern_path)).replace(
        re.escape("{epoch}"), r"(\d+)"))
    for path in glob.glob(glob_pat):
        if path.endswith(".tmp"):
            continue
        m = rx.fullmatch(os.path.basename(path))
        if m:
            candidates.append((int(m.group(1)), path))
    if not candidates:
        return None
    return max(candidates)[1]


def train_with_restarts(
    trainer,
    train_x,
    val_x,
    checkpoint_path: str,
    checkpoint_every: int = 1,
    max_restarts: int = 3,
) -> Tuple[list, list, int, int]:
    """Run ``trainer.train`` to completion, restarting from the newest
    checkpoint after crashes.

    ``checkpoint_path`` should contain ``{epoch}`` (epoch-stamped snapshots;
    a fixed name also works but a crash during its write window would then
    fall back to scratch... the atomic writer prevents corruption either
    way). Returns ``(train_losses, val_losses, epochs_run, restarts_used)``.

    Restart-equivalence guarantee: resume restores optimizer moments, the
    cosine-beta counter, PRNG state, early stopping, and loss histories —
    the restarted run's remaining epochs are bit-identical to the
    uninterrupted run's (tests/test_torch_port_elastic.py).
    """
    restarts = 0
    while True:
        state, start_epoch = None, 0
        ckpt = latest_checkpoint(checkpoint_path)
        if ckpt is not None:
            state, start_epoch = trainer.resume_from(ckpt)
            logger.info("elastic: resuming from %s (epoch %d)", ckpt,
                        start_epoch)
        try:
            tl, vl, epochs = trainer.train(
                train_x, val_x, state=state, start_epoch=start_epoch,
                checkpoint_path=checkpoint_path,
                checkpoint_every=checkpoint_every)
            return tl, vl, epochs, restarts
        except KeyboardInterrupt:
            raise
        except Exception as e:
            restarts += 1
            if restarts > max_restarts:
                logger.error("elastic: giving up after %d restarts", restarts - 1)
                raise
            if latest_checkpoint(checkpoint_path) is None and start_epoch == 0:
                logger.warning(
                    "elastic: crash before the first checkpoint (%s); "
                    "restart %d/%d begins from scratch", e, restarts,
                    max_restarts)
            else:
                logger.warning("elastic: training crashed (%s); restart %d/%d",
                               e, restarts, max_restarts)

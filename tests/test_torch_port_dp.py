"""The port's data-parallel training on gloo ranks (CPU), held to the JAX
package's one-process trainer: the counterpart of
tests/test_multiprocess.py::test_two_process_dp_training_matches_single_process
(its worker, tests/_mp_worker.py: D = 70, hidden 16, latent 4, batch 8,
44 training and 13 validation rows, 2 epochs).

At W = 2 every batch splits 4 + 4 rows; at W = 3 the batches split
2 + 3 + 3 and the remainder of 4 rows 1 + 1 + 2. v0 holds the
reconstruction and KL terms and BatchNorm over the global batch; v3 adds
the gene abundance (its per-gene sums all-reduced) and the L1 term
(counted once). Tolerances are the JAX contract's, rtol 2e-4 / atol 1e-5
(tests/test_multiprocess.py:90-96), on the totals that ``train()``
returns, as there: float32 sums over the ranks in another order than one
process's. Each component is also held, with the atol of the port's
trainer test for the small, noisy KL term. Every rank must report the same
histories, bit for bit.

The traps are wrong implementations patched into the worker; each must
miss the JAX reference by more than the tolerance, so the checks above
have the power to catch it. One named trap cannot be caught, and a case
shows why: the abundance term sums sigmoids, which are positive, so the
|sum| of the global batch equals the sum of each rank's |sum|, and summing
per rank before the ``abs`` gives the same term and gradient. Counting the
global term on every rank is the abundance fault that can occur; it is
caught.
"""

import functools
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "_torch_mp_dp_worker.py"
D = 70
RTOL, ATOL = 2e-4, 1e-5
COMPONENT_ATOL = 5e-3  # tests/test_torch_train_trainer.py's validation atol


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(world: int, spec: dict, timeout: int = 240,
              worker: Path = WORKER) -> list:
    """Start ``world`` ranks of ``worker`` on a fresh gloo group; their
    JSON."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), str(world), str(port),
         json.dumps(spec)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    outs = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rank {r}:\n{err[-3000:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _data():
    rng = np.random.RandomState(0)
    return (rng.rand(44, D).round().astype(np.float32),
            rng.rand(13, D).round().astype(np.float32))


@functools.lru_cache(maxsize=None)
def jax_reference(version: str, n_train: int = 44) -> tuple:
    """The JAX package's one-process trainer on the same data and config:
    (train_losses, val_losses) by component."""
    from genome_minimizer_2_tpu.train import trainer as JT
    from genome_minimizer_2_tpu.utils.config import ExperimentConfig

    cfg = ExperimentConfig(hidden_dim=16, latent_dim=4, n_epochs=2,
                           batch_size=8, trainer_version=version,
                           print_every=1000)
    t = JT.create_trainer(version, cfg, input_dim=D)
    x, xv = _data()
    t.train(x[:n_train], xv)
    return t.train_losses, t.val_losses


@functools.lru_cache(maxsize=None)
def port_one_process(version: str) -> tuple:
    from genome_minimizer_2_torch.train import trainer as TT
    from genome_minimizer_2_torch.utils.config import ExperimentConfig

    cfg = ExperimentConfig(hidden_dim=16, latent_dim=4, n_epochs=2,
                           batch_size=8, trainer_version=version,
                           print_every=1000, data_parallel=0)
    t = TT.create_trainer(version, cfg, D, device="cpu")
    t.train(*_data())
    return t.train_losses, t.val_losses


def close(got: dict, want: tuple) -> bool:
    """The loss histories ``train()`` returns (the totals) within the JAX
    contract's tolerance."""
    return all(np.allclose(hist["total"], ref["total"], rtol=RTOL, atol=ATOL)
               for hist, ref in zip((got["train"], got["val"]), want))


def assert_close(got: dict, want: tuple, what: str) -> None:
    """Totals as :func:`close`; each component also within COMPONENT_ATOL:
    the KL term (about 1) carries the noise of the pre-BatchNorm biases,
    whose gradients are zero in exact arithmetic, and reads up to 1.5e-3
    apart between the port and JAX on one process too."""
    for hist, ref in zip((got["train"], got["val"]), want):
        assert set(hist) == set(ref)
        np.testing.assert_allclose(hist["total"], ref["total"], rtol=RTOL,
                                   atol=ATOL, err_msg=f"{what}: total")
        for k in ref:
            np.testing.assert_allclose(hist[k], ref[k], rtol=RTOL,
                                       atol=COMPONENT_ATOL,
                                       err_msg=f"{what}: {k}")


TRAPS = {"bn": "v0", "l1": "v3", "abundance": "v3", "abundance_per_rank": "v3"}


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """Every run of this file, one launch of the ranks per world size:
    ``dp_runs(world)`` -> (the ranks' JSON, checkpoint dirs by label)."""
    cache = {}

    def get(world):
        if world not in cache:
            dirs, runs = {}, []
            for v in ("v0", "v3"):
                dirs[v] = tmp_path_factory.mktemp(f"ck_{v}_{world}")
                runs += [{"label": f"{v}_sharded", "version": v,
                          "ckpt": str(dirs[v])},
                         {"label": f"{v}_replicated", "version": v,
                          "shard": False}]
            if world == 2:
                runs += [{"label": t, "version": v, "trap": t}
                         for t, v in TRAPS.items()]
            else:  # 42 rows: the last batch of 2 gives rank 0 no row
                runs.append({"label": "ragged", "version": "v3", "n_train": 42})
            cache[world] = run_ranks(world, {"runs": runs}), dirs
        return cache[world]

    return get


@pytest.mark.parametrize("version,world", [("v0", 2), ("v3", 2), ("v0", 3),
                                           ("v3", 3)])
def test_data_parallel_training_matches_one_process(version, world, dp_runs):
    outs, dirs = dp_runs(world)
    for label in (f"{version}_sharded", f"{version}_replicated"):
        for o in outs[1:]:
            assert o[label]["train"] == outs[0][label]["train"], label
            assert o[label]["val"] == outs[0][label]["val"], label
        assert all(o[label]["world"] == world for o in outs)
        assert outs[0][label]["counter"] == 2 * (6 + 2)  # 6 train + 2 val steps
        assert_close(outs[0][label], jax_reference(version), f"{label} vs JAX")
        assert_close(outs[0][label], port_one_process(version),
                     f"{label} vs the port at W = 1")
    # each rank held its contiguous share of the rows: 22 of 44 at W = 2
    shares = [(r + 1) * 44 // world - r * 44 // world for r in range(world)]
    sharded, replicated = f"{version}_sharded", f"{version}_replicated"
    assert [o[sharded]["local_rows"] for o in outs] == shares
    assert [o[replicated]["local_rows"] for o in outs] == [44] * world
    # rank 0 alone wrote the epoch checkpoints
    assert outs[0][sharded]["wrote"] == ["dp_1.npz", "dp_2.npz"]
    assert all(o[sharded]["wrote"] == [] for o in outs[1:])
    assert sorted(p.name for p in dirs[version].iterdir()) == [
        "dp_1.npz", "dp_2.npz"]


def test_a_rank_with_no_row_of_the_last_batch(dp_runs):
    """42 rows at W = 3: the remainder batch of 2 rows splits 0 + 1 + 1; the
    rank with none still runs every collective of the step."""
    outs, _ = dp_runs(3)
    for o in outs[1:]:
        assert o["ragged"]["train"] == outs[0]["ragged"]["train"]
    assert [o["ragged"]["local_rows"] for o in outs] == [14, 14, 14]
    assert_close(outs[0]["ragged"], jax_reference("v3", 42), "42 rows vs JAX")


@pytest.mark.parametrize("trap", ["bn", "l1", "abundance"])
def test_data_parallel_checks_catch_a_wrong_implementation(trap, dp_runs):
    outs, _ = dp_runs(2)
    assert not close(outs[0][trap], jax_reference(TRAPS[trap])), trap


def test_abundance_summed_per_rank_before_the_abs_is_the_same_term(dp_runs):
    outs, _ = dp_runs(2)
    assert_close(outs[0]["abundance_per_rank"], jax_reference("v3"),
                 "per-rank |sum|")

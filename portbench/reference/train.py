"""The reference's account of a training run's first steps: the rows and
noise each step sees, worked out again from the run's inputs, the steps
themselves in plain float32 PyTorch, and the gaps between the program's
readings and the reference's.

What a step sees: the presets' split of the genomes (train vs the rest at
``test_size``, then validation vs test of the rest at ``val_ratio``, each a
permutation of ``numpy.random.RandomState(random_state)``, as
scikit-learn's ``train_test_split`` cuts it); at the epoch's start
``key, k = split(key)`` and the training rows shuffled by ``permutation(k,
...)``: by blocks of 8 rows on a card for batches of 256 rows or more
when the rows fill whole blocks, else row by row; then at each step ``key,
k = split(key)`` and the noise ``normal(k, (batch, latent))``.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from . import prng
from . import vae as R

STEPS = 3            # the steps the reference follows
SHUFFLE_BLOCK = 8    # rows a block of the card's shuffle moves
BLOCK_MIN_BATCH = 256
QUIET_SHARE = 1e-3   # a leaf whose first gradient is under this share of the
                     # median leaf's moves by round-off alone: left out of the change


def split_indices(n: int, test_size: float, val_ratio: float,
                  random_state: int) -> tuple[np.ndarray, np.ndarray]:
    """(train rows, validation rows) of n genomes."""
    def cut(m, share):
        n_test = int(math.ceil(share * m))
        n_train = int(math.floor((1.0 - share) * m))
        perm = np.random.RandomState(random_state).permutation(m)
        return perm[n_test: n_test + n_train], perm[:n_test]

    train, rest = cut(n, test_size)
    val_rel, _ = cut(len(rest), val_ratio)
    return train, rest[val_rel]


def _order(k, n: int, blocks: bool) -> np.ndarray:
    """The epoch's order of the n training rows under the shuffle key."""
    if blocks:
        order = prng.permutation(k, n // SHUFFLE_BLOCK)
        return (order[:, None] * SHUFFLE_BLOCK + np.arange(SHUFFLE_BLOCK)).reshape(-1)
    return prng.permutation(k, n)


def step_inputs(train_rows: torch.Tensor, key_words, batch: int, latent: int,
                blocks: bool, steps: int = STEPS):
    """[(rows, noise)] of the first ``steps`` steps of the first epoch."""
    n = train_rows.shape[0]
    key = prng.key_of(key_words)
    key, k = prng.split(key)
    idx = _order(k, n, blocks)
    out = []
    for s in range(steps):
        key, k = prng.split(key)
        rows = idx[s * batch: (s + 1) * batch]
        eps = prng.normal(k[None], len(rows) * latent).reshape(len(rows), latent)
        x = train_rows[torch.from_numpy(rows).to(train_rows.device)].float()
        out.append((x, torch.from_numpy(eps).to(train_rows.device)))
    return out


def first_batch_rows(n_train: int, n_val: int, key_words, batch: int,
                     blocks: bool, epoch: int) -> np.ndarray:
    """The training rows of the first batch of ``epoch``: before it the key
    is split once for each earlier epoch's shuffle and once for each of its
    training and validation steps."""
    key = prng.key_of(key_words)
    per_epoch = 1 + -(-n_train // batch) + -(-n_val // batch)
    for _ in range(epoch * per_epoch):
        key, _ = prng.split(key)
    _, k = prng.split(key)
    return _order(k, n_train, blocks)[:batch]


def follow(params0: dict, steps: list, loss: dict, lr: float, max_norm: float,
           precision: str = "float32", half_batch: bool = False) -> dict:
    """Train from ``params0`` through ``steps``: each step's loss
    components, the first step's ``mu`` and ``logvar``, the first
    gradient's norm by leaf as the optimizer takes it (clipped) and as the
    loss gives it, and each leaf's change after the last step. ``precision``
    is that of the products and of the moments as stored (``vae.MOMENTS``).
    ``half_batch`` is the fault that leaves out half of each batch and
    scales the rest up to the whole."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    out = {"losses": []}
    for s, (x, eps) in enumerate(steps):
        if half_batch:
            x, eps = x[: len(x) // 2], eps[: len(x) // 2]
        latent = {} if s == 0 else None
        comps = R.losses(x, eps, p, loss, epoch=0, counter=s, precision=precision,
                         latent=latent)
        if s == 0:
            out["latent"] = {k: t.cpu() for k, t in latent.items()}
        if half_batch:  # the terms summed over rows scaled up; L1 is not one
            comps = {k: c if k == "l1_regularization" else c * 2.0
                     for k, c in comps.items() if k != "total"}
            comps["total"] = sum(comps.values())
        grads = torch.autograd.grad(comps["total"], list(p.values()))
        g = {k: t.detach() for k, t in zip(p, grads)}
        out["losses"].append({k: float(c.detach()) for k, c in comps.items()})
        if s == 0:
            raw = {k: float(t.double().norm()) for k, t in g.items()}
            norm = math.sqrt(sum(r * r for r in raw.values()))
            scale = 1.0 if norm < max_norm else max_norm / norm
            out["grad_raw"] = raw
            out["grad"] = {k: r * scale for k, r in raw.items()}
        R.clip_adam(p, g, m, v2, s + 1, lr, max_norm, R.MOMENTS.get(precision))
    out["change"] = {k: float((p[k].detach() - params0[k]).double().norm())
                     for k in p}
    return out


def gaps(got: dict, want: dict, detail: bool = False) -> dict:
    """The gaps, each the worst of its kind:

    - ``first_latent_gap``: of the first step's ``mu`` and ``logvar``,
      |got - want| / |want| over the batch (rows the program left out
      count as missing);
    - ``first_loss_gap``: of the first step's loss components, |got - want|
      / |want|; ``loss_gap`` the same over every step followed;
    - ``first_grad_gap``: of every leaf, the gap between the two norms of
      the first gradient, over the larger of the reference's norm of that
      leaf and of the median leaf;
    - ``change_gap``: the same for the norm of each leaf's change after
      the last step, over the leaves whose reference gradient is at least
      ``QUIET_SHARE`` of the median leaf's;
    - ``epoch1_rows_mismatch``: the rows of epoch 1's first batch whose
      gene count differs from that of the row the reference puts there.
    """
    by_step = [max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30) for k in w)
               for g, w in zip(got["losses"], want["losses"], strict=True)]

    def worst(name, leaves):
        ref = want[name]
        med = statistics.median(ref[k] for k in leaves)
        per = {k: abs(got[name][k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in leaves}
        leaf = max(per, key=per.get)
        return per[leaf], leaf

    def latent_gap(name):
        g, w = got["latent"][name].float(), want["latent"][name].float()
        diff = w.clone()
        diff[: len(g)] -= g[: len(w)]
        return float(diff.norm() / w.norm())

    raw = want["grad_raw"]
    med = statistics.median(raw.values())
    moving = [k for k in raw if raw[k] >= QUIET_SHARE * med]
    grad, grad_leaf = worst("grad", list(want["grad"]))
    change, change_leaf = worst("change", moving)
    out = {"first_latent_gap": max(latent_gap("mu"), latent_gap("logvar")),
           "first_loss_gap": by_step[0], "loss_gap": max(by_step),
           "first_grad_gap": grad, "change_gap": change,
           "epoch1_rows_mismatch": int((got["epoch1_counts"].float()
                                        != want["epoch1_counts"].float()).sum()),
           "worst_grad_leaf": grad_leaf, "worst_change_leaf": change_leaf,
           "quiet_leaves": sorted(set(raw) - set(moving))}
    if detail:
        out["loss_by_step"] = [{k: abs(g[k] - w[k]) / max(abs(w[k]), 1e-30) for k in w}
                               for g, w in zip(got["losses"], want["losses"])]
        for name, leaves in (("grad", list(want["grad"])), ("change", moving)):
            ref = want[name]
            med = statistics.median(ref[k] for k in leaves)
            out[name + "_by_leaf"] = {k: abs(got[name][k] - ref[k]) / max(ref[k], med)
                                      for k in leaves}
    return out

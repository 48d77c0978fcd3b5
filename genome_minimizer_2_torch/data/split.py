"""Deterministic train/val/test splitting: the port's copy of the JAX
package's ``data/split.py`` (numpy only).

Reproduces sklearn's ``train_test_split(test_size=..., random_state=...)``
index arithmetic exactly (the reference's 70/20/10 split with
``random_state=12345`` — the upstream ``utils/experiments.py:232-237``) using only numpy, so the framework keeps the same
sample membership per split as the reference without depending on sklearn.

sklearn semantics (model_selection/_split.py ShuffleSplit._iter_indices):
    n_test  = ceil(test_size * n)
    n_train = floor((1 - test_size) * n)
    perm    = RandomState(seed).permutation(n)
    test    = perm[:n_test]
    train   = perm[n_test : n_test + n_train]
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np


def shuffle_split_indices(
    n: int, test_size: float, random_state: int
) -> tuple[np.ndarray, np.ndarray]:
    """(train_idx, test_idx) identical to sklearn's train_test_split."""
    n_test = int(math.ceil(test_size * n))
    n_train = int(math.floor((1.0 - test_size) * n))
    rng = np.random.RandomState(random_state)
    permutation = rng.permutation(n)
    ind_test = permutation[:n_test]
    ind_train = permutation[n_test : n_test + n_train]
    return ind_train, ind_test


class Splits(NamedTuple):
    train_idx: np.ndarray
    val_idx: np.ndarray
    test_idx: np.ndarray


def three_way_split(
    n: int,
    test_size: float = 0.3,
    val_ratio: float = 0.3333,
    random_state: int = 12345,
) -> Splits:
    """The reference's nested 70/20/10 split (experiments.py:232-237).

    First split: train vs temp (test_size); second split applied to temp:
    val vs test (val_ratio), both with the same random_state.
    """
    train_idx, temp_idx = shuffle_split_indices(n, test_size, random_state)
    val_rel, test_rel = shuffle_split_indices(len(temp_idx), val_ratio, random_state)
    return Splits(
        train_idx=train_idx,
        val_idx=temp_idx[val_rel],
        test_idx=temp_idx[test_rel],
    )


def batch_plan(n: int, batch_size: int) -> tuple[int, int]:
    """(n_full_batches, remainder) for a DataLoader-style batching with the
    final partial batch kept (torch DataLoader drop_last=False)."""
    return n // batch_size, n % batch_size

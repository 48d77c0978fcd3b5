"""Gene vocabulary loading: the port's copy of ``load_gene_vocab`` and its
vocab cache from the JAX package's ``data/dataset.py:182-246``.

The streaming pipeline only needs the gene axis of the presence/absence CSV
(its index minus the 'Lineage' row), not the matrix. Resolution order, all
keyed on the dataset file's mtime: the JAX package's ``.cache.npz`` matrix
cache, the ``.vocab.npz`` cache, then an index-only CSV read that writes
the ``.vocab.npz`` for next time. The cache files are the JAX package's,
so either package reuses what the other wrote.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

import numpy as np
import pandas as pd

from ..utils import directories

logger = logging.getLogger(__name__)


def _vocab_cache_path(dataset_path) -> Path:
    return Path(str(dataset_path) + ".vocab.npz")


def _write_vocab_cache(dataset_path, genes: np.ndarray) -> None:
    # atomic (tmp + rename): several processes may write concurrently
    path = _vocab_cache_path(dataset_path)
    tmp = path.with_suffix(f".tmp{os.getpid()}.npz")
    try:
        np.savez_compressed(
            tmp,
            genes=genes.astype(str),
            src_mtime=np.array([os.path.getmtime(dataset_path)]),
        )
        os.replace(tmp, path)
    except OSError as e:
        logger.warning("vocab cache write failed: %s", e)
        tmp.unlink(missing_ok=True)


def load_gene_vocab(dataset_path: str | None = None,
                    cache: bool = True) -> np.ndarray:
    """Gene names as an object array, in CSV row order without 'Lineage'."""
    dataset_path = dataset_path or directories.ten_k_dataset()
    mtime = os.path.getmtime(dataset_path)
    if cache:
        for path, mt_key in ((Path(str(dataset_path) + ".cache.npz"),
                              "src_mtimes"),
                             (_vocab_cache_path(dataset_path), "src_mtime")):
            if not path.exists():
                continue
            try:
                with np.load(path, allow_pickle=True) as z:
                    if float(z[mt_key][0]) == mtime:  # exact mtime match
                        logger.info("Gene vocab from cache: %s", path)
                        return z["genes"].astype(object)
            except (OSError, KeyError, ValueError) as e:
                logger.warning("vocab cache read failed (%s); ignoring", e)
    index = pd.read_csv(dataset_path, usecols=[0], index_col=0, header=0).index
    genes = np.asarray([g for g in index.astype(str) if g != "Lineage"],
                       dtype=object)
    if cache:
        _write_vocab_cache(dataset_path, genes)
    return genes

"""Converter pieces the streaming pipeline needs: the port's copy of
``load_essential_set`` and ``dedupe_columns`` from the JAX package's
``genome/converter.py:31-64``. (The pipeline fuses the rest of the
mask -> gene-list conversion into the native minimize workers.)
"""

from __future__ import annotations

import logging
from typing import Tuple

import numpy as np
import pandas as pd

logger = logging.getLogger(__name__)


def load_essential_set(essentials_csv_path: str) -> set:
    """The essential-gene set from its CSV ('# gene' or 'gene' column)."""
    essential_genes = pd.read_csv(essentials_csv_path)
    col = "# gene" if "# gene" in essential_genes.columns else "gene"
    return set(essential_genes[col].astype(str).str.strip())


def dedupe_columns(cols: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Drop duplicate gene names keeping first occurrences.

    Returns (deduped_cols, keep_mask)."""
    cols = np.asarray(cols)
    uniq, first_idx = np.unique(cols, return_index=True)
    if len(uniq) == len(cols):
        return cols, np.ones(len(cols), dtype=bool)
    logger.warning(
        "%d duplicate gene names detected; keeping first occurrences",
        len(cols) - len(uniq),
    )
    keep_mask = np.zeros(len(cols), dtype=bool)
    keep_mask[np.sort(first_idx)] = True
    return cols[keep_mask], keep_mask

"""The reference's account of sampled genomes: each genome's latent drawn
again from the run's key, the decoder in plain float32 PyTorch, the
threshold at logit 0 (probability one half), and the per-genome counts
recomputed from the rows the program returned.

Genome i of call c has the latent ``normal(fold_in(fold_in(root, c), i),
(latent,))``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import prng
from . import vae as R


def latents(root_words, call: int, lo: int, hi: int, latent: int) -> np.ndarray:
    key = prng.fold_in(prng.key_of(root_words), call)
    return prng.normal(prng.fold_in(key, np.arange(lo, hi)), latent)


def logits(z: torch.Tensor, params: dict, stats: dict,
           precision: str = "float32") -> torch.Tensor:
    """The decoder's logits (rows, genes), eval-mode BatchNorm."""
    h = R.decoder_hidden(z, params, precision, stats)
    return R.product(h, params["decoder/3/w"], precision) + params["decoder/3/b"]


def bit_gap(rows: torch.Tensor, ref_logits: torch.Tensor) -> tuple[float, int]:
    """(widest gap, bits that differ): the largest |reference logit| at a
    gene whose bit in ``rows`` (unpacked, {0, 1}) differs from the
    reference's threshold, in units of the root mean square of the
    reference's logits; 0 where none differs."""
    ref_bits = (ref_logits > 0).to(torch.uint8)
    differ = rows != ref_bits
    n = int(differ.sum())
    if n == 0:
        return 0.0, 0
    rms = ref_logits.square().mean().sqrt()
    return float(ref_logits.abs()[differ].max() / rms), n


def counts(rows: torch.Tensor, essential: dict) -> tuple[np.ndarray, np.ndarray]:
    """(genes present, essential genes present) per row of ``rows``
    (unpacked): an essential gene counts once if any of its columns is
    set."""
    size = rows.sum(dim=1, dtype=torch.int64)
    genes = rows.shape[1]
    ess = torch.zeros(rows.shape[0], dtype=torch.int64, device=rows.device)
    for cols in essential.values():
        cols = [c for c in cols if c < genes]
        if cols:
            ess += rows[:, cols].amax(dim=1).to(torch.int64)
    return size.cpu().numpy(), ess.cpu().numpy()

"""Reconstruction evaluation metrics: the port of the JAX package's
``eval/metrics.py`` (:31-187).

Reconstruction runs the full VAE forward in eval mode (BatchNorm on its
running statistics) but keeps the reparameterization noise, as the
reference does, keyed per batch with ``fold_in(key, i)`` so the draws are
the JAX package's. At the reference's threshold of 0.5 the output layer
and the threshold go through the ``decode_threshold_pack`` kernel
(``sigmoid(l) > 0.5`` is ``l > 0``) and only packed bits leave the device.
Binary F1 and accuracy are closed-form numpy (2TP/(2TP+FP+FN),
(TP+TN)/total).

Under tensor parallelism (a model that holds its gene slice,
``VAE.shard_genes``) every rank of the model axis takes the same rows: the
encoder sums its first layer over the model axis, the decode runs on the
rank's gene slice, and the slices' packed bytes (or bits) are all-gathered
in rank order; the loss breakdown sums the slices' BCE over the model axis.
"""

from __future__ import annotations

from datetime import datetime
from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch

from ..models import vae
from ..ops import kernels as K
from ..ops import losses as L
from ..ops import prng


def binary_f1(pred: np.ndarray, target: np.ndarray) -> float:
    """sklearn.metrics.f1_score for binary {0,1} arrays (zero-division -> 0)."""
    pred = np.asarray(pred).ravel()
    target = np.asarray(target).ravel()
    tp = float(np.sum((pred == 1) & (target == 1)))
    fp = float(np.sum((pred == 1) & (target == 0)))
    fn = float(np.sum((pred == 0) & (target == 1)))
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom > 0 else 0.0


def binary_accuracy(pred: np.ndarray, target: np.ndarray) -> float:
    pred = np.asarray(pred).ravel()
    target = np.asarray(target).ravel()
    return float(np.mean(pred == target))


def _batches(model: vae.VAE, x: np.ndarray, batch_size: int):
    """(i, padded device batch of the model's gene columns) over the rows
    of x."""
    device = next(model.parameters()).device
    x = np.asarray(x, np.float32)
    for i, lo in enumerate(range(0, x.shape[0], batch_size)):
        rows = torch.from_numpy(x[lo: lo + batch_size]).to(device)
        yield i, model.gene_columns(rows)


@torch.no_grad()
def reconstruct_binary(model: vae.VAE, x: np.ndarray, key: torch.Tensor,
                       batch_size: int = 32, threshold: float = 0.5
                       ) -> np.ndarray:
    """Binarized reconstructions of x via the full VAE forward in eval mode
    (metrics.py:36-47), batch i drawing its noise from ``fold_in(key, i)``.
    Returns uint8 (N, input_dim)."""
    cfg, axis = model.cfg, model.gene_axis
    cd = cfg.policy.compute_dtype
    w = model.output.w.detach().to(cd).contiguous()
    b = model.output.b.detach().float().contiguous()
    outs = []
    for i, batch in _batches(model, x, batch_size):
        h, _, _, _ = model.forward_hidden(batch, prng.fold_in(key.to(batch.device), i),
                                          False)
        if threshold == 0.5:
            packed = K.decode_threshold_pack(h, w, b, compute_dtype=cd)
            if axis is not None:  # the slices' whole bytes, in gene order
                packed = axis.all_gather_genes(packed, 1)
            outs.append(K.unpack_bits(packed.cpu().numpy(), cfg.input_dim))
        else:
            logits = model.output(h, cfg.policy).to(cfg.policy.logits_dtype)
            bits = (torch.sigmoid(logits.float()) > threshold).to(torch.uint8)
            if axis is not None:
                bits = axis.all_gather_genes(bits, 1)
            outs.append(bits[:, : cfg.input_dim].cpu().numpy())
    return np.concatenate(outs, axis=0)


def calculate_reconstruction_metrics(
    model: vae.VAE,
    test_x: np.ndarray,
    key: torch.Tensor,
    threshold: float = 0.5,
    batch_size: int = 32,
) -> Tuple[float, float, List[float], List[float]]:
    """(overall_f1, overall_accuracy, per_sample_f1, per_sample_accuracy) —
    the reference's return signature (metrics.py:19-64)."""
    recon = reconstruct_binary(model, test_x, key, batch_size, threshold)
    target = np.asarray(test_x).astype(np.uint8)
    overall_f1 = binary_f1(recon, target)
    overall_accuracy = binary_accuracy(recon, target)
    tp = ((recon == 1) & (target == 1)).sum(axis=1).astype(float)
    fp = ((recon == 1) & (target == 0)).sum(axis=1).astype(float)
    fn = ((recon == 0) & (target == 1)).sum(axis=1).astype(float)
    denom = 2 * tp + fp + fn
    f1_scores = np.where(denom > 0, 2 * tp / np.maximum(denom, 1e-12), 0.0)
    accuracy_scores = (recon == target).mean(axis=1)
    return overall_f1, overall_accuracy, f1_scores.tolist(), accuracy_scores.tolist()


@torch.no_grad()
def calculate_reconstruction_loss_breakdown(
    model: vae.VAE, test_x: np.ndarray, key: torch.Tensor, batch_size: int = 32,
) -> dict:
    """Average recon/KL losses over the test set (metrics.py:196-233)."""
    total_recon, total_kl, n = 0.0, 0.0, 0
    mask = None
    for i, batch in _batches(model, test_x, batch_size):
        if mask is None:
            mask = model.gene_mask(batch.device)
        logits, mu, logvar, _ = model.forward(
            batch, prng.fold_in(key.to(batch.device), i), False)
        recon = L.bce_sum_logits(logits, batch, mask)
        if model.gene_axis is not None:  # the slices' sums
            recon = model.gene_axis.all_reduce_(recon)
        total_recon += float(recon)
        total_kl += float(L.kl_divergence(mu, logvar))
        n += batch.shape[0]
    return {
        "avg_reconstruction_loss": total_recon / n,
        "avg_kl_divergence_loss": total_kl / n,
        "total_samples": n,
    }


def metric_summary_report(
    overall_f1: float, overall_accuracy: float,
    f1_scores: List[float], accuracy_scores: List[float],
) -> str:
    """The reference's metrics text report (metrics.py:124-179)."""
    f1 = np.asarray(f1_scores)
    acc = np.asarray(accuracy_scores)
    return f"""
    ===============================================
    RECONSTRUCTION METRICS SUMMARY REPORT
    ===============================================
    Generated on: {datetime.now().strftime('%Y-%m-%d %H:%M:%S')}

    Overall Metrics (flattened):
    - F1 Score: {overall_f1:.4f}
    - Accuracy: {overall_accuracy:.4f}

    Per-Sample Metrics:
    - F1 Score - Mean: {f1.mean():.4f}, Std: {f1.std():.4f}
    - F1 Score - Min: {f1.min():.4f}, Max: {f1.max():.4f}
    - Accuracy - Mean: {acc.mean():.4f}, Std: {acc.std():.4f}
    - Accuracy - Min: {acc.min():.4f}, Max: {acc.max():.4f}

    Sample Statistics:
    - Total samples: {len(f1_scores)}
    - Samples with F1 > 0.9: {int((f1 > 0.9).sum())}
    - Samples with F1 < 0.5: {int((f1 < 0.5).sum())}
    - Samples with Accuracy > 0.95: {int((acc > 0.95).sum())}
    - Samples with Accuracy < 0.8: {int((acc < 0.8).sum())}

    Detailed Statistics:
    F1 Score Percentiles:
    - 25th: {np.percentile(f1, 25):.4f}
    - 50th (Median): {np.percentile(f1, 50):.4f}
    - 75th: {np.percentile(f1, 75):.4f}
    - 90th: {np.percentile(f1, 90):.4f}
    - 95th: {np.percentile(f1, 95):.4f}

    Accuracy Percentiles:
    - 25th: {np.percentile(acc, 25):.4f}
    - 50th (Median): {np.percentile(acc, 50):.4f}
    - 75th: {np.percentile(acc, 75):.4f}
    - 90th: {np.percentile(acc, 90):.4f}
    - 95th: {np.percentile(acc, 95):.4f}
    ===============================================
    """


def print_metric_summary(config, overall_f1, overall_accuracy, f1_scores,
                         accuracy_scores, output_dir: str | None = None):
    report = metric_summary_report(overall_f1, overall_accuracy, f1_scores,
                                   accuracy_scores)
    print(report)
    if output_dir:
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        report_file = out / f"{config.trainer_version}_metrics_summary.txt"
        report_file.write_text(report)
        print(f"✓ Metrics summary saved to: {report_file}")

"""Visualization suite: the port's copy of the JAX package's
``eval/visualise.py`` (numpy + matplotlib, no framework code).

Capability parity with the reference's plotting surface
(the upstream ``training/evaluation/visualise.py`` and
``utils/extras.py:20-163, 231-255``): latent-space PCA by phylogroup, latent
dimension histograms, original-vs-reconstruction examples, the 2x2 training
summary panel, loss-vs-epoch curves, genome-size and essential-gene
distributions, essential-vs-total scatter, and F1/accuracy histograms.

The figure *content* (panel layout, axis labels, colors, the summary stats
block) is an output artifact users of the reference expect to keep — those
surfaces are declared in PARITY.md §output-parity. The construction here is
the framework's own: small composable panel builders (histogram-with-marker,
curve set, stats text) driven by per-figure specs, instead of the
reference's straight-line matplotlib scripts.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    HAS_MATPLOTLIB = True
except ImportError:  # the figures need it; the PCA and the numbers do not
    HAS_MATPLOTLIB = False

    class _NoPyplot:
        def __getattr__(self, name):
            raise ImportError("plotting needs matplotlib, which is not "
                              "installed; run with generate_plots off "
                              "(--no-generate-plots)")

    plt = _NoPyplot()

try:
    import seaborn as sns
except ImportError:  # pragma: no cover
    sns = None

from .pca import pca_fit_transform

# ---------------------------------------------------------------------------
# Panel builders — the building blocks every figure below composes
# ---------------------------------------------------------------------------


def _save_pdf(path: str) -> None:
    plt.savefig(path, format="pdf", bbox_inches="tight")
    plt.close()


def _hist_panel(ax, values, *, color: str, bins=None, hist_range=None,
                edgecolor=None, alpha=1.0, marker: str = "",
                marker_color: str = "red", marker_style: str = "--",
                marker_alpha: float = 1.0, xlabel: str = "",
                ylabel: str = "Frequency", title: str = "", grid: bool = False,
                legend: bool = True, label_fmt: str = "{stat}: {val:.3f}"):
    """Histogram with an optional central-tendency marker line.

    ``marker`` is '' (none), 'mean' or 'median'; the marker line carries a
    legend entry formatted by ``label_fmt``.
    """
    values = np.asarray(values)
    kwargs = {}
    if bins is not None:
        kwargs["bins"] = bins
    if hist_range is not None:
        kwargs["range"] = hist_range
    if edgecolor is not None:
        kwargs["edgecolor"] = edgecolor
    ax.hist(values, color=color, alpha=alpha, **kwargs)
    if marker:
        stat_val = float(np.mean(values) if marker == "mean"
                         else np.median(values))
        ax.axvline(stat_val, color=marker_color, linestyle=marker_style,
                   alpha=marker_alpha,
                   label=label_fmt.format(stat=marker.capitalize(),
                                          val=stat_val))
        if legend:
            ax.legend()
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    if title:
        ax.set_title(title)
    if grid:
        ax.grid(True, alpha=0.3)


def _curves_panel(ax, x, series, *, xlabel: str, ylabel: str,
                  title: str = "", grid: bool = False):
    """Overlayed line series: [(values, label, color), ...]."""
    for values, label, color in series:
        ax.plot(x, values, label=label, color=color, alpha=0.8)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    if title:
        ax.set_title(title)
    ax.legend()
    if grid:
        ax.grid(True, alpha=0.3)


def _stats_block(title: str, sections: list[tuple[str, list[tuple[str, str]]]]
                 ) -> str:
    """Render a stats text block: a title, then labeled sections of
    (name, value) rows — the reference summary panel's content
    (visualise.py:221-245) built from data instead of a literal."""
    lines = ["", f"    {title}", ""]
    for heading, rows in sections:
        if heading:
            lines.append(f"    {heading}")
            lines.extend(f"    - {name} {value}" for name, value in rows)
        else:
            lines.extend(f"    {name} {value}" for name, value in rows)
        lines.append("")
    return "\n".join(lines)


def _minmax_summary(values, median_color="b"):
    """Median/min/max legend handles (extras.py's sampling figures)."""
    values = np.asarray(values)
    median = float(np.median(values))
    mk = lambda color, label: plt.Line2D([], [], color=color, linewidth=2,
                                         label=label)
    handles = [
        plt.Line2D([], [], color=median_color, linestyle="dashed",
                   linewidth=2, label=f"Median: {median:.2f}"),
        mk("black", f"Min: {values.min():.2f}"),
        mk("black", f"Max: {values.max():.2f}"),
    ]
    return median, handles


# ---------------------------------------------------------------------------
# Sampling-mode figures (extras.py:20-163, 231-255)
# ---------------------------------------------------------------------------


def plot_loss_vs_epochs_graph(epochs, train_loss_vals, val_loss_vals, fig_name):
    """Train/val loss curves (extras.py:231-255)."""
    plt.figure(figsize=(4, 4), dpi=300)
    for vals, label, color in ((train_loss_vals, "Train Loss", "dodgerblue"),
                               (val_loss_vals, "Validation Loss", "darkorange")):
        plt.scatter(epochs, vals, color=color)
        plt.plot(epochs, vals, label=label, color=color)
    plt.xlabel("Epoch")
    plt.ylabel("Loss")
    plt.legend(fontsize=8)
    _save_pdf(fig_name)


def plot_samples_distribution(binary_generated_samples, figure_name, plot_color,
                              x_min=0, x_max=0):
    """Genome-size histogram (extras.py:127-163). Accepts the dense (N, D)
    sample matrix or precomputed per-sample sizes (N,) — the bounded-memory
    sample mode passes sizes popcounted from packed bitmasks."""
    sizes = np.asarray(binary_generated_samples)
    if sizes.ndim == 2:
        sizes = sizes.sum(axis=1)
    median, handles = _minmax_summary(sizes)
    plt.figure(figsize=(5, 5))
    plt.hist(sizes, color=plot_color)
    plt.xlim(x_min, x_max)
    plt.xlabel("Genome size")
    plt.ylabel("Frequency")
    plt.axvline(median, color="b", linestyle="dashed", linewidth=2)
    plt.legend(handles=handles, fontsize=6, loc="upper left")
    _save_pdf(figure_name)


def plot_essential_genes_distribution(essential_counts, figure_name, plot_color,
                                      x_min=0, x_max=0):
    """Essential-genes histogram (extras.py:90-124)."""
    counts = np.asarray(essential_counts)
    median, handles = _minmax_summary(counts)
    plt.figure(figsize=(5, 5))
    plt.hist(counts, color=plot_color, range=(x_min, x_max), bins=30)
    plt.xlim(x_min, x_max)
    plt.xlabel("Essential genes")
    plt.ylabel("Frequency")
    plt.axvline(median, color="b", linestyle="dashed", linewidth=2)
    plt.legend(handles=handles, fontsize=6)
    _save_pdf(figure_name)


def plot_essential_vs_total(essential_counts, total_counts, output_path):
    """Essential vs genome size scatter + regression (extras.py:20-28)."""
    plt.figure(figsize=(4, 4))
    plt.scatter(total_counts, essential_counts, color="violet")
    if sns is not None:
        sns.regplot(x=np.asarray(total_counts), y=np.asarray(essential_counts),
                    scatter=False, color="black")
    plt.xlabel("Genome size")
    plt.ylabel("Essential genes")
    _save_pdf(output_path)


# ---------------------------------------------------------------------------
# Evaluation figures (visualise.py, metrics.py:67-121)
# ---------------------------------------------------------------------------


def plot_latent_space_pca(latents, phylogroups, config, output_dir,
                          n_components: int = 3, show_plot: bool = True):
    """Latent PCA scatter by phylogroup (visualise.py:20-81).

    Takes precomputed latents (Sampler.encode_means) instead of a model +
    loader. Returns a DataFrame with PC columns + phylogroup.
    """
    import pandas as pd

    os.makedirs(output_dir, exist_ok=True)
    data_pca, ratio = pca_fit_transform(latents, n_components)
    df_pca = pd.DataFrame(data_pca, columns=[f"PC{i + 1}" for i in range(n_components)])
    df_pca["phylogroup"] = np.asarray(phylogroups)
    if show_plot:
        fig, ax = plt.subplots(figsize=(5, 5))
        if sns is not None:
            sns.scatterplot(x="PC1", y="PC2", hue=df_pca["phylogroup"],
                            data=df_pca, ax=ax)
            handles, labels = ax.get_legend_handles_labels()
            ax.legend(handles, labels, fontsize=6)
        else:
            ax.scatter(df_pca["PC1"], df_pca["PC2"], s=8)
        xlim, ylim = ax.get_xlim(), ax.get_ylim()
        lims = [min(xlim[0], ylim[0]), max(xlim[1], ylim[1])]
        ax.set_xlim(lims)
        ax.set_ylim(lims)
        ax.set_aspect("equal", adjustable="box")
        plt.savefig(os.path.join(
            output_dir, f"{config.trainer_version}_pca_latent_space_test_set.pdf"),
            format="pdf", bbox_inches="tight")
        plt.close()
        print(f"PCA Explained Variance Ratio: {ratio}")
        print(f"Total Explained Variance: {ratio.sum():.3f}")
    return df_pca


def plot_latent_dimensions_distribution(latents, output_dir):
    """Per-dimension latent histograms (artifact parity: visualise.py:84-121)."""
    os.makedirs(output_dir, exist_ok=True)
    latents = np.asarray(latents)
    n_dims = latents.shape[1]
    n_cols = 4
    n_rows = (n_dims + n_cols - 1) // n_cols
    fig, axes = plt.subplots(n_rows, n_cols, figsize=(15, 3 * n_rows), dpi=150)
    axes = np.atleast_1d(axes).ravel()
    for i, ax in enumerate(axes):
        if i >= n_dims:
            ax.set_visible(False)
            continue
        _hist_panel(ax, latents[:, i], color="skyblue", bins=30, alpha=0.7,
                    edgecolor="black", xlabel="Value",
                    title=f"Latent Dim {i + 1}", grid=True)
        ax.set_title(f"Latent Dim {i + 1}", fontsize=10)
    plt.tight_layout()
    _save_pdf(os.path.join(output_dir, "latent_dimensions_distribution.pdf"))


def plot_reconstruction_examples(originals, reconstructions, output_dir,
                                 n_examples: int = 5):
    """Original-vs-reconstruction line plots (artifact parity:
    visualise.py:124-176)."""
    os.makedirs(output_dir, exist_ok=True)
    panels = (("Original Sample", "Presence", None),
              ("Reconstructed Sample", "Probability", "orange"))
    for i in range(min(n_examples, len(originals))):
        fig, axs = plt.subplots(1, 2, figsize=(10, 4))
        for ax, (title, ylabel, color), values in zip(
                axs, panels, (originals[i], reconstructions[i])):
            ax.plot(np.asarray(values), alpha=0.7,
                    **({"color": color} if color else {}))
            ax.set_title(f"{title} {i + 1}")
            ax.set_xlabel("Gene Index")
            ax.set_ylabel(ylabel)
        plt.tight_layout()
        _save_pdf(os.path.join(output_dir, f"reconstruction_example_{i + 1}.pdf"))


def generate_metric_histograms(f1_scores, accuracy_scores, config, output_dir):
    """F1 and accuracy histograms (metrics.py:67-121)."""
    os.makedirs(output_dir, exist_ok=True)
    specs = (
        (f1_scores, "F1 score", "median", "red", (0.9, 1.0),
         f"{config.trainer_version}_f1_score_frequency_test_set.pdf"),
        (accuracy_scores, "Accuracy Score", "mean", "darkred", None,
         f"{config.trainer_version}_accuracy_score_frequency_test_set.pdf"),
    )
    for values, xlabel, marker, mcolor, xlim, fname in specs:
        plt.figure(figsize=(4, 4), dpi=300)
        _hist_panel(plt.gca(), values, color="dodgerblue", xlabel=xlabel,
                    marker=marker, marker_color=mcolor, marker_alpha=0.8,
                    grid=True)
        if xlim:
            plt.xlim(*xlim)
            plt.tight_layout()
        _save_pdf(os.path.join(output_dir, fname))


def create_training_summary_plot(train_losses: List[float], val_losses: List[float],
                                 f1_scores: Sequence[float],
                                 accuracy_scores: Sequence[float],
                                 output_dir: str, model_name: str = "VAE"):
    """2x2 training summary panel (artifact parity: visualise.py:179-256):
    loss curves, F1 and accuracy histograms, and a stats text block."""
    os.makedirs(output_dir, exist_ok=True)
    f1 = np.asarray(f1_scores)
    acc = np.asarray(accuracy_scores)
    fig, axes = plt.subplots(2, 2, figsize=(12, 10), dpi=150)

    _curves_panel(axes[0, 0], range(1, len(train_losses) + 1),
                  [(train_losses, "Training Loss", "blue"),
                   (val_losses, "Validation Loss", "red")],
                  xlabel="Epochs", ylabel="Loss",
                  title=f"{model_name} Training Curves", grid=True)
    _hist_panel(axes[0, 1], f1, color="green", bins=30, alpha=0.7,
                edgecolor="black", marker="mean", marker_color="darkgreen",
                xlabel="F1 Score", title="F1 Score Distribution", grid=True)
    _hist_panel(axes[1, 0], acc, color="purple", bins=30, alpha=0.7,
                edgecolor="black", marker="mean", marker_color="darkviolet",
                xlabel="Accuracy Score", title="Accuracy Distribution",
                grid=True)

    # assemble the stats rows the reference panel reports (same content)
    def stat_rows(v):
        return [("Mean:", f"{np.mean(v):.4f}"), ("Std: ", f"{np.std(v):.4f}"),
                ("Min: ", f"{np.min(v):.4f}"), ("Max: ", f"{np.max(v):.4f}")]

    summary_text = _stats_block(
        f"{model_name} Training Summary",
        [("", [("Final Training Loss:", f"{train_losses[-1]:.4f}"),
               ("Final Validation Loss:", f"{val_losses[-1]:.4f}")]),
         ("F1 Score Statistics:", stat_rows(f1)),
         ("Accuracy Statistics:", stat_rows(acc)),
         ("", [("Total Epochs:", str(len(train_losses)))])],
    )
    axes[1, 1].axis("off")
    axes[1, 1].text(0.1, 0.9, summary_text, transform=axes[1, 1].transAxes,
                    fontsize=11, verticalalignment="top",
                    bbox=dict(boxstyle="round", facecolor="lightgray", alpha=0.5))
    plt.tight_layout()
    _save_pdf(os.path.join(output_dir, f"{model_name}_training_summary.pdf"))

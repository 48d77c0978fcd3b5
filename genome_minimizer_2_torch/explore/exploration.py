"""Data exploration and analysis (``--mode explore``): the port's copy of
the JAX package's ``explore/exploration.py``.

Figures 1a-1d + 2a (gene-frequency histogram, genome-size histogram,
frequency-threshold curve, essential-genes histogram, PCA by phylogroup) and
the text summary report, with pandas/numpy and PCA by SVD. The figures need
matplotlib and are skipped without it (as in ``eval/visualise.py``); the
summary report is written either way.
"""

from __future__ import annotations

import logging
import re
from pathlib import Path
from typing import List

import numpy as np
import pandas as pd

from ..data.dataset import load_and_validate_data
from ..eval.pca import pca_fit_transform
from ..eval.visualise import HAS_MATPLOTLIB, plt, sns
from ..utils import directories
from .essential_genes import clean_gene_name

logger = logging.getLogger(__name__)

FIGURE_SIZE = (4, 4)
PLOT_COLOR = "darkorchid"
PLOT_DPI = 150


def figures_dir() -> Path:
    d = directories.project_root() / "data" / "data_exploration"
    d.mkdir(parents=True, exist_ok=True)
    return d


def create_genome_size_distribution_plot(data_without_lineage, out_dir: Path):
    """Figure 1a: the gene-frequency histogram."""
    gene_frequencies = data_without_lineage.sum(axis=0).values
    plt.figure(figsize=FIGURE_SIZE, dpi=PLOT_DPI)
    plt.hist(gene_frequencies, color=PLOT_COLOR, bins=20)
    plt.xlabel("Genome size")
    plt.ylabel("Frequency")
    median = np.median(gene_frequencies)
    plt.axvline(median, color="b", linestyle="dashed", linewidth=2)
    handles = [
        plt.Line2D([], [], color="b", linestyle="dashed", linewidth=2,
                   label=f"Median: {int(median)}"),
        plt.Line2D([], [], color="black", linewidth=2,
                   label=f"Min: {int(np.min(gene_frequencies))}"),
        plt.Line2D([], [], color="black", linewidth=2,
                   label=f"Max: {int(np.max(gene_frequencies))}"),
    ]
    plt.legend(handles=handles, fontsize=8)
    plt.tight_layout()
    plt.savefig(out_dir / "plot_genome_size_final.pdf", format="pdf",
                bbox_inches="tight")
    plt.close()


def create_gene_count_distribution_plot(data_without_lineage, out_dir: Path):
    """Figure 1b: the genome-size histogram."""
    genome_sizes = data_without_lineage.sum(axis=1)
    plt.figure(figsize=FIGURE_SIZE, dpi=PLOT_DPI)
    plt.hist(genome_sizes, color=PLOT_COLOR, bins=20)
    plt.xlabel("Number of genomes")
    plt.ylabel("Number of genes")
    plt.tight_layout()
    plt.savefig(out_dir / "plot_gene_count_final.pdf", format="pdf",
                bbox_inches="tight")
    plt.close()


def create_gene_frequency_threshold_plot(data_without_lineage, out_dir: Path):
    """Figure 1c: genes present in at least t genomes, over thresholds."""
    thresholds = np.linspace(0, 50, num=50)
    gene_frequencies = data_without_lineage.sum(axis=1).values
    threshold_data = (gene_frequencies[None, :] >= thresholds[:, None]).sum(axis=1)
    plt.figure(figsize=FIGURE_SIZE, dpi=PLOT_DPI)
    plt.scatter(thresholds, threshold_data, color=PLOT_COLOR, alpha=0.7, s=30)
    plt.plot(thresholds, threshold_data, color=PLOT_COLOR, linewidth=2)
    plt.xlabel("Minimum Number of Genomes")
    plt.ylabel("Number of Genes")
    plt.tight_layout()
    plt.savefig(out_dir / "plot_gene_frequency_final.pdf", format="pdf",
                bbox_inches="tight")
    plt.close()


def process_essential_genes(merged_df: pd.DataFrame,
                            essential_genes_path: str | None = None,
                            save_list: bool = True) -> pd.DataFrame:
    """Essential-gene matching + family consolidation. Returns the
    per-sample essential-genes presence dataframe."""
    essential_genes_path = essential_genes_path or directories.paper_essential_genes()
    essential_genes = pd.read_csv(essential_genes_path)
    essential_genes_array = essential_genes.values.flatten()
    all_genes = merged_df.columns[:-1]
    all_genes_str = all_genes.astype(str)

    direct_mask = pd.Series(essential_genes_array).isin(all_genes).to_numpy()
    present_genes = essential_genes_array[direct_mask]
    absent_genes = essential_genes_array[~direct_mask]
    present_set = set(map(str, present_genes))

    matched_columns: List[str] = []
    for gene in absent_genes:
        clean = clean_gene_name(gene)
        if clean is None:
            continue
        matched_columns.extend(
            col for col in all_genes_str
            if col.startswith(clean) and col not in present_set)
    divided_genes = np.array(matched_columns, dtype=object)

    combined = np.concatenate((present_genes.astype(object), divided_genes))
    mask = all_genes.isin(combined)
    essential_genes_df = merged_df.iloc[:, :-1].loc[:, mask].copy()

    # consolidate absent families: present if ANY variant present
    absent_df = pd.DataFrame(index=essential_genes_df.index)
    for prefix in absent_genes:
        clean = clean_gene_name(prefix)
        if clean is None:
            continue
        prefix_cols = essential_genes_df.filter(regex=f"^{re.escape(clean)}")
        if not prefix_cols.empty:
            absent_df[clean] = (prefix_cols.sum(axis=1) > 0).astype(int)

    final_df = essential_genes_df.drop(columns=list(divided_genes), errors="ignore")
    genes_to_add = absent_df.columns[absent_df.sum(axis=0) > 0]
    for gene in genes_to_add:
        final_df[gene] = absent_df[gene]
    logger.info("Final essential genes dataframe: %s", final_df.shape)

    if save_list:
        out = directories.project_root() / "data" / "essential_genes"
        out.mkdir(parents=True, exist_ok=True)
        np.save(out / "essential_gene_in_ds.npy", final_df.columns.tolist())
    return final_df


def create_essential_genes_distribution_plot(essential_genes_df, out_dir: Path):
    """Figure 1d: the essential-genes histogram."""
    counts = essential_genes_df.sum(axis=1)
    plt.figure(figsize=FIGURE_SIZE, dpi=PLOT_DPI)
    plt.hist(counts, color=PLOT_COLOR, bins=50)
    plt.xlabel("Essential genes")
    plt.ylabel("Frequency")
    plt.tight_layout()
    plt.savefig(out_dir / "plot_EG_number.pdf", format="pdf", bbox_inches="tight")
    plt.close()


def create_pca_phylogroup_plot(merged_df: pd.DataFrame, out_dir: Path):
    """Figure 2a: PCA of the presence matrix by phylogroup."""
    # presence/absence values are {0,1}: extract at uint8, not pandas' int64
    # (~4.4 GB for the real 10k x 55k) — the PCA streams it chunk-wise
    gene_data = merged_df.iloc[:, :-1].to_numpy(dtype=np.uint8)
    phylogroups = merged_df["Phylogroup"].values
    data_pca, ratio = pca_fit_transform(gene_data, 2)
    df_pca = pd.DataFrame(data_pca, columns=["PC1", "PC2"])
    df_pca["Phylogroup"] = phylogroups
    plt.figure(figsize=FIGURE_SIZE, dpi=PLOT_DPI)
    if sns is not None:
        sns.scatterplot(data=df_pca, x="PC1", y="PC2", hue="Phylogroup",
                        alpha=0.7, s=30)
    else:
        plt.scatter(df_pca["PC1"], df_pca["PC2"], alpha=0.7, s=30)
    plt.xlabel(f"PC1 ({ratio[0]:.1%} variance)")
    plt.ylabel(f"PC2 ({ratio[1]:.1%} variance)")
    plt.tight_layout()
    plt.savefig(out_dir / "plot_PCA_by_phylogroup.pdf", format="pdf",
                bbox_inches="tight")
    plt.close()


def generate_summary_report(merged_df, essential_genes_df, out_dir: Path) -> str:
    """The text summary report, written to data_exploration_report.txt and
    printed."""
    n_genomes = merged_df.shape[0]
    n_genes = merged_df.shape[1] - 1
    genome_sizes = merged_df.iloc[:, :-1].sum(axis=1)
    essential_counts = essential_genes_df.sum(axis=1)
    phylogroup_counts = merged_df["Phylogroup"].value_counts()

    report = f"""
    ===============================================
    GENOMICS DATA EXPLORATION SUMMARY REPORT
    ===============================================

    Dataset Overview:
    - Total genomes: {n_genomes:,}
    - Total genes: {n_genes:,}
    - Essential genes identified: {essential_genes_df.shape[1]:,}
    - Phylogroups: {len(phylogroup_counts)}

    Genome Size Statistics:
    - Mean genome size: {genome_sizes.mean():.0f} genes
    - Median genome size: {genome_sizes.median():.0f} genes
    - Range: {genome_sizes.min():.0f} - {genome_sizes.max():.0f} genes
    - Standard deviation: {genome_sizes.std():.0f} genes

    Essential Genes Statistics:
    - Mean essential genes per genome: {essential_counts.mean():.1f}
    - Median essential genes per genome: {essential_counts.median():.0f}
    - Range: {essential_counts.min():.0f} - {essential_counts.max():.0f}
    - Standard deviation: {essential_counts.std():.1f}

    Phylogroup Distribution:
    """
    for phylogroup, count in phylogroup_counts.items():
        report += f"    - {phylogroup}: {count:,} genomes ({count / n_genomes * 100:.1f}%)\n"
    report += f"""
    Generated Figures:
    - Figure 1a: Gene frequency distribution (plot_genome_size_final.pdf)
    - Figure 1b: Genome size distribution (plot_gene_count_final.pdf)
    - Figure 1c: Gene frequency thresholds (plot_gene_frequency_final.pdf)
    - Figure 1d: Essential genes distribution (plot_EG_number.pdf)
    - Figure 2a: PCA by phylogroup (plot_PCA_by_phylogroup.pdf)

    Output Directory: {out_dir}
    ===============================================
    """
    (out_dir / "data_exploration_report.txt").write_text(report)
    print(report)
    return report


def main():
    """Full exploration: the figures (when matplotlib is installed) and the
    summary report."""
    logger.info("Starting data exploration analysis...")
    out_dir = figures_dir()
    large_data, merged_df, data_without_lineage = load_and_validate_data()
    if HAS_MATPLOTLIB:
        create_genome_size_distribution_plot(data_without_lineage, out_dir)
        create_gene_count_distribution_plot(data_without_lineage, out_dir)
        create_gene_frequency_threshold_plot(data_without_lineage, out_dir)
    essential_genes_df = process_essential_genes(merged_df)
    if HAS_MATPLOTLIB:
        create_essential_genes_distribution_plot(essential_genes_df, out_dir)
        create_pca_phylogroup_plot(merged_df, out_dir)
    else:
        print("- Figures skipped (matplotlib is not installed); the summary "
              "report follows")
    generate_summary_report(merged_df, essential_genes_df, out_dir)
    logger.info("✓ DATA EXPLORATION COMPLETED!")
    logger.info("- All figures saved to: %s", out_dir)

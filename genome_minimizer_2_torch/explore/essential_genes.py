"""Essential-gene position extraction (``--mode preprocess``): the port's
copy of the JAX package's ``explore/essential_genes.py``.

Maps literature essential-gene names to dataset column indices and pickles a
``{gene_name: [column positions]}`` dict, which sampling's essential-gene
counting reads. Matching semantics (the reference's
extract_essential_genes.py):

- ``extract_prefix``: the leading ``[a-zA-Z0-9]+`` of a gene name;
- the position map groups EVERY dataset column index under its prefix;
- direct matches: essential names present verbatim as dataset columns;
  absent names are then matched as prefixes (``startswith``);
- the final dict maps each matched essential name (direct or family) to the
  prefix map's position list; a summary text file lists the mappings.
"""

from __future__ import annotations

import logging
import pickle
import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import pandas as pd

from ..data.dataset import load_and_validate_data
from ..utils import directories

logger = logging.getLogger(__name__)

KNOWN_GENE_PREFIXES = [
    "msbA", "fabG", "lolD", "topA", "metG", "fbaA",
    "higA", "lptB", "ssb", "lptG", "dnaC",
]

_PREFIX_RE = re.compile(r"([a-zA-Z0-9]+)")


def extract_prefix(gene: str) -> str:
    """Leading alphanumeric run of a gene name."""
    match = _PREFIX_RE.match(gene)
    return match.group(1) if match else gene


def clean_gene_name(gene):
    """Strip/validate names, dropping NaN/None."""
    if gene is None or (isinstance(gene, float) and np.isnan(gene)):
        return None
    gene = str(gene).strip()
    return gene if gene else None


class EssentialGeneProcessor:
    """Maps literature essential genes to dataset positions."""

    def __init__(self, dataset_path: str | None = None,
                 phylogroups_path: str | None = None,
                 essential_genes_path: str | None = None,
                 output_dir: str | Path | None = None):
        self.dataset_path = dataset_path
        self.phylogroups_path = phylogroups_path
        self.essential_genes_path = (
            essential_genes_path or directories.paper_essential_genes())
        self.output_dir = Path(
            output_dir or (directories.project_root() / directories.ESSENTIAL_GENES_DIR))
        self.all_genes: pd.Index | None = None
        self.essential_genes_array: np.ndarray | None = None
        self.gene_position_mapping: Dict[str, List[int]] = {}

    # -- stages -----------------------------------------------------------

    def load_datasets(self):
        logger.info("Loading datasets...")
        _, merged_df, _ = load_and_validate_data(self.dataset_path,
                                                 self.phylogroups_path)
        self.all_genes = merged_df.columns[:-1]
        logger.info("Total genes in dataset: %d", len(self.all_genes))
        essential_genes_df = pd.read_csv(self.essential_genes_path)
        self.essential_genes_array = essential_genes_df.values.flatten()
        logger.info("Essential genes from literature: %d",
                    len(self.essential_genes_array))

    def create_gene_position_mapping(self) -> Dict[str, List[int]]:
        """prefix -> [column indices], one pass over all genes."""
        gene_positions: Dict[str, List[int]] = defaultdict(list)
        for idx, gene in enumerate(self.all_genes):
            gene_positions[extract_prefix(str(gene))].append(idx)
        self.gene_position_mapping = dict(gene_positions)
        logger.info("Mapped %d unique gene prefixes", len(self.gene_position_mapping))
        return self.gene_position_mapping

    def identify_gene_matches(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(present, absent, variant-matched) essential genes."""
        all_genes_set = set(map(str, self.all_genes))
        direct_mask = np.array(
            [str(g) in all_genes_set for g in self.essential_genes_array])
        present_genes = self.essential_genes_array[direct_mask]
        absent_genes = self.essential_genes_array[~direct_mask]
        present_set = set(map(str, present_genes))
        matched_variants = []
        # startswith scan == a regex match of f"^{escape(name)}" over all
        # columns
        for gene in absent_genes:
            clean = clean_gene_name(gene)
            if clean is None:
                continue
            for col in map(str, self.all_genes):
                if col.startswith(clean) and col not in present_set:
                    matched_variants.append(col)
        return present_genes, absent_genes, np.array(matched_variants, dtype=object)

    def create_final_essential_genes_mapping(self) -> Dict[str, List[int]]:
        """{essential gene -> positions}."""
        present_genes, absent_genes, _ = self.identify_gene_matches()
        essential_gene_positions: Dict[str, List[int]] = {}
        for gene in map(str, present_genes):
            if gene in self.gene_position_mapping:
                essential_gene_positions[gene] = self.gene_position_mapping[gene]
        for gene_family in map(str, absent_genes):
            if gene_family in self.gene_position_mapping:
                essential_gene_positions[gene_family] = \
                    self.gene_position_mapping[gene_family]
        total = sum(len(p) for p in essential_gene_positions.values())
        singles = sum(1 for p in essential_gene_positions.values() if len(p) == 1)
        logger.info("Final essential gene mapping: %d genes",
                    len(essential_gene_positions))
        logger.info("Total positions mapped: %d", total)
        logger.info("Single-position genes: %d", singles)
        logger.info("Multi-position genes: %d",
                    len(essential_gene_positions) - singles)
        return essential_gene_positions

    def validate_essential_genes_mapping(
            self, essential_positions: Dict[str, List[int]]) -> bool:
        """Sanity checks of the positions and the coverage."""
        max_position = len(self.all_genes) - 1
        invalid = [(g, p) for g, ps in essential_positions.items()
                   for p in ps if p < 0 or p > max_position]
        if invalid:
            logger.error("Invalid positions found: %s...", invalid[:5])
            return False
        coverage = len(essential_positions) / max(len(self.essential_genes_array), 1)
        logger.info("Essential gene coverage: %d/%d (%.1f%%)",
                    len(essential_positions), len(self.essential_genes_array),
                    coverage * 100)
        if coverage < 0.5:
            logger.warning("Low essential gene coverage - check gene name matching")
        total_positions = sum(len(p) for p in essential_positions.values())
        if total_positions > len(self.all_genes):
            logger.error("More essential gene positions than total genes")
            return False
        return True

    def save_essential_genes_mapping(self, essential_positions: Dict[str, List[int]]):
        """Pickle + human-readable summary."""
        self.output_dir.mkdir(parents=True, exist_ok=True)
        pickle_file = self.output_dir / "essential_gene_positions.pkl"
        with open(pickle_file, "wb") as f:
            pickle.dump(essential_positions, f)
        logger.info("Essential gene positions saved to: %s", pickle_file)

        summary_path = self.output_dir / "essential_gene_positions_summary.txt"
        with open(summary_path, "w") as f:
            f.write("Essential Gene Positions Summary\n")
            f.write("=" * 80 + "\n")
            f.write(f"Total essential genes mapped: {len(essential_positions)}\n")
            f.write(f"Total positions: "
                    f"{sum(len(p) for p in essential_positions.values())}\n\n")
            f.write("Gene Mappings:\n")
            f.write("=" * 80 + "\n")
            for gene, positions in sorted(essential_positions.items()):
                if len(positions) == 1:
                    f.write(f"{gene}: position {positions[0]}\n")
                else:
                    f.write(f"{gene}: positions {positions}\n")
        logger.info("Summary saved to: %s", summary_path)

    def process(self) -> Dict[str, List[int]]:
        """Load, map, validate and save."""
        self.load_datasets()
        self.create_gene_position_mapping()
        essential_positions = self.create_final_essential_genes_mapping()
        if not self.validate_essential_genes_mapping(essential_positions):
            raise ValueError("Essential genes mapping validation failed")
        self.save_essential_genes_mapping(essential_positions)
        logger.info("✓ Essential genes processing completed successfully!")
        return essential_positions


def print_processing_summary(essential_positions: Dict[str, List[int]]):
    """Counts of mapped genes and positions, and the largest families."""
    print("\n" + "=" * 80)
    print("ESSENTIAL GENES PROCESSING SUMMARY")
    print("=" * 80)
    total_genes = len(essential_positions)
    total_positions = sum(len(p) for p in essential_positions.values())
    single = sum(1 for p in essential_positions.values() if len(p) == 1)
    print("Processing Results:")
    print(f"- Essential genes mapped: {total_genes}")
    print(f"- Total dataset positions: {total_positions}")
    print(f"- Single-position genes: {single}")
    print(f"- Multi-position genes: {total_genes - single}")
    multi = sorted(((g, len(p)) for g, p in essential_positions.items() if len(p) > 1),
                   key=lambda x: x[1], reverse=True)
    if multi:
        print("\nMulti-position genes (gene families):")
        for gene, count in multi[:10]:
            print(f"- {gene}: {count} positions")
        if len(multi) > 10:
            print(f"- ... and {len(multi) - 10} more")
    print("=" * 80 + "\n")


def main():
    processor = EssentialGeneProcessor()
    essential_positions = processor.process()
    print_processing_summary(essential_positions)
    return essential_positions

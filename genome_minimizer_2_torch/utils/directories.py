"""Path configuration for datasets and generated artifacts: the port's own
copy of the JAX package's ``utils/directories.py`` (same layout, same
``GM2_ROOT`` override), so both packages read one data tree.

Capability parity with the reference's path-constant module
(the upstream genome_minimizer_2 ``utils/directories.py``), with two
deliberate fixes:

- the project root is overridable via the ``GM2_ROOT`` environment variable so
  the framework can run against any data directory (the reference hard-codes a
  path three levels above the module);
- ``ESSENTIAL_GENES_POSITIONS`` points at the directory the preprocessor
  actually writes to (the reference checks ``src/genome_minimizer_2/data/...``
  but writes ``data/essential_genes/...`` — extract_essential_genes.py:61-62 vs
  directories.py:20 — so its skip-if-exists check never fires).
"""

from __future__ import annotations

import os
from pathlib import Path


def project_root() -> Path:
    """Root directory for data/model artifacts (env-overridable)."""
    env = os.environ.get("GM2_ROOT")
    if env:
        return Path(env).absolute()
    # package lives at <root>/genome_minimizer_2_torch/utils/directories.py
    return Path(__file__).resolve().parents[2]


# Raw data (relative to project root)
TEN_K_DATASET = "data/F4_complete_presence_absence.csv"
TEN_K_DATASET_PHYLOGROUPS = "data/accessionID_phylogroup_BD.csv"
PAPER_ESSENTIAL_GENES = "data/essential_genes.csv"
WILD_TYPE_SEQUENCE = "data/wild_type_sequence.gb"
SAMPLES_BINARY = "data/data_full_validated.npy"

# Generated data (relative to project root)
ESSENTIAL_GENES_DIR = "data/essential_genes"
ESSENTIAL_GENES_POSITIONS = "data/essential_genes/essential_gene_positions.pkl"
MINIMIZED_GENOME = "data/minimized_genome.fasta"


def get_full_path(relative_path: str) -> str:
    """Convert a project-root-relative path to an absolute path."""
    return str(project_root() / relative_path)


def ten_k_dataset() -> str:
    return get_full_path(TEN_K_DATASET)


def ten_k_dataset_phylogroups() -> str:
    return get_full_path(TEN_K_DATASET_PHYLOGROUPS)


def paper_essential_genes() -> str:
    return get_full_path(PAPER_ESSENTIAL_GENES)


def wild_type_sequence() -> str:
    return get_full_path(WILD_TYPE_SEQUENCE)


def essential_genes_positions() -> str:
    return get_full_path(ESSENTIAL_GENES_POSITIONS)


def models_dir() -> str:
    return get_full_path("models")


def minimized_genomes_dir() -> str:
    return get_full_path("minimized_genomes")

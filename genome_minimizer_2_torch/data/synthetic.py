"""Synthetic dataset generation: the port's copy of the JAX package's
``data/synthetic.py`` (numpy + pandas), plus :func:`write_presence_absence_fast`
and :func:`presence_absence_matrix` for full-width datasets.

The real inputs (10k x 55k presence/absence CSV, phylogroup table, essential
genes list, E. coli K-12 GenBank) are not distributed with either repo. This
module fabricates structurally identical miniatures — same file formats, same
quirks (a 'Lineage' row, '# gene' header variant, multi-interval gene
features) — for tests, quick-starts and benchmarks. Shapes default tiny; pass
``n_samples/n_genes`` for benchmark-scale data.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import pandas as pd

PHYLOGROUPS = ["A", "B1", "B2", "D", "E", "F"]
_BASES = np.array(list("acgt"))


def make_gene_names(n_genes: int, rng: np.random.RandomState) -> list[str]:
    """Gene names resembling the dataset's: lowercase stem + optional suffix.

    Includes duplicate-prefix families (e.g. thrA_1, thrA_2) so essential-gene
    prefix matching and multi-position consolidation paths are exercised.
    """
    alphabet = "abcdefghijklmnopqrstuvwxyz"
    names: list[str] = []
    seen: set[str] = set()
    i = 0
    while len(names) < n_genes:
        stem = "".join(rng.choice(list(alphabet), size=3)) + alphabet[i % 26].upper()
        i += 1
        if stem in seen:
            continue
        seen.add(stem)
        if rng.rand() < 0.2 and len(names) + 2 <= n_genes:
            names.append(f"{stem}_1")
            names.append(f"{stem}_2")
        else:
            names.append(stem)
    return names[:n_genes]


def write_presence_absence_csv(
    path: str | os.PathLike,
    n_samples: int = 40,
    n_genes: int = 120,
    seed: int = 0,
) -> tuple[list[str], list[str]]:
    """Write a genes x samples CSV shaped like F4_complete_presence_absence.csv.

    Layout (per the reference's expectations — data_exploration.py:69-80):
    index = gene names plus a 'Lineage' row, columns = sample IDs (these get
    upper-cased by the loader), values = 0/1 presence.
    Returns (gene_names, sample_ids).
    """
    rng = np.random.RandomState(seed)
    genes = make_gene_names(n_genes, rng)
    samples = [f"sample_{i:04d}" for i in range(n_samples)]
    # Core genes present almost everywhere; accessory genes variable.
    core = rng.rand(n_genes) < 0.3
    p = np.where(core, 0.97, rng.uniform(0.05, 0.9, size=n_genes))
    mat = (rng.rand(n_genes, n_samples) < p[:, None]).astype(int)
    df = pd.DataFrame(mat, index=genes, columns=samples)
    lineage = pd.DataFrame(
        [rng.randint(1, 20, size=n_samples)], index=["Lineage"], columns=samples
    )
    out = pd.concat([lineage, df])
    out.to_csv(path)
    return genes, samples


def write_phylogroups_csv(
    path: str | os.PathLike, sample_ids: list[str], seed: int = 0
) -> pd.DataFrame:
    """Phylogroup table keyed by upper-cased sample ID (column 'ID')."""
    rng = np.random.RandomState(seed + 1)
    ids = [s.upper() for s in sample_ids]
    df = pd.DataFrame(
        {"ID": ids, "Phylogroup": rng.choice(PHYLOGROUPS, size=len(ids))}
    )
    df.to_csv(path, index=False)
    return df


def write_essential_genes_csv(
    path: str | os.PathLike, genes: list[str], n_essential: int = 12, seed: int = 0,
    header: str = "# gene",
) -> list[str]:
    """Essential-genes list CSV; header is '# gene' like the paper's file
    (binary_converter.py:14 accepts '# gene' or 'gene').

    Picks some plain gene names and some family *prefixes* (stripping the
    _1/_2 suffix) so prefix-matching code paths are exercised.
    """
    rng = np.random.RandomState(seed + 2)
    chosen = list(rng.choice(len(genes), size=min(n_essential, len(genes)), replace=False))
    out: list[str] = []
    for idx in chosen:
        g = genes[idx]
        if "_" in g and rng.rand() < 0.5:
            g = g.split("_")[0]  # family prefix not literally in the dataset
        if g not in out:
            out.append(g)
    pd.DataFrame({header: out}).to_csv(path, index=False)
    return out


def genbank_spec(
    genes: list[str],
    genome_length: int = 5000,
    seed: int = 0,
) -> dict:
    """Ground-truth spec for a synthetic GenBank record.

    Returns ``{"seq": lowercase acgt str, "features": [(loc_str, name_or_None,
    start0, end0, locus_tag_or_None), ...]}`` where (start0, end0) is the
    0-based half-open OVERALL span of the location — exactly what BioPython
    exposes as ``feature.location.start/.end`` for simple, complement() and
    join() locations. Tests use this spec to construct SeqRecord objects
    directly (tests/_bio_shim.py), so golden comparisons against the actual
    reference minimizer share only this data, none of our parsing code.
    """
    rng = np.random.RandomState(seed + 3)
    seq = "".join(rng.choice(_BASES, size=genome_length))

    features: list[list] = []  # [loc_str, name|None, start0, end0, tag|None]
    pos = 10
    gi = 0
    while pos + 120 < genome_length and gi < len(genes):
        length = int(rng.randint(40, 120))
        start, end = pos + 1, pos + length  # GenBank is 1-based inclusive
        r = rng.rand()
        if r < 0.12:
            loc = f"complement({start}..{end})"
        elif r < 0.2 and end + 30 < genome_length:
            mid = start + length // 3
            loc = f"join({start}..{mid},{mid + 10}..{end})"
        else:
            loc = f"{start}..{end}"
        name = genes[gi] if rng.rand() > 0.05 else None  # some unnamed genes
        features.append([loc, name, start - 1, end, None])
        gi += 1
        pos = end + int(rng.randint(5, 40))
    # locus tags draw in a second pass (same RNG order as the original
    # writer, which drew them while emitting lines) — byte-stable output
    for f in features:
        if f[1] is not None:
            f[4] = f"b{rng.randint(0, 9999):04d}"
    return {"seq": seq, "features": [tuple(f) for f in features]}


def write_genbank(
    path: str | os.PathLike,
    genes: list[str],
    genome_length: int = 5000,
    seed: int = 0,
    organism: str = "Escherichia coli str. K-12 substr. MG1655",
) -> str:
    """Write a minimal single-record GenBank file with `gene` features.

    Features cover a subset of ``genes`` at random non-overlapping-ish
    intervals; a few use complement() and join() locations, and a couple of
    features carry no /gene qualifier (the reference then uses "" —
    minimizer_2.py:61). Returns the genome sequence string (lowercase acgt,
    as BioPython would parse from the ORIGIN block).
    """
    spec = genbank_spec(genes, genome_length, seed)
    return write_genbank_from_spec(path, spec, organism)


def write_genbank_from_spec(
    path: str | os.PathLike,
    spec: dict,
    organism: str = "Escherichia coli str. K-12 substr. MG1655",
) -> str:
    """Emit the GenBank flat file for a prebuilt spec (genbank_spec).
    Byte-layout identical to what write_genbank always produced."""
    seq = spec["seq"]
    genome_length = len(seq)

    lines = []
    lines.append(
        f"LOCUS       SYNTH001             {genome_length} bp    DNA     circular BCT 01-JAN-2024"
    )
    lines.append("DEFINITION  Synthetic minimal test genome.")
    lines.append("ACCESSION   SYNTH001")
    lines.append("VERSION     SYNTH001.1")
    lines.append("SOURCE      synthetic")
    lines.append(f"  ORGANISM  {organism}")
    lines.append("FEATURES             Location/Qualifiers")
    lines.append(f"     source          1..{genome_length}")
    lines.append(f'                     /organism="{organism}"')
    for loc, name, _s0, _e0, tag in spec["features"]:
        lines.append(f"     gene            {loc}")
        if name is not None:
            lines.append(f'                     /gene="{name}"')
            lines.append(f'                     /locus_tag="{tag}"')
    lines.append("ORIGIN")
    for i in range(0, genome_length, 60):
        chunk = seq[i : i + 60]
        groups = " ".join(chunk[j : j + 10] for j in range(0, len(chunk), 10))
        lines.append(f"{i + 1:>9} {groups}")
    lines.append("//")
    Path(path).write_text("\n".join(lines) + "\n")
    return seq


def make_dataset_root(
    root: str | os.PathLike,
    n_samples: int = 40,
    n_genes: int = 120,
    genome_length: int = 5000,
    seed: int = 0,
) -> dict[str, str]:
    """Create a full synthetic data/ tree matching utils.directories layout.

    Point GM2_ROOT at ``root`` and every pipeline mode runs end-to-end.
    """
    root = Path(root)
    (root / "data").mkdir(parents=True, exist_ok=True)
    pa = root / "data" / "F4_complete_presence_absence.csv"
    ph = root / "data" / "accessionID_phylogroup_BD.csv"
    eg = root / "data" / "essential_genes.csv"
    gb = root / "data" / "wild_type_sequence.gb"
    genes, samples = write_presence_absence_csv(pa, n_samples, n_genes, seed)
    write_phylogroups_csv(ph, samples, seed)
    write_essential_genes_csv(eg, genes, max(4, n_genes // 10), seed)
    write_genbank(gb, genes, genome_length, seed)
    return {
        "root": str(root),
        "presence_absence": str(pa),
        "phylogroups": str(ph),
        "essential_genes": str(eg),
        "genbank": str(gb),
    }


def _presence_absence_blocks(n_samples: int, n_genes: int, seed: int,
                             chunk_rows: int):
    """The full-width gene model's draws: yields the lineage row, then
    (lo, hi, bits) for each block of gene rows, bits (hi - lo, n_samples)
    bool. One stream for the CSV writer and the in-memory matrix."""
    rng = np.random.RandomState(seed)
    core = rng.rand(n_genes) < 0.3
    p = np.where(core, 0.97, rng.uniform(0.05, 0.9, size=n_genes))
    yield rng.randint(1, 20, size=n_samples)
    for lo in range(0, n_genes, chunk_rows):
        hi = min(lo + chunk_rows, n_genes)
        yield lo, hi, rng.rand(hi - lo, n_samples) < p[lo:hi, None]


def write_presence_absence_fast(
    path: str | os.PathLike,
    n_samples: int,
    n_genes: int,
    seed: int = 0,
    chunk_rows: int = 2048,
) -> tuple[list[str], list[str]]:
    """:func:`write_presence_absence_csv`'s layout and gene model (core genes
    at 0.97, accessory genes at a per-gene rate in [0.05, 0.9]) at full
    width: each block of gene rows is assembled as bytes with numpy instead
    of through pandas, so a 55,039 x 10,000 matrix takes seconds. Gene names
    are ``gene00000`` ... . Returns (gene_names, sample_ids)."""
    genes = [f"gene{i:05d}" for i in range(n_genes)]
    samples = [f"sample_{i:04d}" for i in range(n_samples)]
    blocks = _presence_absence_blocks(n_samples, n_genes, seed, chunk_rows)
    lineage = next(blocks)
    with open(path, "wb") as f:
        f.write(("," + ",".join(samples) + "\n").encode())
        f.write(("Lineage," + ",".join(map(str, lineage)) + "\n").encode())
        for lo, hi, bits in blocks:
            text = np.empty((hi - lo, 2 * n_samples), np.uint8)
            text[:, 0::2] = bits.astype(np.uint8) + ord("0")
            text[:, 1::2] = ord(",")
            text[:, -1] = ord("\n")
            f.write(b"".join(genes[lo + i].encode() + b"," + row.tobytes()
                             for i, row in enumerate(text)))
    return genes, samples


def presence_absence_matrix(n_samples: int, n_genes: int, seed: int = 0,
                            chunk_rows: int = 2048) -> np.ndarray:
    """The matrix :func:`write_presence_absence_fast` writes, in memory:
    (n_samples, n_genes) uint8, samples in rows as ``load_matrix`` reads
    them, without the CSV."""
    out = np.empty((n_samples, n_genes), np.uint8)
    blocks = _presence_absence_blocks(n_samples, n_genes, seed, chunk_rows)
    next(blocks)
    for lo, hi, bits in blocks:
        out[:, lo:hi] = bits.T
    return out

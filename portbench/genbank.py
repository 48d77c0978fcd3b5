"""The wild-type genome, the matrix's column names and the essential genes
a pipeline cell is given, drawn from ``--seed`` with the traffic's
``genome`` parameters, and the GenBank flat file the program parses.

The genome has E. coli K-12 MG1655's published length and number of gene
features, placed in order without overlap and covering the stated share of
the sequence; the features' lengths and the gaps between them are drawn,
then scaled so that every seed covers exactly the same number of bases.
Feature names are drawn from the matrix's distinct column names, one
feature in seven lies on the complement strand, and a share of the columns
repeats an earlier column's name (the converter keeps the first). The
program reads the file; the reference reads the arrays it was written from,
so a fault in the program's parser shows as a record that differs.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

LOWER = np.frombuffer(b"acgt", np.uint8)
LINE = 60  # bases on an ORIGIN line, in groups of 10


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), stream])


@dataclasses.dataclass
class Genome:
    seq: np.ndarray        # (L,) uint8, upper-case ACGT, as the parser returns it
    names: list            # (F,) gene names, in order of position
    starts: np.ndarray     # (F,) int64, 0-based inclusive
    ends: np.ndarray       # (F,) int64, 0-based exclusive
    complement: np.ndarray  # (F,) bool


def column_names(seed: int, genes: int, duplicate_share: float) -> list[str]:
    """``genes`` column names; ``round(duplicate_share * genes)`` columns,
    drawn, carry the name of a column drawn before them."""
    rng = _rng(seed, 30)
    names = [f"gene{i:05d}" for i in range(genes)]
    dups = np.sort(rng.choice(np.arange(1, genes), round(duplicate_share * genes),
                              replace=False))
    for p in dups:
        names[p] = names[int(rng.integers(p))]
    return names


def _split(rng, total: int, weights: np.ndarray) -> np.ndarray:
    """Whole numbers in proportion to ``weights`` that add up to ``total``."""
    out = np.floor(weights * total / weights.sum()).astype(np.int64)
    out[: total - int(out.sum())] += 1
    return out


def genome(seed: int, columns: list[str], p: dict) -> Genome:
    """The sequence and its ``p["features"]`` gene features: lengths drawn
    from U(feature_min, feature_max) and scaled to cover ``round(coverage *
    length)`` bases; gaps drawn uniform and scaled to the rest, at least one
    base between two features."""
    rng = _rng(seed, 31)
    L, F = p["length"], p["features"]
    covered = round(p["coverage"] * L)
    lens = _split(rng, covered, rng.integers(p["feature_min"], p["feature_max"] + 1,
                                             F).astype(np.float64))
    gaps = _split(rng, L - covered - (F - 1), rng.random(F + 1))
    gaps[1:F] += 1
    starts = np.cumsum(gaps[:F]) + np.concatenate([[0], np.cumsum(lens[:-1])])
    distinct = list(dict.fromkeys(columns))
    names = [distinct[i] for i in rng.choice(len(distinct), F, replace=False)]
    seq = LOWER[rng.integers(0, 4, L)] - np.uint8(32)
    return Genome(seq=seq, names=names, starts=starts.astype(np.int64),
                  ends=(starts + lens).astype(np.int64),
                  complement=np.arange(F) % p["complement_every"] == 0)


def essential_set(seed: int, g: Genome, count: int) -> set[str]:
    """``count`` essential genes, drawn among the genome's features."""
    rng = _rng(seed, 32)
    return {g.names[i] for i in rng.choice(len(g.names), count, replace=False)}


def write(path: Path, g: Genome) -> Path:
    """``g`` as a GenBank flat file: LOCUS, one ``gene`` feature with its
    ``/gene`` name each, and the sequence in lower case under ORIGIN."""
    L = g.seq.size
    lines = [f"LOCUS       PORTBENCH {L} bp    DNA     circular BCT 01-JAN-2024",
             "FEATURES             Location/Qualifiers",
             f"     source          1..{L}"]
    for name, s, e, c in zip(g.names, g.starts, g.ends, g.complement):
        loc = f"{s + 1}..{e}"
        lines.append(f"     gene            {f'complement({loc})' if c else loc}")
        lines.append(f'                     /gene="{name}"')
    lines.append("ORIGIN")
    text = (g.seq + np.uint8(32)).tobytes().decode("ascii")
    for i in range(0, L, LINE):
        part = text[i:i + LINE]
        lines.append(f"{i + 1:>9} " + " ".join(part[j:j + 10]
                                               for j in range(0, len(part), 10)))
    lines.append("//")
    path.write_text("\n".join(lines) + "\n")
    return path

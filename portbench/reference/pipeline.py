"""The reference's account of a pipeline's FASTA records, in plain numpy:
from a genome's presence bits (one per matrix column) to its minimized
record, with the semantics of the JAX package's converter and minimizer
(``genome/converter.py``, ``genome/minimizer.py::removal_mask`` and
``minimize``) worked out again:

- a column name stands for its first occurrence among the columns;
- a gene feature is kept iff its name is a column whose bit is set, or the
  gene is essential;
- the bases of every feature not kept, the union of their [start, end)
  intervals cut at the sequence's end, are cut out of the sequence;
- the record is ``>Minimized_E_coli_K12_MG1655_{i+1}\\n{seq}\\n`` for the
  genome of global index i.

Departures: the union is taken by merging the intervals sorted by start
where the JAX package adds +1 and -1 at their ends and takes a running sum.
The two agree for intervals with start < end, which a GenBank location
always gives (the parser takes the least and the greatest of its
coordinates); a reversed interval would subtract from the JAX package's sum
and is nothing here.
"""

from __future__ import annotations

import numpy as np

PREFIX = b">Minimized_E_coli_K12_MG1655_"


def feature_columns(columns: list, names: list) -> np.ndarray:
    """For each feature, the index of the first column that carries its
    name, -1 where no column does."""
    first: dict = {}
    for j, c in enumerate(columns):
        first.setdefault(c, j)
    return np.array([first.get(n, -1) for n in names], np.int64)


def kept(bits: np.ndarray, cols: np.ndarray, essential: np.ndarray) -> np.ndarray:
    """(F,) bool of one genome: kept iff its column's bit (``bits``, 0/1 per
    column) is set or the gene is essential."""
    present = np.zeros(cols.size, bool)
    has = cols >= 0
    present[has] = bits[cols[has]] != 0
    return present | essential


def minimize(seq: np.ndarray, starts: np.ndarray, ends: np.ndarray,
             dropped: np.ndarray) -> bytes:
    """``seq`` with the union of the dropped features' intervals cut out."""
    L = seq.size
    pieces, pos = [], 0
    order = np.argsort(starts[dropped], kind="stable")
    for s, e in zip(starts[dropped][order], ends[dropped][order]):
        s, e = min(int(s), L), min(int(e), L)
        if e <= s:
            continue
        if s > pos:
            pieces.append(seq[pos:s])
        pos = max(pos, e)
    pieces.append(seq[pos:])
    return np.concatenate(pieces).tobytes()


def record(index: int, sequence: bytes) -> bytes:
    return PREFIX + str(index + 1).encode() + b"\n" + sequence + b"\n"


def header_lines(model_name: str, genomes: int) -> bytes:
    """The first two of the stream's three comment lines (the third holds
    the time of the run)."""
    return (f"# Minimized genomes generated using model: {model_name}\n"
            f"# Total genomes: {genomes}\n").encode()


def records(bits: np.ndarray, indices, seq: np.ndarray, starts: np.ndarray,
            ends: np.ndarray, cols: np.ndarray, essential: np.ndarray) -> list:
    """The records of the genomes whose bits are the rows of ``bits``
    (rows, columns) and whose global indices are ``indices``."""
    return [record(int(i), minimize(seq, starts, ends, ~kept(b, cols, essential)))
            for b, i in zip(bits, indices)]

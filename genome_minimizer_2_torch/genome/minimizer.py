"""Reference-guided genome minimization: the port's copy of the JAX
package's ``MinimizerEngine`` (``genome/minimizer.py:40-299``).

Per sample, every gene feature whose gene is neither present in the
sample's mask nor essential is removed: the union of those features'
[start, end) intervals is cut out of the wild-type sequence, and the rest is
written as one FASTA record '>Minimized_E_coli_K12_MG1655_{i+1}\\n{seq}\\n'.
The batch paths run in the native C++ core (``genome/native.py``) by
default; ``use_native=False`` selects the numpy path, which writes the same
bytes.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Sequence

import numpy as np

from .genbank import GenBankRecord, parse_genbank

SEQ_ID_PREFIX = "Minimized_E_coli_K12_MG1655"


@dataclasses.dataclass
class MinimizerEngine:
    """Preprocessed wild-type genome ready for batch minimization."""

    record: GenBankRecord
    gene_names: np.ndarray   # (F,) object
    starts: np.ndarray       # (F,) int64, 0-based inclusive
    ends: np.ndarray         # (F,) int64, 0-based exclusive
    seq_bytes: np.ndarray    # (L,) uint8

    @classmethod
    def from_genbank(cls, path: str | Path) -> "MinimizerEngine":
        return cls.from_record(parse_genbank(path))

    @classmethod
    def from_record(cls, record: GenBankRecord) -> "MinimizerEngine":
        names, starts, ends = record.gene_arrays()
        seq_bytes = np.frombuffer(record.seq.encode("ascii"), dtype=np.uint8)
        return cls(record=record, gene_names=names, starts=starts, ends=ends,
                   seq_bytes=seq_bytes)

    @property
    def original_length(self) -> int:
        return len(self.seq_bytes)

    # -- one sample -----------------------------------------------------------

    def removal_mask(self, needed_genes: Sequence[str]) -> np.ndarray:
        """(L,) bool — True where the base belongs to a feature whose gene
        name is NOT in ``needed_genes`` (union of their [start, end))."""
        needed = set(needed_genes)
        non_essential = np.fromiter(
            (name not in needed for name in self.gene_names),
            dtype=bool, count=len(self.gene_names),
        )
        return self._interval_union(non_essential)

    def _interval_union(self, selected: np.ndarray) -> np.ndarray:
        L = self.original_length
        diff = np.zeros(L + 1, dtype=np.int32)
        np.add.at(diff, np.minimum(self.starts[selected], L), 1)
        np.add.at(diff, np.minimum(self.ends[selected], L), -1)
        return np.cumsum(diff[:-1]) > 0

    def minimize(self, needed_genes: Sequence[str]) -> str:
        """Minimized genome string for one sample."""
        keep = ~self.removal_mask(needed_genes)
        return self.seq_bytes[keep].tobytes().decode("ascii")

    # -- converter lookups ----------------------------------------------------

    def feature_lookup(self, cols: Sequence[str], essential_set
                       ) -> tuple[np.ndarray, np.ndarray]:
        """Per feature: the dataset-column index of its gene name (-1 if the
        name is not a column) and whether the name is essential. Feature f
        is kept iff mask[col_idx[f]] or essential[f]."""
        col_pos = {str(c): i for i, c in enumerate(cols)}
        col_idx = np.array([col_pos.get(str(n), -1) for n in self.gene_names],
                           np.int64)
        ess = np.array([str(n) in essential_set for n in self.gene_names], bool)
        return col_idx, ess

    def feature_lookup_packed(self, cols: Sequence[str], keep_mask: np.ndarray,
                              essential_set) -> tuple[np.ndarray, np.ndarray]:
        """feature_lookup in the ORIGINAL (pre-dedupe) column space of the
        sampler's packed masks: ``cols`` are the deduped names, ``keep_mask``
        the dedupe keep-flags. Duplicate names resolve to their first
        occurrence."""
        col_idx, ess = self.feature_lookup(cols, essential_set)
        orig_pos = np.nonzero(np.asarray(keep_mask))[0].astype(np.int64)
        col_idx = np.where(col_idx >= 0, orig_pos[np.maximum(col_idx, 0)], -1)
        return col_idx, ess

    def drop_masks_from_binary(self, binary: np.ndarray, col_idx: np.ndarray,
                               ess: np.ndarray) -> np.ndarray:
        """(n, F) uint8 drop masks from (n, n_cols) binary presence masks."""
        binary = np.asarray(binary, bool)
        padded = np.concatenate(
            [binary, np.zeros((binary.shape[0], 1), bool)], axis=1)
        present = padded[:, col_idx]  # col_idx == -1 -> the padded False col
        return (~(present | ess[None, :])).astype(np.uint8)

    # -- batches to FASTA -----------------------------------------------------

    def minimize_packed_to_fasta(self, packed: np.ndarray, col_idx: np.ndarray,
                                 ess: np.ndarray, path: str,
                                 start_index: int = 0, append: bool = False,
                                 use_native: bool = True, n_threads: int = 0,
                                 write_base: int | None = None) -> np.ndarray:
        """FASTA directly from PACKED presence bitmasks (uint8, little bit
        order over the original dataset columns — the sampler's format).
        Returns the minimized lengths."""
        packed = np.ascontiguousarray(packed, np.uint8)
        if use_native:
            from . import native

            return native.minimize_packed_to_fasta(
                self.seq_bytes, self.starts, self.ends, packed,
                col_idx, ess, path, SEQ_ID_PREFIX,
                start_index=start_index, append=append, n_threads=n_threads,
                write_base=write_base)
        bits = np.unpackbits(packed, axis=1, bitorder="little")
        drop = self.drop_masks_from_binary(bits, col_idx, np.asarray(ess, bool))
        return self.minimize_drop_to_fasta(drop, path, start_index=start_index,
                                           append=append, use_native=False,
                                           write_base=write_base)

    @staticmethod
    def record_bytes(lens: np.ndarray, start_index: int = 0) -> int:
        """Exact byte size of the records a ``minimize_*_to_fasta`` batch
        writes: '>' + prefix + '_' + str(idx+1) + '\\n' + seq + '\\n' per
        record. The pipeline advances its write offset with this and checks
        it against the file size after every chunk."""
        lens = np.asarray(lens)
        ids = sum(len(str(start_index + j + 1)) for j in range(lens.size))
        return int(lens.sum()) + lens.size * (len(SEQ_ID_PREFIX) + 4) + ids

    def minimize_drop_to_fasta(self, drop: np.ndarray, path: str,
                               start_index: int = 0, append: bool = False,
                               use_native: bool = True, n_threads: int = 0,
                               write_base: int | None = None) -> np.ndarray:
        """FASTA from (n, F) drop masks; returns minimized lengths.

        ``write_base``: write the batch at this byte offset instead of
        append/fresh semantics — the streaming pipeline's in-place rewrite;
        the caller truncates the file at stream end."""
        drop = np.ascontiguousarray(drop, np.uint8)
        if use_native:
            from . import native

            return native.minimize_to_fasta(
                self.seq_bytes, self.starts, self.ends, drop, path,
                SEQ_ID_PREFIX, start_index=start_index, append=append,
                n_threads=n_threads, write_base=write_base)
        lens = np.zeros(drop.shape[0], np.int64)
        if write_base is not None:
            if not os.path.exists(path):
                open(path, "wb").close()
            out = open(path, "r+b")
            out.seek(int(write_base))
        else:
            out = open(path, "ab" if append else "wb")
        with out:
            for i in range(drop.shape[0]):
                keep = ~self._interval_union(drop[i].astype(bool))
                seq = self.seq_bytes[keep].tobytes()
                lens[i] = len(seq)
                out.write(f">{SEQ_ID_PREFIX}_{start_index + i + 1}\n".encode())
                out.write(seq)
                out.write(b"\n")
        return lens

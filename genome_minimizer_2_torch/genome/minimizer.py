"""Reference-guided genome minimization: the port's copy of the JAX
package's ``genome/minimizer.py`` (``MinimizerEngine``, the
``GenomeMinimiser`` facade, the duplicate analysis and summary report, and
the batch runners of ``--mode minimizer``).

Per sample, every gene feature whose gene is neither present in the
sample's mask nor essential is removed: the union of those features'
[start, end) intervals is cut out of the wild-type sequence, and the rest is
written as one FASTA record '>Minimized_E_coli_K12_MG1655_{i+1}\\n{seq}\\n'.
The batch paths run in the native C++ core (``genome/native.py``) by
default; ``use_native=False`` selects the numpy path, which writes the same
bytes. ``process_sharded`` splits the sample axis over processes
(torch.distributed ranks) and rank 0 merges the shards in rank order.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import shutil
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

from .genbank import GenBankRecord, parse_genbank

logger = logging.getLogger(__name__)

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

    def num_removed_features(self, needed_genes: Sequence[str]) -> int:
        needed = set(needed_genes)
        return int(sum(name not in needed for name in self.gene_names))

    def minimize(self, needed_genes: Sequence[str]) -> str:
        """Minimized genome string for one sample."""
        keep = ~self.removal_mask(needed_genes)
        return self.seq_bytes[keep].tobytes().decode("ascii")

    # -- gene lists -----------------------------------------------------------

    def drop_masks(self, gene_lists: Sequence[Sequence[str]]) -> np.ndarray:
        """(n_samples, F) uint8 — 1 where the feature's gene is NOT needed.
        Feature names are factorized once; a sample then costs O(|needed|)
        dictionary lookups."""
        uniq_names, feat_uid = np.unique(self.gene_names.astype(str),
                                         return_inverse=True)
        name_to_uid = {n: i for i, n in enumerate(uniq_names)}
        drop = np.empty((len(gene_lists), len(self.gene_names)), np.uint8)
        for i, needed in enumerate(gene_lists):
            present = np.zeros(len(uniq_names), bool)
            for g in needed:
                uid = name_to_uid.get(str(g))
                if uid is not None:
                    present[uid] = True
            drop[i] = ~present[feat_uid]
        return drop

    def minimize_batch(self, gene_lists: Sequence[Sequence[str]],
                       use_native: bool = True) -> List[str]:
        """Minimized genome strings of a batch of gene lists, in the native
        core (``use_native=False``: the numpy path, the same strings)."""
        if use_native:
            from . import native

            seqs = native.minimize_batch(self.seq_bytes, self.starts, self.ends,
                                         self.drop_masks(gene_lists))
            return [s.decode("ascii") for s in seqs]
        return [self.minimize(genes) for genes in gene_lists]

    def minimize_batch_to_fasta(self, gene_lists: Sequence[Sequence[str]],
                                path: str, start_index: int = 0,
                                append: bool = False,
                                use_native: bool = True) -> np.ndarray:
        """Minimize a batch of gene lists and write its FASTA records
        ('>{prefix}_{i+1}\\n{seq}\\n'); returns the minimized lengths."""
        return self.minimize_drop_to_fasta(
            self.drop_masks(gene_lists), path, start_index=start_index,
            append=append, use_native=use_native)

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


class GenomeMinimiser:
    """Per-sample facade with the reference minimizer's attribute surface:
    wildtype_sequence, original_genome_length, needed_genes,
    positions_to_remove, reduced_genome_str, get_reduction_stats(),
    save_minimized_genome()."""

    def __init__(
        self,
        record_path: str | None = None,
        needed_genes_path: str | None = None,
        idx: int = 0,
        model_name: str = "",
        record: GenBankRecord | None = None,
        engine: MinimizerEngine | None = None,
        all_needed_gene_lists: list | None = None,
        needed_genes_list: list | None = None,
    ):
        self.idx = idx
        self.model_name = model_name
        if engine is not None:
            self.engine = engine
        elif record is not None:
            self.engine = MinimizerEngine.from_record(record)
        else:
            self.engine = MinimizerEngine.from_genbank(record_path)
        self.record = self.engine.record
        self.wildtype_sequence = self.record
        self.original_genome_length = self.engine.original_length

        if needed_genes_list is not None:
            self.needed_genes = list(needed_genes_list)
        elif all_needed_gene_lists is not None:
            self.needed_genes = list(all_needed_gene_lists[idx])
        else:
            lists = np.load(needed_genes_path, allow_pickle=True).tolist()
            self.needed_genes = list(lists[idx])

        self._removal = self.engine.removal_mask(self.needed_genes)
        self.positions_to_remove = None  # lazily materialized set view
        self.reduced_genome_str = self.engine.seq_bytes[~self._removal].tobytes().decode("ascii")

    def get_positions_to_remove(self) -> set:
        if self.positions_to_remove is None:
            self.positions_to_remove = set(np.nonzero(self._removal)[0].tolist())
        return self.positions_to_remove

    def get_reduction_stats(self) -> dict:
        reduced_length = len(self.reduced_genome_str)
        return {
            "original_length": self.original_genome_length,
            "reduced_length": reduced_length,
            "reduction_percentage": (
                (self.original_genome_length - reduced_length)
                / self.original_genome_length * 100
            ),
            "genes_removed": self.engine.num_removed_features(self.needed_genes),
            "positions_removed": int(self._removal.sum()),
        }

    def save_minimized_genome(self, file_path: str):
        """Write '>{prefix}_{idx+1}\\n{seq}' (no trailing newline, as the
        reference's single-genome writer)."""
        with open(file_path, "w") as f:
            f.write(f">{SEQ_ID_PREFIX}_{self.idx + 1}\n")
            f.write(self.reduced_genome_str)


def plot_minimized_distribution(minimised_sizes_mbp, model_name: str,
                                output_dir: str):
    """Histogram of minimized genome sizes, skipped below 100 data points.
    Needs matplotlib (as ``eval/visualise.py``: the port runs without it
    until a figure is asked for)."""
    if len(minimised_sizes_mbp) < 100:
        print(f"Not enough data points ({len(minimised_sizes_mbp)}) to create "
              "meaningful plot. Need at least 100.")
        return None
    from ..eval.visualise import plt

    sizes = np.asarray(minimised_sizes_mbp)
    median = float(np.median(sizes))
    plt.figure(figsize=(4, 4))
    plt.hist(sizes, bins=10, color="dodgerblue")
    plt.xlabel("Genome size (Mbp)")
    plt.ylabel("Frequency")
    plt.title("Distribution of Minimized Genome Sizes")
    plt.axvline(median, color="b", linestyle="dashed", linewidth=2)
    handles = [
        plt.Line2D([], [], color="b", linestyle="dashed", linewidth=2,
                   label=f"Median: {median:.2f}"),
        plt.Line2D([], [], color="black", linewidth=2,
                   label=f"Min: {sizes.min():.2f}"),
        plt.Line2D([], [], color="black", linewidth=2,
                   label=f"Max: {sizes.max():.2f}"),
    ]
    plt.legend(handles=handles)
    os.makedirs(output_dir, exist_ok=True)
    out = os.path.join(output_dir,
                       f"minimised_genomes_distribution_{model_name}.pdf")
    plt.savefig(out, format="pdf", bbox_inches="tight")
    plt.close()
    return out


# ---------------------------------------------------------------------------
# Duplicate analysis and summary report
# ---------------------------------------------------------------------------

def check_sequence_duplicates(sequences_dict: Dict[str, str]) -> dict:
    """Group identical sequences; counts of unique and duplicated ones."""
    groups: Dict[str, list] = {}
    for seq_id, sequence in sequences_dict.items():
        groups.setdefault(sequence, []).append(seq_id)
    duplicates = {s: ids for s, ids in groups.items() if len(ids) > 1}
    uniques = {s: ids for s, ids in groups.items() if len(ids) == 1}
    return {
        "total_sequences": len(sequences_dict),
        "unique_sequences": len(groups),
        "duplicate_groups": len(duplicates),
        "duplicated_sequences": sum(len(ids) for ids in duplicates.values()),
        "unique_only_sequences": len(uniques),
        "duplicates_detail": duplicates,
        "compression_ratio": len(groups) / len(sequences_dict) if sequences_dict else 0,
    }


def print_duplicate_statistics(duplicate_stats: dict):
    print("\n" + "=" * 80)
    print("SEQUENCE DUPLICATION ANALYSIS")
    print("=" * 80)
    print(" Overview:")
    print(f"- Total sequences generated: {duplicate_stats['total_sequences']:,}")
    print(f"- Unique sequences: {duplicate_stats['unique_sequences']:,}")
    print(f"- Duplicate groups: {duplicate_stats['duplicate_groups']:,}")
    print(f"- Sequences with duplicates: {duplicate_stats['duplicated_sequences']:,}")
    print(f"- Truly unique sequences: {duplicate_stats['unique_only_sequences']:,}")
    print(f"- Percentage of unique sequences: {duplicate_stats['compression_ratio']:.2%}")
    if duplicate_stats["duplicate_groups"] > 0:
        dups = sorted(duplicate_stats["duplicates_detail"].items(),
                      key=lambda x: len(x[1]), reverse=True)
        print("\n Duplicate Details:")
        for i, (sequence, ids) in enumerate(dups[:10]):
            print(f"Group {i + 1}: {len(ids)} identical sequences")
            print(f"- Sequence: {sequence[:50]}{'...' if len(sequence) > 50 else ''}")
            print(f"- IDs: {', '.join(ids[:5])}{'...' if len(ids) > 5 else ''}")
            print()
        if len(dups) > 10:
            print(f"  ... and {len(dups) - 10} more duplicate groups")
    else:
        print("\n✓ No duplicate sequences found!")
    print("=" * 80)


def generate_summary_file(
    output_file: str,
    model_name: str,
    genome_path: str,
    genes_path: str,
    original_length: int,
    minimised_sizes: list,
    duplicate_stats: dict,
    output_dir: str | None = None,
):
    """Summary report beside ``output_file`` (or in ``output_dir``)."""
    output_dir = output_dir or (os.path.dirname(output_file) or ".")
    os.makedirs(output_dir, exist_ok=True)
    summary_file = os.path.join(
        output_dir, os.path.basename(output_file).replace(".fasta", "_summary.txt"))

    sizes = np.asarray(minimised_sizes, dtype=float)
    mean_size = sizes.mean() if sizes.size else 0
    median_size = float(np.median(sizes)) if sizes.size else 0
    min_size = sizes.min() if sizes.size else 0
    max_size = sizes.max() if sizes.size else 0
    std_size = sizes.std() if sizes.size else 0

    with open(summary_file, "w") as f:
        f.write("=" * 80 + "\n")
        f.write("GENOME MINIMIZATION SUMMARY REPORT\n")
        f.write("=" * 80 + "\n\n")
        f.write("GENERATION INFORMATION\n")
        f.write("-" * 40 + "\n")
        f.write(f"Model Name: {model_name}\n")
        f.write(f"Generated on: {np.datetime64('now')}\n")
        f.write(f"Output FASTA file: {os.path.basename(output_file)}\n")
        f.write(f"Summary file: {os.path.basename(summary_file)}\n\n")
        f.write("INPUT FILES\n")
        f.write("-" * 40 + "\n")
        f.write(f"Genome template: {os.path.basename(genome_path)}\n")
        f.write(f"Gene lists file: {os.path.basename(genes_path)}\n")
        f.write(f"Original genome length: {original_length:,} bp\n\n")
        f.write("PROCESSING STATISTICS\n")
        f.write("-" * 40 + "\n")
        f.write(f"Successfully processed: {len(minimised_sizes):,}\n\n")
        f.write("MINIMIZED GENOME SIZE STATISTICS\n")
        f.write("-" * 40 + "\n")
        f.write(f"Mean size: {mean_size:.3f} Mbp ({mean_size * 1e6:,.0f} bp)\n")
        f.write(f"Median size: {median_size:.3f} Mbp ({median_size * 1e6:,.0f} bp)\n")
        f.write(f"Minimum size: {min_size:.3f} Mbp ({min_size * 1e6:,.0f} bp)\n")
        f.write(f"Maximum size: {max_size:.3f} Mbp ({max_size * 1e6:,.0f} bp)\n")
        f.write(f"Standard deviation: {std_size:.3f} Mbp\n")
        f.write(f"Size range: {max_size - min_size:.3f} Mbp\n\n")
        if original_length > 0:
            f.write("GENOME REDUCTION STATISTICS\n")
            f.write("-" * 40 + "\n")
            f.write(f"Mean reduction: {((original_length - mean_size * 1e6) / original_length) * 100:.2f}%\n")
            f.write(f"Minimum reduction: {((original_length - max_size * 1e6) / original_length) * 100:.2f}% (largest genome)\n")
            f.write(f"Maximum reduction: {((original_length - min_size * 1e6) / original_length) * 100:.2f}% (smallest genome)\n\n")
        f.write("SEQUENCE DUPLICATION ANALYSIS\n")
        f.write("-" * 40 + "\n")
        f.write(f"Total sequences: {duplicate_stats['total_sequences']:,}\n")
        f.write(f"Unique sequences: {duplicate_stats['unique_sequences']:,}\n")
        f.write(f"Duplicate groups: {duplicate_stats['duplicate_groups']:,}\n")
        f.write(f"Sequences with duplicates: {duplicate_stats['duplicated_sequences']:,}\n")
        f.write(f"Uniqueness ratio: {duplicate_stats['compression_ratio']:.2%}\n")
        if minimised_sizes:
            f.write("\nSIZE DISTRIBUTION SUMMARY\n")
            f.write("-" * 40 + "\n")
            size_bins = np.linspace(min_size, max_size, 6)
            hist, _ = np.histogram(sizes, bins=size_bins)
            for i in range(len(hist)):
                pct = (hist[i] / len(minimised_sizes)) * 100
                f.write(f"{size_bins[i]:.2f} - {size_bins[i + 1]:.2f} Mbp: "
                        f"{hist[i]:,} genomes ({pct:.1f}%)\n")
    logger.info("✓ Summary file saved: %s", summary_file)
    return summary_file


# ---------------------------------------------------------------------------
# Batch runners of --mode minimizer
# ---------------------------------------------------------------------------

def _load_inputs(genome_path: str, genes_path: str):
    engine = MinimizerEngine.from_genbank(genome_path)
    all_lists = np.load(genes_path, allow_pickle=True).tolist()
    return engine, all_lists


def _fasta_header(model_name: str, n: int) -> str:
    return (f"# Minimized genomes generated using model: {model_name}\n"
            f"# Total genomes: {n}\n"
            f"# Generated on: {np.datetime64('now')}\n")


def process_multiple_genomes_single_file(
    genome_path: str,
    genes_path: str,
    model_name: str,
    output_file: str | None = None,
    verbose: bool = True,
) -> dict:
    """Minimize every gene list into ONE FASTA: three '#' comment lines,
    then '>{id}\\n{seq}\\n' records. The returned averages sample only the
    iterations the reference prints (the first 10 and every 100th), as the
    reference's accumulator does."""
    if not output_file:
        output_file = os.path.join("minimized_genomes",
                                   f"minimized_genomes_{model_name}.fasta")
    os.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)

    engine, all_lists = _load_inputs(genome_path, genes_path)
    original_length = engine.original_length
    genome_number = len(all_lists)

    tot_red_pct = 0.0
    total_length_bp = 0

    if verbose:
        for idx, needed in enumerate(all_lists):
            print(f"[{idx + 1}/{genome_number}] genes present: {len(needed)}")
    with open(output_file, "w") as out:
        out.write(_fasta_header(model_name, genome_number))
    lens = engine.minimize_batch_to_fasta(all_lists, output_file, append=True)
    sizes_mbp = [int(n) / 1e6 for n in lens]
    for idx, genome_length in enumerate(lens):
        if idx <= 9 or (idx + 1) % 100 == 0:
            red_pct = (original_length - int(genome_length)) / original_length * 100.0
            if verbose:
                print(f"  → {int(genome_length):,} bp ({red_pct:.1f}% reduction)")
            tot_red_pct += red_pct
            total_length_bp += int(genome_length)

    return {
        "genome_count": genome_number,
        "average_reduction_pct": tot_red_pct / genome_number,
        "average_length_bp": total_length_bp / genome_number,
        "sizes_mbp": sizes_mbp,
        "original_length": original_length,
    }


def process_multiple_genomes_multiple_files(
    genome_path: str,
    genes_path: str,
    model_name: str,
    output_dir: str | None = None,
    filename_template: str = "minimized_{model}_{idx:04d}.fasta",
    verbose: bool = True,
) -> dict:
    """Minimize every gene list into its own FASTA file."""
    output_dir = output_dir or "minimized_genomes"
    os.makedirs(output_dir, exist_ok=True)

    engine, all_lists = _load_inputs(genome_path, genes_path)
    original_length = engine.original_length
    genome_number = len(all_lists)

    tot_red_pct = 0.0
    total_length = 0
    if verbose:
        print(f"Writing {genome_number} individual FASTA files to: {output_dir}")
    seqs = engine.minimize_batch(all_lists)
    for idx, (needed, seq) in enumerate(zip(all_lists, seqs)):
        if verbose:
            print(f"[{idx + 1}/{genome_number}] genes present: {len(needed)}")
        genome_length = len(seq)
        red_pct = (original_length - genome_length) / original_length * 100.0
        filename = filename_template.format(model=model_name, idx=idx)
        out_path = os.path.join(output_dir, filename)
        with open(out_path, "w") as fh:
            fh.write(f">{SEQ_ID_PREFIX}_{idx + 1}\n{seq}\n")
        tot_red_pct += red_pct
        total_length += genome_length
        if verbose and (idx <= 9 or (idx + 1) % 100 == 0):
            print(f"  → saved {os.path.basename(out_path)} | {genome_length:,} bp "
                  f"({red_pct:.1f}% reduction)")

    return {
        "genome_count": genome_number,
        "average_reduction_pct": tot_red_pct / genome_number,
        "average_length_bp": total_length / genome_number,
    }


def process_sharded(
    genome_path: str,
    genes_path: str,
    model_name: str,
    output_file: str,
    process_index: int | None = None,
    process_count: int | None = None,
    merge: bool = True,
) -> str | None:
    """Single-file minimization over processes: each rank minimizes a
    contiguous shard of the sample axis into ``output_file.shard{K}``; rank
    0 merges the shards in rank order, so the merged file is byte-equal to
    one process's output. Ranks come from torch.distributed
    (``parallel/distributed.py::rank_and_world``) unless given."""
    from ..parallel import barrier
    from ..parallel.distributed import rank_and_world

    rank, world = rank_and_world()
    pi = rank if process_index is None else process_index
    pc = world if process_count is None else process_count

    engine, all_lists = _load_inputs(genome_path, genes_path)
    n = len(all_lists)
    lo = pi * n // pc
    hi = (pi + 1) * n // pc

    shard_path = barrier.shard_file(output_file, pi)
    os.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
    try:
        # retract this shard's stale sentinel before writing: a merger must
        # never read the shard mid-write as complete
        os.remove(shard_path + ".done")
    except FileNotFoundError:
        pass
    engine.minimize_batch_to_fasta(all_lists[lo:hi], shard_path, start_index=lo)
    barrier.mark_shard_done(shard_path)

    if not merge or pi != 0:
        return None
    shard_paths = barrier.wait_for_shards(output_file, pc)
    with open(output_file, "wb") as out:
        out.write(_fasta_header(model_name, n).encode())
        for sp in shard_paths:
            with open(sp, "rb") as f:
                shutil.copyfileobj(f, out, length=16 << 20)
    barrier.clear_sentinels(output_file, pc)
    return output_file

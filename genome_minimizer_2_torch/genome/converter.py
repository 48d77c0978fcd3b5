"""Binary mask -> gene-ID conversion with essential-gene backfill: the
port's copy of the JAX package's ``genome/converter.py`` (numpy + pandas).

- duplicate gene columns are dropped keeping the first occurrence,
- masks threshold at >= 0.5 (sampling thresholds strictly, > 0.5),
- per-sample gene lists are the retained column names in column order,
  saved as an object-dtype .npy,
- ``check_essential_genes`` set-unions missing essentials into each sample
  and saves the *sorted* union to ``*_with_essentials.npy``.

The streaming pipeline fuses this conversion into the native minimize
workers; ``--mode convert-samples`` runs it here, on masks saved by
``--mode sample`` in any of its formats.
"""

from __future__ import annotations

import logging
import os
from typing import List, Sequence, Tuple

import numpy as np
import pandas as pd

from ..ops.kernels import unpack_bits

logger = logging.getLogger(__name__)


def load_essential_set(essentials_csv_path: str) -> set:
    """The essential-gene set from its CSV ('# gene' or 'gene' column)."""
    essential_genes = pd.read_csv(essentials_csv_path)
    col = "# gene" if "# gene" in essential_genes.columns else "gene"
    return set(essential_genes[col].astype(str).str.strip())


def load_files(essentials_csv_path: str, ids_npy_path: str):
    """The essentials set and the gene-list array."""
    essential_set = load_essential_set(essentials_csv_path)
    id_lists = np.load(ids_npy_path, allow_pickle=True)
    return essential_set, id_lists


def dedupe_columns(cols: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Drop duplicate gene names keeping first occurrences.

    Returns (deduped_cols, keep_mask)."""
    cols = np.asarray(cols)
    uniq, first_idx = np.unique(cols, return_index=True)
    if len(uniq) == len(cols):
        return cols, np.ones(len(cols), dtype=bool)
    logger.warning(
        "%d duplicate gene names detected; keeping first occurrences",
        len(cols) - len(uniq),
    )
    keep_mask = np.zeros(len(cols), dtype=bool)
    keep_mask[np.sort(first_idx)] = True
    return cols[keep_mask], keep_mask


def save_packed_npz(packed: np.ndarray, input_dim: int, path: str) -> None:
    """Save sampled genomes as the PACKED bitmask artifact: an .npz holding
    ``packed`` (N, ceil(D/8)) uint8 (little bit order over the dataset
    columns — the sampler's format) and ``input_dim``; ~32x smaller than a
    float32 .npy. The converters read it without a dense expansion
    (:func:`iter_mask_chunks`). Either package reads the other's file."""
    np.savez(path, packed=np.ascontiguousarray(packed, np.uint8),
             input_dim=np.int64(input_dim))


def _open_packed_npz(masks_path: str):
    """Return (packed_array, input_dim) when ``masks_path`` is a packed-npz
    artifact, else None."""
    if not str(masks_path).endswith(".npz"):
        return None
    with np.load(masks_path, allow_pickle=False) as z:
        if "packed" not in z.files or "input_dim" not in z.files:
            raise ValueError(
                f"{masks_path}: .npz without 'packed'/'input_dim' keys is "
                "not a samples artifact")
        return z["packed"], int(z["input_dim"])


def iter_mask_chunks(masks_npy_path: str, chunk_size: int):
    """Yield (dense row chunk) arrays from ANY supported masks artifact with
    bounded memory; returns total row count upfront.

    Supported inputs: packed .npz (``save_packed_npz`` — unpacked per chunk,
    never whole), 2-D numeric .npy (memory-mapped), object/ragged .npy
    (pickle loads whole — inherent to the format — but dense conversion is
    chunked), 1-D numeric .npy (single row). Returns ``(n_rows, width,
    iterator)``."""
    chunk_size = int(chunk_size) if chunk_size and chunk_size > 0 else 0

    packed = _open_packed_npz(masks_npy_path)
    if packed is not None:
        arr, input_dim = packed
        n = arr.shape[0]
        # never unpack the whole matrix even for chunk_size=0 callers — the
        # dense expansion (5.5 GB at 100k) is exactly what the packed
        # artifact exists to avoid
        step = chunk_size or min(max(1, n), 1024)

        def gen_packed():
            for lo in range(0, n, step):
                yield unpack_bits(arr[lo:lo + step], input_dim)

        return n, input_dim, gen_packed()

    if chunk_size:
        try:
            mm = np.load(masks_npy_path, mmap_mode="r")
            if mm.ndim == 2:
                def gen_mm():
                    # native dtype: _threshold_chunk compares numeric chunks
                    # directly (a float64 cast here would be ~44 GB of
                    # allocator traffic over a 100k uint8 artifact)
                    for lo in range(0, len(mm), chunk_size):
                        yield np.asarray(mm[lo:lo + chunk_size])

                return len(mm), mm.shape[1], gen_mm()
        except ValueError:  # object/pickled array — not mappable
            logger.info("masks file is not memory-mappable; loading whole")

    masks = np.load(masks_npy_path, allow_pickle=True)
    rowwise = (masks.ndim == 1 and len(masks)
               and isinstance(masks[0], (list, np.ndarray)))
    if rowwise:
        # object array of rows: the pickle loads whole (format-inherent),
        # but the dense float conversion is chunked
        n = len(masks)
        width = len(masks[0])
        step = chunk_size or max(1, n)

        def gen_obj():
            for lo in range(0, n, step):
                yield np.stack([np.asarray(r, dtype=float)
                                for r in masks[lo:lo + step]])

        return n, width, gen_obj()
    if masks.ndim == 1:
        masks = masks[None, :]
    n = masks.shape[0]
    step = chunk_size or max(1, n)

    def gen_dense():
        for lo in range(0, n, step):
            yield np.asarray(masks[lo:lo + step])  # native dtype, as above

    return n, masks.shape[1], gen_dense()


def load_masks(masks_npy_path: str) -> np.ndarray:
    """Load a masks .npy with the reference converter's shape coercions."""
    masks = np.load(masks_npy_path, allow_pickle=True)
    if masks.ndim == 1:
        if len(masks) and isinstance(masks[0], (list, np.ndarray)):
            masks = np.stack([np.asarray(row, dtype=float) for row in masks])
        else:
            masks = masks[None, :]
    return masks


def _gene_lists_for_chunk(rows: np.ndarray, cols: np.ndarray,
                          keep_mask: np.ndarray, threshold: float
                          ) -> Tuple[List[List[str]], np.ndarray]:
    """Threshold a (n, P) chunk and gather per-row gene-name lists.

    Accepts rows at either the original (pre-dedupe) width or the deduped
    width; returns (lists, per-row gene counts)."""
    M = _threshold_chunk(rows, len(cols), keep_mask, threshold)
    return [cols[M[i]].tolist() for i in range(len(M))], M.sum(axis=1)


def _threshold_chunk(rows: np.ndarray, n_cols: int, keep_mask: np.ndarray,
                     threshold: float) -> np.ndarray:
    """(n, P) boolean presence from a dense chunk at either the original
    (pre-dedupe) or deduped width.

    Numeric dtypes compare against the threshold directly (the comparison
    promotes exactly like an up-front float64 cast would) — casting a
    uint8/packed-unpacked chunk to float64 first would move ~44 GB through
    the allocator over a 100k-sample conversion for identical results."""
    rows = np.asarray(rows)
    if not (np.issubdtype(rows.dtype, np.number)
            or rows.dtype == np.bool_):
        rows = np.asarray(rows, dtype=float)
    if rows.shape[1] != keep_mask.size and rows.shape[1] != n_cols:
        raise ValueError(
            f"Mask rows have length {rows.shape[1]}, but dataset has "
            f"{keep_mask.size} gene columns."
        )
    if rows.shape[1] == keep_mask.size and keep_mask.size != n_cols:
        rows = rows[:, keep_mask]
    return rows >= threshold


def masks_to_gene_lists(
    masks_npy_path: str,
    cols: Sequence[str],
    out_ids_npy: str | None,
    threshold: float = 0.5,
    chunk_size: int = 0,
) -> List[List[str]]:
    """Convert binary/continuous masks to per-sample gene-name lists.

    Vectorized: one >= threshold comparison over the whole (N, P) matrix,
    then a column-name gather per row (dedupe keeps first occurrences; the
    output is an object .npy).

    ``chunk_size > 0`` streams the masks file in row chunks through a
    memory map instead of materializing the full float matrix — at
    100k-genome scale a dense float64 masks file is ~44 GB, far beyond
    host RAM, while the gene lists themselves are ~100x smaller. Output
    is identical. Object-dtype (pickled) .npy files cannot be memory-
    mapped — the pickle must be deserialized whole — but their row->dense
    conversion IS chunked, so the additional dense float64 copy (which
    would double peak RSS) is bounded at chunk_size rows.
    """
    # object dtype so every row's list shares the SAME str objects (a
    # unicode array's .tolist() would allocate fresh strings per row)
    cols = np.asarray(cols, dtype=object)
    logger.info("masks: %s", masks_npy_path)
    logger.info("Resolved %d gene columns", len(cols))

    cols, keep_mask = dedupe_columns(cols)

    N, _, chunks = iter_mask_chunks(masks_npy_path, chunk_size)
    logger.info("Masks shape: N=%d samples (chunk=%s)", N, chunk_size or N)
    id_lists: List[List[str]] = []
    size_sum = 0
    for rows in chunks:
        lists, sizes = _gene_lists_for_chunk(rows, cols, keep_mask, threshold)
        id_lists.extend(lists)
        size_sum += int(sizes.sum())

    if out_ids_npy:
        os.makedirs(os.path.dirname(out_ids_npy) or ".", exist_ok=True)
        np.save(out_ids_npy, np.array(id_lists, dtype=object))
        logger.info("Saved IDs (NPY): %s", out_ids_npy)

    print(f"✓ Number of samples processed = {N} | Average gene count = {size_sum / max(N, 1):.1f}")
    return id_lists


def check_essential_genes(
    essential_set: set,
    id_lists,
    out_ids_npy: str,
) -> str:
    """Force-insert missing essential genes per sample; save sorted unions.

    Per-sample set union with the essentials, sorted() (lexicographic by
    code point), object .npy saved next to ``out_ids_npy`` with the
    ``_with_essentials`` suffix.
    """
    n_samples = len(id_lists)
    logger.info(
        "Checking & fixing essential genes (n=%d) across %d samples",
        len(essential_set), n_samples,
    )
    updated_samples = []
    n_fixed = 0
    n_ok = 0
    for idx, gene_list in enumerate(id_lists):
        if isinstance(gene_list, np.ndarray):
            gene_list = gene_list.tolist()
        gene_set = set(gene_list)
        missing = essential_set - gene_set
        if missing:
            gene_set.update(missing)
            if essential_set - gene_set:
                raise RuntimeError(
                    f"Post-add verify failed for sample {idx + 1}"
                )
            n_fixed += 1
        else:
            n_ok += 1
        updated_samples.append(sorted(gene_set))

    base, ext = os.path.splitext(out_ids_npy)
    out_path = base + "_with_essentials" + ext
    np.save(out_path, np.array(updated_samples, dtype=object))
    logger.info("Saved updated samples with essential genes to: %s", out_path)
    print(f"✓ Verified {n_samples} samples | already OK: {n_ok} | fixed: {n_fixed}")
    return out_path


def convert_samples_streaming(
    masks_npy_path: str,
    cols: Sequence[str],
    out_ids_npy: str,
    essential_set: set | None = None,
    threshold: float = 0.5,
    chunk_size: int = 1024,
) -> Tuple[str, str | None, int]:
    """Bounded-memory convert-samples: both output .npy files are STREAMED.

    Produces the same artifacts as :func:`masks_to_gene_lists` +
    :func:`check_essential_genes` (load-equal content: per-sample gene lists
    in column order, then sorted essential-filled unions), but never holds
    per-row Python lists live — at the 100k north-star scale the staged path
    carries ~4e8 list-slot pointers per output (3+ GB each, both alive at
    once), while this path's peak is one chunk of int32 indices plus the
    pickle writers' vocabulary tables (genome/object_npy.py). Accepts every
    masks artifact ``iter_mask_chunks`` supports, including the packed .npz
    (ingested without a dense full-matrix expansion).

    The essential-filled rows are built vectorized over a sorted name DOMAIN
    (deduped columns ∪ essentials): row bits scatter to domain positions,
    essentials force-set, and ascending domain order IS ``sorted()`` order —
    per-row set/sort work never happens.

    One deliberate deviation from np.save: outputs are always shape (N,)
    lists. ``np.array(lists, dtype=object)`` silently becomes a 2-D string
    array in the measure-zero case where every sample has the same gene
    count; np.save inherits that numpy quirk, this writer does not.

    Returns ``(out_ids_path, with_essentials_path | None, n_samples)``.
    """
    from .object_npy import ObjectListNpyWriter

    cols = np.asarray(cols, dtype=object)
    logger.info("masks: %s", masks_npy_path)
    logger.info("Resolved %d gene columns", len(cols))
    cols, keep_mask = dedupe_columns(cols)
    names = [str(c) for c in cols]

    N, _, chunks = iter_mask_chunks(masks_npy_path, chunk_size)
    logger.info("Masks shape: N=%d samples (streaming, chunk=%s)",
                N, chunk_size or N)

    os.makedirs(os.path.dirname(out_ids_npy) or ".", exist_ok=True)
    filled_path = None
    w_filled = None
    if essential_set is not None:
        domain = sorted(set(names) | set(essential_set))
        dom_idx = {g: i for i, g in enumerate(domain)}
        col_dom = np.fromiter((dom_idx[g] for g in names), np.int64,
                              count=len(names))
        e_dom = np.fromiter((dom_idx[g] for g in sorted(essential_set)),
                            np.int64, count=len(essential_set))
        base, ext = os.path.splitext(out_ids_npy)
        filled_path = base + "_with_essentials" + ext
        w_filled = ObjectListNpyWriter(filled_path, N, domain)

    size_sum = 0
    n_ok = 0
    try:
        with ObjectListNpyWriter(out_ids_npy, N, names) as w_ids:
            for rows in chunks:
                M = _threshold_chunk(rows, len(cols), keep_mask, threshold)
                counts = M.sum(axis=1)
                w_ids.append_rows(np.nonzero(M)[1], counts)
                size_sum += int(counts.sum())
                if w_filled is not None:
                    B = np.zeros((M.shape[0], len(domain)), bool)
                    B[:, col_dom] = M
                    n_ok += int(B[:, e_dom].all(axis=1).sum())
                    B[:, e_dom] = True
                    w_filled.append_rows(np.nonzero(B)[1], B.sum(axis=1))
        if w_filled is not None:
            w_filled.close()
    except BaseException:
        # leave no plausible-looking partial artifacts behind — a truncated
        # pickle would surface later as an opaque consumer-side error
        if w_filled is not None and not w_filled._closed:
            w_filled._f.close()
        for p in (out_ids_npy, filled_path):
            if p and os.path.exists(p):
                os.unlink(p)
        raise

    logger.info("Saved IDs (NPY): %s", out_ids_npy)
    print(f"✓ Number of samples processed = {N} | "
          f"Average gene count = {size_sum / max(N, 1):.1f}")
    if filled_path is not None:
        logger.info("Saved updated samples with essential genes to: %s",
                    filled_path)
        print(f"✓ Verified {N} samples | already OK: {n_ok} | "
              f"fixed: {N - n_ok}")
    return out_ids_npy, filled_path, N

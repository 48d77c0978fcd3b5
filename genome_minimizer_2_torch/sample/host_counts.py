"""ctypes bindings for sample mode's host counts, ``csrc/host_counts.cpp``.

Genome sizes (set bits a row) and essential-gene counts of packed bitmask
rows, each one native pass over the rows on a persistent pool of host
threads that sleep between calls. The call releases the GIL. The library is
built with g++ into the port's ``build/`` directory at first use; a failed
build or load raises.

How many threads a call takes follows from what the process can observe:
a count of fewer than ``POOL_ROWS`` rows runs on the calling thread alone;
a larger one takes as many threads as the process may run on cores
(``os.sched_getaffinity``), at most ``MAX_THREADS``. On an H100 host's 8
cores, cold 6,880-byte rows: 128 rows take 0.26 ms on the calling thread
and on 8 threads alike (waking the pool costs about 0.1 ms), 256 rows
0.81 ms alone and 0.28 ms on 8 threads; a 1,024-row chunk 2.6-3.7 ms on
1 thread, 2.0-2.7 on 2, 1.3-1.9 on 4 and 0.64-1.3 on 8. :func:`count_stats`
counts the rows counted on the pool and on the calling thread.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Sequence

import numpy as np

from ..ops import _build

POOL_ROWS = 256
MAX_THREADS = 8

_lock = threading.Lock()
_lib = None
_cores = len(os.sched_getaffinity(0))
_stats = {"pooled_rows": 0, "inline_rows": 0, "threads": 0}


def get_lib() -> ctypes.CDLL:
    """Load (building if needed) the host-count library; raises on failure."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = _build.build_host_counts()
            lib = ctypes.CDLL(str(path))
            vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            lib.gm2_popcount_rows.argtypes = [vp, i64, i64, i64, vp, i32]
            lib.gm2_count_essential.argtypes = [vp, i64, i64, i64, vp, vp, vp,
                                                i64, i64, vp, i32]
            lib.gm2_popcount_rows.restype = lib.gm2_count_essential.restype = i32
            _lib = lib
        return _lib


def threads_for(rows: int) -> int:
    """Threads for a count of ``rows`` rows (the calling thread included)."""
    return 1 if rows < POOL_ROWS else min(_cores, MAX_THREADS)


def count_stats() -> dict:
    """Rows counted on the pool and on the calling thread alone, and the
    most threads one call used, since the process started."""
    with _lock:
        return dict(_stats)


def _record(rows: int, used: int) -> None:
    if used < 0:
        raise MemoryError("host counts: no memory for the per-thread flags")
    with _lock:
        _stats["pooled_rows" if used > 1 else "inline_rows"] += rows
        _stats["threads"] = max(_stats["threads"], used)


def as_rows(packed) -> np.ndarray:
    """The packed rows as the uint8 (rows, bytes) array that a native pass
    reads through its row stride: a row or column slice stays a view; a
    view whose bytes within a row are not adjacent is copied."""
    packed = np.asarray(packed, np.uint8)
    if packed.ndim != 2:
        raise ValueError(f"packed rows must be 2-D, got shape {packed.shape}")
    if packed.shape[1] > 1 and packed.strides[1] != 1:
        packed = np.ascontiguousarray(packed)
    return packed


def popcount_rows(packed, threads: int) -> np.ndarray:
    """Set bits of each packed row, int64, on ``threads`` threads."""
    packed = as_rows(packed)
    n, width = packed.shape
    out = np.empty(n, np.int64)
    if n:
        used = get_lib().gm2_popcount_rows(packed.ctypes.data, n, width,
                                           packed.strides[0], out.ctypes.data,
                                           threads)
        _record(n, used)
    return out


class EssentialTable:
    """Genes' positions as one list of (byte, bit mask, gene) entries
    sorted by byte, so that each row is read front to back once; positions
    of one gene in one byte share an entry. ``genes`` holds each gene's
    positions (at least one each)."""

    def __init__(self, genes: Sequence[Sequence[int]]):
        pos = np.concatenate([np.asarray(g, np.int64) for g in genes])
        gene = np.repeat(np.arange(len(genes), dtype=np.int64), [len(g) for g in genes])
        byte, bit = pos >> 3, (pos & 7).astype(np.uint8)
        keys, inv = np.unique(np.stack([byte, gene]), axis=1, return_inverse=True)
        mask = np.zeros(keys.shape[1], np.uint8)
        np.bitwise_or.at(mask, inv.ravel(), np.left_shift(1, bit).astype(np.uint8))
        self.byte = np.ascontiguousarray(keys[0])
        self.gene = keys[1].astype(np.int32)
        self.mask = mask
        self.genes = len(genes)
        self.lo, self.hi = int(self.byte.min()), int(self.byte.max())

    def count(self, packed, threads: int) -> np.ndarray:
        """Genes with a set position in each packed row, int64, on
        ``threads`` threads. A byte beyond the rows' width raises
        ``IndexError``, as numpy's indexing does."""
        packed = as_rows(packed)
        n, width = packed.shape
        if self.hi >= width or self.lo < -width:
            raise IndexError(f"essential positions reach byte {self.hi} of "
                             f"rows {width} bytes wide")
        out = np.empty(n, np.int64)
        if n:
            used = get_lib().gm2_count_essential(
                packed.ctypes.data, n, width, packed.strides[0],
                self.byte.ctypes.data, self.mask.ctypes.data,
                self.gene.ctypes.data, self.byte.shape[0], self.genes,
                out.ctypes.data, threads)
            _record(n, used)
        return out

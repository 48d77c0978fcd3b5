"""ctypes bindings for the native (C++) minimize core, ``native/gm2min.cpp``.

The same C API the JAX package binds (``gm2_minimize_batch``,
``gm2_minimize_to_fasta``, ``gm2_minimize_packed_to_fasta``), built by the
port with g++ into its own ``build/`` directory at first use. Unlike the JAX
package's loader, a failed build or load raises: the numpy path runs only
where a caller passes ``use_native=False``.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from ..ops import _build

_lock = threading.Lock()
_lib = None


def get_lib() -> ctypes.CDLL:
    """Load (building if needed) the native library; raises on failure."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path, _ = _build.build_native()
        lib = ctypes.CDLL(str(path))
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.gm2_minimize_batch.argtypes = [
            u8p, ctypes.c_int64, i64p, i64p, ctypes.c_int64, u8p,
            ctypes.c_int64, u8p, i64p, ctypes.c_int,
        ]
        lib.gm2_minimize_batch.restype = ctypes.c_int
        lib.gm2_minimize_to_fasta.argtypes = [
            u8p, ctypes.c_int64, i64p, i64p, ctypes.c_int64, u8p,
            ctypes.c_int64, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, i64p,
        ]
        lib.gm2_minimize_to_fasta.restype = ctypes.c_int
        lib.gm2_minimize_packed_to_fasta.argtypes = [
            u8p, ctypes.c_int64, i64p, i64p, ctypes.c_int64, u8p,
            ctypes.c_int64, i64p, u8p, ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            i64p,
        ]
        lib.gm2_minimize_packed_to_fasta.restype = ctypes.c_int
        _lib = lib
        return _lib


def minimize_batch(seq_bytes: np.ndarray, starts: np.ndarray,
                   ends: np.ndarray, drop_mask: np.ndarray,
                   n_threads: int = 0) -> list[bytes]:
    """Native batch minimize; returns per-sample minimized byte strings."""
    lib = get_lib()
    seq_bytes = np.ascontiguousarray(seq_bytes, np.uint8)
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    drop = np.ascontiguousarray(drop_mask, np.uint8)
    n, L = drop.shape[0], seq_bytes.shape[0]
    out = np.empty((n, L), np.uint8)
    out_lens = np.zeros(n, np.int64)
    rc = lib.gm2_minimize_batch(seq_bytes, L, starts, ends, starts.shape[0],
                                drop, n, out, out_lens, n_threads)
    if rc != 0:
        raise RuntimeError(f"gm2_minimize_batch failed: rc={rc}")
    return [out[i, : out_lens[i]].tobytes() for i in range(n)]


def _write_base(append: bool, write_base) -> int:
    """The native write mode: -1 fresh rewrite (exact final size), -2 append
    at EOF, >= 0 write the batch at that byte offset (grow-only; the caller
    truncates at stream end)."""
    if write_base is not None:
        wb = int(write_base)
        if wb < 0:
            raise ValueError(f"write_base must be >= 0, got {wb}")
        return wb
    return -2 if append else -1


def minimize_to_fasta(seq_bytes: np.ndarray, starts: np.ndarray,
                      ends: np.ndarray, drop_mask: np.ndarray, path: str,
                      header_prefix: str, start_index: int = 0,
                      append: bool = False, n_threads: int = 0,
                      write_base: int | None = None) -> np.ndarray:
    """Native minimize writing '>{prefix}_{start_index+i+1}\\n{seq}\\n'
    records from (n, F) drop masks; returns minimized lengths."""
    lib = get_lib()
    seq_bytes = np.ascontiguousarray(seq_bytes, np.uint8)
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    drop = np.ascontiguousarray(drop_mask, np.uint8)
    out_lens = np.zeros(drop.shape[0], np.int64)
    rc = lib.gm2_minimize_to_fasta(
        seq_bytes, seq_bytes.shape[0], starts, ends, starts.shape[0], drop,
        drop.shape[0], path.encode(), header_prefix.encode(),
        start_index, _write_base(append, write_base), n_threads, out_lens)
    if rc != 0:
        raise RuntimeError(f"gm2_minimize_to_fasta failed: rc={rc}")
    return out_lens


def minimize_packed_to_fasta(seq_bytes: np.ndarray, starts: np.ndarray,
                             ends: np.ndarray, packed: np.ndarray,
                             col_idx: np.ndarray, ess: np.ndarray, path: str,
                             header_prefix: str, start_index: int = 0,
                             append: bool = False, n_threads: int = 0,
                             write_base: int | None = None) -> np.ndarray:
    """Converter-fused native FASTA straight from packed presence bitmasks
    (feature kept iff its column's bit is set or it is essential)."""
    lib = get_lib()
    seq_bytes = np.ascontiguousarray(seq_bytes, np.uint8)
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    packed = np.ascontiguousarray(packed, np.uint8)
    col_idx = np.ascontiguousarray(col_idx, np.int64)
    ess = np.ascontiguousarray(ess, np.uint8)
    n = packed.shape[0]
    out_lens = np.zeros(n, np.int64)
    rc = lib.gm2_minimize_packed_to_fasta(
        seq_bytes, seq_bytes.shape[0], starts, ends, starts.shape[0],
        packed, packed.shape[1], col_idx, ess, n, path.encode(),
        header_prefix.encode(), start_index,
        _write_base(append, write_base), n_threads, out_lens)
    if rc != 0:
        raise RuntimeError(f"gm2_minimize_packed_to_fasta failed: rc={rc}")
    return out_lens

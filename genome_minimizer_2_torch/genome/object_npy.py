"""Streaming writer for object-dtype .npy gene-list files: the port's copy
of the JAX package's ``genome/object_npy.py``, byte for byte in its output.

The converter's outputs are object .npy files holding one Python list of
gene-name strings per sample. ``np.save`` needs the whole list of lists in
memory (~4e8 live pointers at 100k samples), and numpy's pickler cannot
stream. This module writes the same artifact — an ``.npy`` header followed
by a pickle that rebuilds a 1-D object ndarray of lists — straight from
index arrays, chunk by chunk, so peak memory is one chunk of indices.

The pickle mirrors numpy's own object-array reduction
(``_reconstruct(ndarray, (0,), b'b')`` + ``__setstate__((1, (N,),
dtype('O'), False, data_list))``), with every gene name memoized once in a
prologue so that each occurrence in a row is a fixed 5-byte ``LONG_BINGET``
token; row bytes are assembled with numpy scatters. ``np.load(path,
allow_pickle=True)`` gives an array equal to the ``np.save`` original.
"""

from __future__ import annotations

import struct
from typing import Sequence

import numpy as np

# pickle opcodes (protocol 3; no frames — those are protocol 4 framing only)
_PROTO3 = b"\x80\x03"
_GLOBAL_RECONSTRUCT = b"cnumpy.core.multiarray\n_reconstruct\n"
_GLOBAL_NDARRAY = b"cnumpy\nndarray\n"
_GLOBAL_DTYPE = b"cnumpy\ndtype\n"
_EMPTY_LIST = b"]"
_MARK = b"("
_APPENDS = b"e"
_APPEND = b"a"
_POP = b"0"
_TUPLE = b"t"
_TUPLE1 = b"\x85"
_TUPLE3 = b"\x87"
_REDUCE = b"R"
_BUILD = b"b"
_STOP = b"."
_NEWFALSE = b"\x89"
_NEWTRUE = b"\x88"
_NONE = b"N"

# dtype('O') reduction: numpy.dtype('O8', False, True) + setstate
# (3, '|', None, None, None, -1, -1, 63) — matches np.save's stream.
_DTYPE_OBJECT = (
    _GLOBAL_DTYPE
    + b"X\x02\x00\x00\x00O8"          # BINUNICODE 'O8'
    + _NEWFALSE + _NEWTRUE + _TUPLE3 + _REDUCE
    + _MARK
    + b"K\x03"                        # 3
    + b"X\x01\x00\x00\x00|"           # '|'
    + _NONE * 3
    + b"J\xff\xff\xff\xff" * 2        # -1, -1
    + b"K?"                           # 63
    + _TUPLE
    + _BUILD
)


def _binint(n: int) -> bytes:
    if 0 <= n < 256:
        return b"K" + bytes([n])
    if 0 <= n < 65536:
        return b"M" + struct.pack("<H", n)
    return b"J" + struct.pack("<i", n)


def _binunicode(s: str) -> bytes:
    raw = s.encode("utf-8")
    return b"X" + struct.pack("<I", len(raw)) + raw


class ObjectListNpyWriter:
    """Stream a (n_rows,) object .npy of per-row string lists.

    ``names`` is the string vocabulary; rows are given as indices into it.
    Rows must be appended in order and total exactly ``n_rows`` by
    :meth:`close` (the array shape is fixed in the stream's prologue).
    Shared semantics with ``np.save(np.array(lists, dtype=object))``: every
    occurrence of names[j] unpickles to the SAME str object (memo-shared),
    exactly like np.save's pickler memoizing the shared strings of an
    in-memory lists-of-lists.
    """

    def __init__(self, path: str, n_rows: int, names: Sequence[str]):
        self._f = open(path, "wb")
        self._n_rows = int(n_rows)
        self._rows_written = 0
        self._closed = False

        header = {"descr": "|O", "fortran_order": False,
                  "shape": (self._n_rows,)}
        np.lib.format.write_array_header_1_0(self._f, header)

        # prologue: memoize every name once (PUT then POP — stack-neutral),
        # so each row occurrence is a uniform 5-byte LONG_BINGET
        parts = [_PROTO3]
        for i, s in enumerate(names):
            parts.append(_binunicode(str(s)))
            parts.append(b"r" + struct.pack("<I", i))   # LONG_BINPUT i
            parts.append(_POP)
        parts += [
            _GLOBAL_RECONSTRUCT,
            _GLOBAL_NDARRAY,
            b"K\x00" + _TUPLE1,          # (0,)
            b"C\x01b",                   # SHORT_BINBYTES b'b'
            _TUPLE3, _REDUCE,            # _reconstruct(ndarray, (0,), b'b')
            _MARK,                       # __setstate__ tuple
            b"K\x01",                    # version 1
            _binint(self._n_rows) + _TUPLE1,   # shape (N,)
            _DTYPE_OBJECT,
            _NEWFALSE,                   # fortran_order
            _EMPTY_LIST,                 # the data list (rows appended below)
        ]
        self._f.write(b"".join(parts))
        # first byte of the row-data region — rows written by equal-vocab
        # writers are byte-identical regardless of n_rows
        self.data_start = self._f.tell()

        # 5-byte LONG_BINGET token per vocabulary entry, gather-ready
        n = len(names)
        tok = np.empty((n, 5), np.uint8)
        tok[:, 0] = ord("j")
        tok[:, 1:] = (
            np.arange(n, dtype=np.uint32)[:, None]
            >> np.array([0, 8, 16, 24], np.uint32)
        ).astype(np.uint8)
        self._tok = tok

    def append_rows(self, flat_idx: np.ndarray, counts: np.ndarray) -> None:
        """Append rows: row r holds names[flat_idx[o_r : o_r + counts[r]]]
        in that order (``flat_idx`` is the row-major concatenation). Fully
        vectorized byte assembly: one scatter for delimiters, one gather for
        tokens."""
        if self._closed:
            raise ValueError("writer is closed")
        flat_idx = np.asarray(flat_idx, np.int64)
        counts = np.asarray(counts, np.int64)
        n = counts.size
        if int(counts.sum()) != flat_idx.size:
            raise ValueError("counts do not sum to flat_idx length")
        if n == 0:
            return
        self._rows_written += n
        if self._rows_written > self._n_rows:
            raise ValueError("more rows appended than declared n_rows")

        # per-row layout: ']' '(' tokens 'e' 'a'   (empty rows: ']' 'a')
        lens = np.where(counts > 0, 4 + 5 * counts, 2)
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
        total = int(lens.sum())
        out = np.empty(total, np.uint8)
        out[starts] = ord("]")
        out[starts + lens - 1] = ord("a")
        nz = counts > 0
        out[starts[nz] + 1] = ord("(")
        out[starts[nz] + lens[nz] - 2] = ord("e")
        if flat_idx.size:
            # one gather builds the contiguous token stream; each row's
            # 5·c-byte span is then a single slice copy. (A flat fancy-index
            # scatter of every token byte position was ~8 bytes of index per
            # output byte — GBs of transient index arrays per chunk at 100k
            # scale, measured crawling at ~20 rows/s.)
            tokens = self._tok[flat_idx].reshape(-1)
            offs = np.concatenate([[0], np.cumsum(counts)]) * 5
            for i in np.flatnonzero(counts):
                s = starts[i] + 2
                out[s:s + offs[i + 1] - offs[i]] = tokens[offs[i]:offs[i + 1]]
        self._f.write(out.tobytes())

    def append_lists(self, lists, name_to_idx) -> None:
        """Convenience: append explicit per-row name lists (tests/small N)."""
        counts = np.fromiter((len(r) for r in lists), np.int64,
                             count=len(lists))
        flat = np.fromiter((name_to_idx[s] for r in lists for s in r),
                           np.int64, count=int(counts.sum()))
        self.append_rows(flat, counts)

    def close(self) -> None:
        if self._closed:
            return
        if self._rows_written != self._n_rows:
            self._f.close()
            raise ValueError(
                f"declared {self._n_rows} rows but wrote {self._rows_written}")
        self._f.write(_TUPLE + _BUILD + _STOP)
        self._f.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:  # leave no plausible-looking partial artifact behind
            self._f.close()
            self._closed = True

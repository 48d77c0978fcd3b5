"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

- ``decode_threshold_pack``: the sampling hot path, ``(h @ W + b) > 0``
  packed 8 -> 1 into uint8 (little bit order), with only the packed bytes
  written — the port of the JAX package's Pallas kernel
  (genome_minimizer_2_tpu/ops/pallas_kernels.py:74-145). The CUDA source is
  ``csrc/decode_threshold_pack.cu``; it is built with nvcc for sm_90a at
  first use and called through ctypes on PyTorch's current stream.

Dispatch is by the device of the tensors: a CPU tensor goes to the plain
PyTorch version (the CPU tests use it), a CUDA tensor launches the kernel or
raises. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ..core.dtypes import round_up
from . import _build

_lib_lock = threading.Lock()
_lib = None  # the kernel library handle, loaded once per process


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the CUDA kernel library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _ = _build.build_cuda_kernels()
            lib = ctypes.CDLL(str(path))
            lib.gm2_decode_threshold_pack.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p]
            lib.gm2_decode_threshold_pack.restype = ctypes.c_int
            lib.gm2_cuda_error_string.argtypes = [ctypes.c_int]
            lib.gm2_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check_launch(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.gm2_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: cudaError {err} ({msg})")


# ---------------------------------------------------------------------------
# bit packing
# ---------------------------------------------------------------------------

def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(M, N) {0,1} -> (M, N // 8) uint8, little bit order (the inverse of
    :func:`unpack_bits`; N must be a multiple of 8 — pad first)."""
    m, n = bits.shape
    if n % 8:
        raise ValueError(f"pack_bits needs a multiple of 8 columns, got {n}")
    weights = torch.tensor([1 << k for k in range(8)], dtype=torch.int32,
                           device=bits.device)
    grouped = bits.to(torch.int32).reshape(m, n // 8, 8)
    return (grouped * weights).sum(dim=-1).to(torch.uint8)


def unpack_bits(packed: np.ndarray, n: int) -> np.ndarray:
    """Host-side inverse of the packers: uint8 (M, ceil(n/8)) -> (M, n)."""
    return np.unpackbits(np.asarray(packed), axis=1, bitorder="little")[:, :n]


# ---------------------------------------------------------------------------
# decode -> threshold -> bitpack
# ---------------------------------------------------------------------------

def decode_threshold_pack_reference(h: torch.Tensor, w: torch.Tensor,
                                    b: torch.Tensor,
                                    compute_dtype=torch.bfloat16
                                    ) -> torch.Tensor:
    """Plain PyTorch version: ``(h.to(cd).float() @ W.to(cd).float() + b)
    > 0``, packed. Operands are rounded to the compute dtype, products and
    sums are float32 (TF32 is switched off while it runs on a card)."""
    logits = decode_logits_reference(h, w, b, compute_dtype)
    n8 = round_up(logits.shape[1], 8)
    bits = torch.nn.functional.pad(logits > 0.0, (0, n8 - logits.shape[1]))
    return pack_bits(bits)


def decode_logits_reference(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The float32 logits the plain version thresholds."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return (h.to(compute_dtype).float() @ w.to(compute_dtype).float()
                + b.float())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def decode_threshold_pack(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Fused final decode: ``sigmoid(h @ W + b) > 0.5`` as packed bits.

    h: (M, K) hidden activations; w: (K, N) output weights in the JAX (in,
    out) layout; b: (N,). Returns uint8 (M, ceil(N/8)) — unpack with
    ``unpack_bits(out, N)``. Columns beyond N pack as 0 bits.

    ``h`` is rounded to ``compute_dtype`` here; ``w`` is used as it is when
    it already has that dtype (the Sampler keeps one bf16 copy of the output
    weight, made at load), else rounded per call.
    """
    if compute_dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported compute dtype {compute_dtype}")
    if h.device.type == "cpu":
        return decode_threshold_pack_reference(h, w, b, compute_dtype)
    if h.device.type != "cuda" or w.device != h.device or b.device != h.device:
        raise ValueError(
            f"decode_threshold_pack: tensors on {h.device}, {w.device}, "
            f"{b.device}; expected all on one CUDA device (or the CPU)")
    if h.dim() != 2 or w.dim() != 2 or b.dim() != 1:
        raise ValueError("decode_threshold_pack expects h (M,K), w (K,N), b (N,)")
    M, K = h.shape
    N = w.shape[1]
    if w.shape[0] != K or b.shape[0] != N or M == 0 or N == 0:
        raise ValueError(f"shape mismatch: h {tuple(h.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)}")
    hc = h.to(compute_dtype).contiguous()
    wc = w.to(compute_dtype).contiguous()
    bc = b.to(torch.float32).contiguous()
    out = torch.empty((M, round_up(N, 8) // 8), dtype=torch.uint8,
                      device=h.device)
    lib = load_library()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gm2_decode_threshold_pack(
            hc.data_ptr(), wc.data_ptr(), bc.data_ptr(), out.data_ptr(),
            M, K, N, _DTYPE_CODE[compute_dtype], stream)
    _check_launch(lib, err, "decode_threshold_pack")
    decode_threshold_pack.launches += 1
    return out


decode_threshold_pack.launches = 0  # kernel launches in this process

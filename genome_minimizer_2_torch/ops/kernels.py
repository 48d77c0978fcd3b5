"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

- ``decode_threshold_pack``: the sampling hot path, ``(h @ W + b) > 0``
  packed 8 -> 1 into uint8 (little bit order), with only the packed bytes
  written — the port of the JAX package's Pallas kernel
  (genome_minimizer_2_tpu/ops/pallas_kernels.py:74-145);
  ``csrc/decode_threshold_pack.cu``, bf16 operands on the tensor cores
  (``csrc/gemm_sm90.cuh``).
- ``gather_row_blocks``: the epoch shuffle, a permutation of blocks of
  rows (pallas_kernels.py:169-215); ``csrc/gather_row_blocks.cu``, a
  persistent ring of bulk async copies (register words for unaligned rows).
- ``output_layer_bwd``: dW, db and dh of the output layer + masked BCE
  from the logits, targets and mask (the probe kernels of
  tools/bol_probe.py); ``csrc/output_layer_bwd.cu``, bf16 operands on the
  tensor cores (``csrc/gemm_sm90.cuh``).
- ``clip_adam_apply``: the clip + Adam + apply update of one leaf in place
  (ops/optimizer.py::_adam_math as tools/opt_microbench3.py runs it in
  Pallas); ``csrc/clip_adam.cu``.

The CUDA sources are built with nvcc for sm_90a at first use into one
library and called through ctypes on PyTorch's current stream. bf16
operands take the tensor-core route (TMA + wgmma), float32 operands the
CUDA-core kernels: the tensor cores would round float32 operands to TF32.

Dispatch is by the device of the tensors: a CPU tensor goes to the plain
PyTorch version (the CPU tests use it), a CUDA tensor launches the kernel or
raises. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from ..core.dtypes import require_ieee_float32_matmul, round_up
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
            vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.gm2_decode_threshold_pack.argtypes = [vp] * 4 + [i32] * 3 + [vp]
            lib.gm2_decode_threshold_pack_bf16.argtypes = [vp] * 4 + [i32] * 4 + [vp]
            lib.gm2_gather_row_blocks.argtypes = [vp, vp, vp] + [i64] * 9 + [vp]
            lib.gm2_output_layer_bwd.argtypes = [vp] * 10 + [i32] * 3 + [vp]
            lib.gm2_output_layer_bwd_bf16.argtypes = [vp] * 12 + [i32] * 6 + [vp]
            lib.gm2_clip_adam.argtypes = [vp, vp, vp, vp, i64, i32, vp,
                                          ctypes.c_float, vp]
            for fn in (lib.gm2_decode_threshold_pack,
                       lib.gm2_decode_threshold_pack_bf16,
                       lib.gm2_gather_row_blocks, lib.gm2_output_layer_bwd,
                       lib.gm2_output_layer_bwd_bf16, lib.gm2_clip_adam):
                fn.restype = ctypes.c_int
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
    sums are IEEE float32."""
    logits = decode_logits_reference(h, w, b, compute_dtype)
    n8 = round_up(logits.shape[1], 8)
    bits = torch.nn.functional.pad(logits > 0.0, (0, n8 - logits.shape[1]))
    return pack_bits(bits)


def decode_logits_reference(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The float32 logits the plain version thresholds (IEEE float32
    products of the rounded operands; on a card TF32 must be off)."""
    return _mm_f32(h.to(compute_dtype), w.to(compute_dtype)) + b.float()


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` upcast to IEEE float32. Products of bf16 values are exact
    in float32, so this is the float32-accumulated product of the operands
    as they are; on a card it raises if TF32 is on."""
    if a.device.type == "cuda":
        require_ieee_float32_matmul()
    return a.float() @ b.float()


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
    if w.shape[0] != K or b.shape[0] != N:
        raise ValueError(f"shape mismatch: h {tuple(h.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)}")
    if M == 0 or N == 0:
        raise ValueError(f"decode_threshold_pack: no rows or no columns "
                         f"(h {tuple(h.shape)}, w {tuple(w.shape)}); the "
                         "kernel does not launch on an empty grid")
    hc = h.to(compute_dtype).contiguous()
    wc = w.to(compute_dtype).contiguous()
    bc = b.to(torch.float32).contiguous()
    out = torch.empty((M, round_up(N, 8) // 8), dtype=torch.uint8,
                      device=h.device)
    lib = load_library()
    stream = _stream(h.device)
    if compute_dtype == torch.float32:
        err = lib.gm2_decode_threshold_pack(
            hc.data_ptr(), wc.data_ptr(), bc.data_ptr(), out.data_ptr(),
            M, K, N, stream)
    else:
        # TMA rows must be multiples of 16 bytes: zero-pad K and N to
        # multiples of 8 (zero weights and bias pack as 0 bits)
        k8, n8 = round_up(K, 8), round_up(N, 8)
        hc = _tma_operand(hc, 0, k8 - K)
        wc = _tma_operand(wc, k8 - K, n8 - N)
        if n8 != N:
            bc = torch.nn.functional.pad(bc, (0, n8 - N))
        err = lib.gm2_decode_threshold_pack_bf16(
            hc.data_ptr(), wc.data_ptr(), bc.data_ptr(), out.data_ptr(),
            M, k8, n8, _sm_count(h.device), stream)
    _check_launch(lib, err, "decode_threshold_pack")
    decode_threshold_pack.launches += 1
    return out


decode_threshold_pack.launches = 0  # kernel launches in this process


def _cuda_args(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on "
                         f"{', '.join(str(t.device) for t in tensors)}; "
                         "expected all on one CUDA device (or the CPU)")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    """The grid of the persistent kernels (the tensor-core products, the
    gather): one block per SM, the device's multiprocessor count (a
    tensor's device, which carries its index)."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _tma_operand(t: torch.Tensor, pad_rows: int, pad_cols: int) -> torch.Tensor:
    """A 2-D bf16 operand as a TMA descriptor takes it: zero-padded by
    (pad_rows, pad_cols), contiguous, 16-byte aligned."""
    if pad_rows or pad_cols:
        t = torch.nn.functional.pad(t, (0, pad_cols, 0, pad_rows))
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


# ---------------------------------------------------------------------------
# epoch shuffle: row-block gather
# ---------------------------------------------------------------------------

GATHER_BLOCK = 8  # the JAX package's block (its TPU's HBM row tiling)
GATHER_CHUNK = 32 * 1024  # bytes a CTA copies in a round: one stage of its ring


class GatherSplit(NamedTuple):
    """How the gather deals the output's bytes to its CTAs (one per SM):
    ``rounds`` full rounds, in which CTA c copies the ``chunk`` bytes at
    (r * ctas + c) * chunk, then its share of the rest, [rest(c),
    rest(c + 1)). A CTA cuts each piece at run ends (:func:`gather_chunks`)."""
    ctas: int
    unit: int     # the route's word: the rest is dealt in whole words
    chunk: int
    rounds: int
    per_cta: int  # words of the rest a CTA; the first ``extra`` take one more
    extra: int

    def rest(self, c: int) -> int:
        return (self.rounds * self.ctas * self.chunk
                + self.unit * (c * self.per_cta + min(c, self.extra)))


def gather_split(m: int, block_bytes: int, sms: int, unit: int = 16) -> GatherSplit:
    """The deal of ``m`` runs of ``block_bytes`` over ``sms`` CTAs, for the
    route whose word is ``unit`` bytes: the bulk route (16) in rounds of
    GATHER_CHUNK a CTA, so that all CTAs copy near one another; the word
    route (4, 1) as one contiguous range a CTA. CTAs' byte counts differ by
    at most one word."""
    if block_bytes % unit:
        raise ValueError(f"{block_bytes}-byte runs are not whole {unit}-byte words")
    total = m * block_bytes
    rounds = total // (sms * GATHER_CHUNK) if unit == 16 else 0
    per_cta, extra = divmod((total - rounds * sms * GATHER_CHUNK) // unit, sms)
    return GatherSplit(sms, unit, GATHER_CHUNK, rounds, per_cta, extra)


def gather_chunks(split: GatherSplit, block_bytes: int, c: int):
    """Yield (output byte offset, bytes) of the chunks CTA ``c`` copies, in
    the order the kernel copies them."""
    pieces = [((r * split.ctas + c) * split.chunk,
               (r * split.ctas + c + 1) * split.chunk) for r in range(split.rounds)]
    for pos, end in pieces + [(split.rest(c), split.rest(c + 1))]:
        while pos < end:
            cut = min(end, (pos // block_bytes + 1) * block_bytes)
            yield pos, cut - pos
            pos = cut


def _gather_word(align: int) -> int:
    """The widest word (16, 4 or 1 bytes) that divides ``align``, the OR of
    the addresses and the run's size: 16 takes the bulk route."""
    return next(w for w in (16, 4, 1) if align % w == 0)


def gather_row_blocks_reference(x: torch.Tensor, block_idx: torch.Tensor,
                                block: int = GATHER_BLOCK) -> torch.Tensor:
    """Plain version: ``out[i*block:(i+1)*block] = x[idx[i]*block : +block]``
    as one row gather (the JAX package's ``jnp.take`` fallback)."""
    rows = (block_idx.to(torch.int64)[:, None] * block
            + torch.arange(block, device=x.device)[None, :]).reshape(-1)
    return x.index_select(0, rows)


def gather_row_blocks(x: torch.Tensor, block_idx: torch.Tensor,
                      block: int = GATHER_BLOCK) -> torch.Tensor:
    """Permute blocks of ``block`` rows: x (n, d), block_idx (m,) integer
    block ordinals (each < n // block; trailing rows are not addressed).
    Returns (m * block, d) in x's dtype. ``block=1`` is a row permutation."""
    if x.device.type == "cpu":
        return gather_row_blocks_reference(x, block_idx, block)
    if x.dim() != 2 or block_idx.dim() != 1 or block < 1:
        raise ValueError("gather_row_blocks expects x (n, d), block_idx (m,)")
    idx = block_idx.to(torch.int64).contiguous()
    _cuda_args("gather_row_blocks", x, idx)
    m = idx.shape[0]
    out = torch.empty((m * block, x.shape[1]), dtype=x.dtype, device=x.device)
    if m == 0 or x.shape[1] == 0:
        return out
    block_bytes = block * x.shape[1] * x.element_size()
    split = gather_split(m, block_bytes, _sm_count(x.device),
                         _gather_word(x.data_ptr() | out.data_ptr() | block_bytes))
    lib = load_library()
    err = lib.gm2_gather_row_blocks(
        x.data_ptr(), idx.data_ptr(), out.data_ptr(), m, block_bytes,
        x.shape[0] // block, split.unit, split.ctas, split.chunk, split.rounds,
        split.per_cta, split.extra, _stream(x.device))
    _check_launch(lib, err, "gather_row_blocks")
    gather_row_blocks.launches += 1
    return out


gather_row_blocks.launches = 0


# ---------------------------------------------------------------------------
# output layer + masked BCE backward
# ---------------------------------------------------------------------------

def output_layer_dl(logits: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                    g: torch.Tensor, g_logits: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """The logits' total cotangent ``g (sigmoid(l) - y) mask + g_logits``,
    computed in float32 and rounded to the logits' dtype (as JAX rounds a
    cotangent to its primal's dtype); returned as float32."""
    d = g.float() * (torch.sigmoid(logits.float()) - y.float()) * mask.float()
    if g_logits is not None:
        d = d + g_logits.float()
    return d.to(logits.dtype).float()


def output_layer_bwd_reference(logits, y, mask, h, w, g, g_logits=None):
    """Plain version: (dW (H, D), db (D,), dh (B, H)), all float32, from the
    rounded cotangent of :func:`output_layer_dl` and IEEE float32 sums;
    dW and dh rounded to the logits' dtype (JAX's transpose of its product
    rounds them to the operands' dtype), db a float32 sum."""
    cd = logits.dtype
    dl = output_layer_dl(logits, y, mask, g, g_logits)
    dw = _mm_f32(h.to(cd).t(), dl).to(cd).float()
    dh = _mm_f32(dl, w.to(cd).t()).to(cd).float()
    return dw, dl.sum(dim=0), dh


GEMM_TILE = (128, 256)  # output tile of the tensor-core GEMM (gemm_sm90.cuh)


def dh_splits(batch: int, hidden: int, genes: int, sms: int) -> int:
    """K splits of the dh product (dl (B, D) . W^T): its output tiles are
    few against K = D, so split K until the blocks fill the SMs' rounds
    (within 2 %), at most 16 ways."""
    tiles = -(-batch // GEMM_TILE[0]) * -(-hidden // GEMM_TILE[1])
    best, best_eff = 1, 0.0
    for s in range(1, min(16, -(-genes // 64)) + 1):
        blocks = tiles * s
        eff = blocks / (-(-blocks // sms) * sms)
        if eff > best_eff + 0.02:
            best, best_eff = s, eff
    return best


def output_layer_bwd(logits: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                     h: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                     g_logits: torch.Tensor | None = None):
    """Fused backward of ``bce = sum((softplus(l) - l y) mask)`` with ``l =
    h @ W + b``. logits (B, D) in the operand dtype (float32 or bf16),
    y (B, D) float32 or the operand dtype, mask (D,), h (B, H) and W (H, D)
    (rounded to the operand dtype here unless they have it already), g the
    0-dim cotangent of ``bce`` (read on the device), g_logits the optional
    (B, D) cotangent of the logits. Returns (dW, db, dh) in float32; under
    bf16, dW and dh hold bf16 values. bf16 operands run on the tensor
    cores through a (B, D) bf16 scratch of the logits' cotangent; float32
    ones on the CUDA cores, which never store it."""
    if logits.device.type == "cpu":
        return output_layer_bwd_reference(logits, y, mask, h, w, g, g_logits)
    cd = logits.dtype
    if cd not in _DTYPE_CODE or y.dtype not in _DTYPE_CODE or (
            y.dtype != cd and y.dtype != torch.float32):
        raise ValueError(f"output_layer_bwd: logits {cd}, targets {y.dtype}")
    B, D = logits.shape
    H = h.shape[1]
    if (tuple(y.shape) != (B, D) or tuple(h.shape) != (B, H)
            or tuple(w.shape) != (H, D) or tuple(mask.shape) != (D,)
            or g.numel() != 1 or (g_logits is not None
                                  and tuple(g_logits.shape) != (B, D))):
        raise ValueError("output_layer_bwd: shape mismatch")
    if B == 0:
        # a data-parallel rank's empty share of a ragged batch: the sums over
        # no rows, with no launch on an empty grid
        z = lambda *shape: torch.zeros(shape, dtype=torch.float32,  # noqa: E731
                                       device=logits.device)
        return z(H, D), z(D), z(0, H)
    hc, wc = h.to(cd).contiguous(), w.to(cd).contiguous()
    maskf, gf = mask.float().contiguous(), g.float().reshape(1).contiguous()
    gl = None if g_logits is None else g_logits.to(cd).contiguous()
    tensors = [logits, y, maskf, hc, wc, gf] + ([gl] if gl is not None else [])
    _cuda_args("output_layer_bwd", *tensors)
    lib = load_library()
    dev = logits.device
    if cd == torch.float32:
        dw = torch.empty((H, D), dtype=torch.float32, device=dev)
        db = torch.empty((D,), dtype=torch.float32, device=dev)
        dh = torch.empty((B, H), dtype=torch.float32, device=dev)
        err = lib.gm2_output_layer_bwd(
            logits.data_ptr(), y.data_ptr(), maskf.data_ptr(), hc.data_ptr(),
            wc.data_ptr(), gf.data_ptr(), None if gl is None else gl.data_ptr(),
            dw.data_ptr(), db.data_ptr(), dh.data_ptr(), B, H, D,
            _stream(dev))
    else:
        # TMA rows must be multiples of 16 bytes: zero-pad H and D to
        # multiples of 8 (a zero mask column gives a zero cotangent)
        h8, d8 = round_up(H, 8), round_up(D, 8)
        pad = lambda t: _tma_operand(t, 0, d8 - D)
        lc, yc = pad(logits), pad(y)
        gl = None if gl is None else pad(gl)
        maskf = torch.nn.functional.pad(maskf, (0, d8 - D))
        hc, wc = _tma_operand(hc, 0, h8 - H), _tma_operand(wc, h8 - H, d8 - D)
        sms = _sm_count(dev)
        splits = dh_splits(B, h8, d8, sms)
        dl = torch.empty((B, d8), dtype=torch.bfloat16, device=dev)
        ws = (torch.empty((splits, B, h8), dtype=torch.float32, device=dev)
              if splits > 1 else None)
        dw = torch.empty((h8, d8), dtype=torch.float32, device=dev)
        db = torch.empty((d8,), dtype=torch.float32, device=dev)
        dh = torch.empty((B, h8), dtype=torch.float32, device=dev)
        err = lib.gm2_output_layer_bwd_bf16(
            lc.data_ptr(), yc.data_ptr(), maskf.data_ptr(), hc.data_ptr(),
            wc.data_ptr(), gf.data_ptr(), None if gl is None else gl.data_ptr(),
            dl.data_ptr(), None if ws is None else ws.data_ptr(),
            dw.data_ptr(), db.data_ptr(), dh.data_ptr(), B, h8, d8,
            _DTYPE_CODE[y.dtype], sms, splits, _stream(dev))
        if (h8, d8) != (H, D):
            dw, db, dh = dw[:H, :D], db[:D], dh[:, :H]
    _check_launch(lib, err, "output_layer_bwd")
    output_layer_bwd.launches += 1
    return dw, db, dh


output_layer_bwd.launches = 0


# ---------------------------------------------------------------------------
# clip + Adam + apply
# ---------------------------------------------------------------------------

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def clip_adam_apply_reference(g, m, v, p, scalars, max_norm: float) -> None:
    """Plain version, in place: ``ops/optimizer.py::_adam_math`` in the
    optax op order, every operation rounded once in float32 (the square
    root through float64, which rounds to the correctly rounded float32
    root). ``scalars`` = [norm, bc1, bc2, lr] (float32)."""
    f32 = lambda c: torch.tensor(c, dtype=torch.float32, device=p.device)
    norm, bc1, bc2, lr = scalars.float().unbind()
    gf = g.float()
    gf = torch.where(norm < max_norm, gf, (gf / norm) * f32(max_norm))
    mn = f32(1.0 - ADAM_B1) * gf + f32(ADAM_B1) * m.float()
    vn = f32(1.0 - ADAM_B2) * (gf * gf) + f32(ADAM_B2) * v.float()
    root = (vn / bc2).double().sqrt().float()
    update = (mn / bc1) / (root + f32(ADAM_EPS))
    with torch.no_grad():
        p.copy_(p + (-lr) * update)
        m.copy_(mn.to(m.dtype))
        v.copy_(vn.to(v.dtype))


def clip_adam_apply(g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                    p: torch.Tensor, scalars: torch.Tensor,
                    max_norm: float) -> None:
    """Fused clip-by-global-norm + Adam + apply of one leaf, in place on
    m, v (float32 or bf16) and p (float32); g float32. ``scalars`` is a
    float32 (4,) tensor [norm, bc1, bc2, lr] that the kernel reads on the
    device, so a step needs no host sync."""
    if p.device.type == "cpu":
        return clip_adam_apply_reference(g, m, v, p, scalars, max_norm)
    if (g.dtype != torch.float32 or p.dtype != torch.float32
            or m.dtype != v.dtype or m.dtype not in _DTYPE_CODE
            or scalars.dtype != torch.float32 or scalars.numel() != 4):
        raise ValueError("clip_adam_apply: g, p float32; m, v float32 or "
                         "bf16; scalars float32 (4,)")
    n = p.numel()
    if not (g.numel() == m.numel() == v.numel() == n):
        raise ValueError("clip_adam_apply: size mismatch")
    _cuda_args("clip_adam_apply", g, m, v, p, scalars)
    lib = load_library()
    err = lib.gm2_clip_adam(g.data_ptr(), m.data_ptr(), v.data_ptr(),
                            p.data_ptr(), n, _DTYPE_CODE[m.dtype],
                            scalars.data_ptr(), float(max_norm),
                            _stream(p.device))
    _check_launch(lib, err, "clip_adam_apply")
    clip_adam_apply.launches += 1


clip_adam_apply.launches = 0


KERNELS = (decode_threshold_pack, gather_row_blocks, output_layer_bwd,
           clip_adam_apply)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0

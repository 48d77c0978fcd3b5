"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

- ``decode_threshold_pack``: the sampling hot path, ``(h @ W + b) > 0``
  packed 8 -> 1 into uint8 (little bit order), with only the packed bytes
  written — the port of the JAX package's Pallas kernel
  (genome_minimizer_2_tpu/ops/pallas_kernels.py:74-145);
  ``csrc/decode_threshold_pack.cu``, bf16 operands on the tensor cores
  in thread-block clusters (``csrc/gemm_cluster_sm90.cuh``, planned by
  :func:`decode_plan`), float32 on the CUDA cores
  (``csrc/sgemm_sm90.cuh``).
- ``gather_row_blocks``: the epoch shuffle, a permutation of blocks of
  rows (pallas_kernels.py:169-215); ``csrc/gather_row_blocks.cu``, a
  persistent ring of bulk async copies (register words for unaligned rows).
- ``output_layer_bwd``: dW, db and dh of the output layer + masked BCE
  from the logits, targets and mask (the probe kernels of
  tools/bol_probe.py); ``csrc/output_layer_bwd.cu``, a pass that stores
  the logits' cotangent, then the two products: bf16 operands on the tensor
  cores (``csrc/gemm_sm90.cuh``), float32 on the CUDA cores
  (``csrc/sgemm_sm90.cuh``).
- ``clip_adam_apply_leaves``: the clip + Adam + apply update of every
  leaf of a step in place, one launch (ops/optimizer.py::_adam_math as
  tools/opt_microbench3.py runs it in Pallas); ``csrc/clip_adam.cu``, 16-byte
  accesses over a table of leaves passed by value. ``clip_adam_apply`` is
  the same launch for one leaf.
- ``weight_grad_bf16``: the weight gradient of the bf16 policy's product
  (:class:`_BF16Matmul`, which :func:`matmul` takes under that policy),
  ``round_bf16(x^T g)`` with the float32 cotangent g split into two bf16
  terms; ``csrc/weight_grad_bf16.cu``, each term through the tensor cores
  into its own accumulator, the two added and rounded in the epilogue.
- ``threefry``: the port's counter-based random numbers on a CUDA key
  (``ops/prng.py``'s ``split``, ``fold_in``, ``random_bits``, ``uniform``
  and ``normal``), one launch a call of ``csrc/threefry.cu``, bit-equal to
  ``core/prng.py``'s torch code, which is its plain version and the route
  of a CPU key.

The CUDA sources are built with nvcc for sm_90a at first use into one
library and called through ctypes on PyTorch's current stream. bf16
operands take the tensor-core route (TMA + wgmma), float32 operands the
SIMT GEMM core on the CUDA cores: the tensor cores would round float32
operands to TF32.

Dispatch is by the device of the tensors: a CPU tensor goes to the plain
PyTorch version (the CPU tests use it), a CUDA tensor launches the kernel or
raises. There is no fallback from one to the other. ``threefry``'s dispatch
is ``ops/prng.py``'s: its wrapper takes CUDA keys only.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from ..core.dtypes import Policy, require_ieee_float32_matmul, round_up
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
            lib.gm2_decode_threshold_pack_bf16.argtypes = [vp] * 4 + [i32] * 5 + [vp]
            lib.gm2_decode_threshold_pack_bf16_max_clusters.argtypes = [i32, vp]
            lib.gm2_gather_row_blocks.argtypes = [vp, vp, vp] + [i64] * 9 + [vp]
            lib.gm2_output_layer_bwd.argtypes = [vp] * 12 + [i32] * 5 + [vp]
            lib.gm2_output_layer_bwd_f32_blocks_per_sm.argtypes = [vp]
            lib.gm2_output_layer_bwd_bf16.argtypes = [vp] * 12 + [i32] * 6 + [vp]
            lib.gm2_clip_adam.argtypes = [vp, i32, i64, i32, vp,
                                          ctypes.c_float, i32, vp]
            lib.gm2_weight_grad_bf16.argtypes = [vp] * 3 + [i32] * 4 + [vp]
            lib.gm2_threefry.argtypes = ([vp] + [i64] * 3 + [vp, i64, vp, i32]
                                         + [ctypes.c_float] * 2 + [vp, vp])
            for fn in (lib.gm2_decode_threshold_pack,
                       lib.gm2_decode_threshold_pack_bf16,
                       lib.gm2_gather_row_blocks, lib.gm2_output_layer_bwd,
                       lib.gm2_output_layer_bwd_bf16,
                       lib.gm2_output_layer_bwd_f32_blocks_per_sm,
                       lib.gm2_decode_threshold_pack_bf16_max_clusters,
                       lib.gm2_clip_adam, lib.gm2_weight_grad_bf16,
                       lib.gm2_threefry):
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
    # rows of 16-byte multiples (TMA boxes, cp.async and float4 loads):
    # zero-pad K and N to multiples of 8 (zero weights and bias pack as 0
    # bits)
    k8, n8 = round_up(K, 8), round_up(N, 8)
    hc = _aligned_operand(h.to(compute_dtype), 0, k8 - K)
    wc = _aligned_operand(w.to(compute_dtype), k8 - K, n8 - N)
    bc = torch.nn.functional.pad(b.to(torch.float32), (0, n8 - N)).contiguous()
    out = torch.empty((M, n8 // 8), dtype=torch.uint8, device=h.device)
    lib = load_library()
    stream = _stream(h.device)
    if compute_dtype == torch.float32:
        err = lib.gm2_decode_threshold_pack(
            hc.data_ptr(), wc.data_ptr(), bc.data_ptr(), out.data_ptr(),
            M, k8, n8, stream)
    else:
        plan = decode_plan(M, n8, k8, functools.partial(decode_max_clusters, h.device))
        err = lib.gm2_decode_threshold_pack_bf16(
            hc.data_ptr(), wc.data_ptr(), bc.data_ptr(), out.data_ptr(),
            M, k8, n8, plan.cm, plan.clusters, stream)
    _check_launch(lib, err, "decode_threshold_pack")
    decode_threshold_pack.launches += 1
    return out


decode_threshold_pack.launches = 0  # kernel launches in this process


GEMM_CLUSTER = 4  # most CTAs of a decode cluster (a W stage is 4 boxes)


class GemmPlan(NamedTuple):
    """A launch of the clustered GEMM core (csrc/gemm_cluster_sm90.cuh), as
    its kernel reads it: C (M, N) = A (M, K) B (K, N) in units of ``cm``
    row tiles of GEMM_TILE[0] rows (a cluster, one tile a CTA) x
    GEMM_TILE[1] columns, all of K, the row groups fastest; ``clusters``
    clusters take the units in turn (cluster c: c, c + clusters, ...)."""
    M: int
    N: int
    K: int
    cm: int
    m_tiles: int
    m_groups: int
    n_tiles: int
    k_blocks: int
    units: int
    clusters: int


def gemm_plan(M: int, N: int, K: int, cm: int, max_clusters) -> GemmPlan:
    """The plan of one product in clusters of ``cm`` CTAs;
    ``max_clusters(cm)``: the clusters the card holds at once (the grid
    takes no more, nor more than there are units)."""
    m_tiles = -(-M // GEMM_TILE[0])
    m_groups, n_tiles = -(-m_tiles // cm), -(-N // GEMM_TILE[1])
    units = m_groups * n_tiles
    return GemmPlan(M, N, K, cm, m_tiles, m_groups, n_tiles, -(-K // GEMM_DEPTH),
                    units, min(units, max_clusters(cm)))


def cluster_sizes(M: int, cm_max: int = GEMM_CLUSTER) -> list[int]:
    """The cluster sizes a product may take: powers of two up to ``cm_max``
    and up to the first that covers M's row tiles."""
    sizes, m_tiles = [1], -(-M // GEMM_TILE[0])
    while sizes[-1] < min(cm_max, m_tiles):
        sizes.append(2 * sizes[-1])
    return sizes


def plan_cost(plan: GemmPlan) -> int:
    """The k blocks the busiest CTA runs: its rounds of units (the last
    round's fill) times a unit's depth."""
    return -(-plan.units // plan.clusters) * plan.k_blocks


def fill_plan(plans) -> GemmPlan:
    """The fill rule: of the candidate plans, the one whose busiest CTA runs
    the fewest k blocks; among equals, the larger cluster (a B stage
    crosses from L2 once a cluster)."""
    return min(plans, key=lambda p: (plan_cost(p), -p.cm))


def decode_plan(M: int, N: int, K: int, max_clusters) -> GemmPlan:
    """The bf16 decode's plan: clusters of up to GEMM_CLUSTER CTAs sharing
    each W stage, by the fill rule."""
    return fill_plan(gemm_plan(M, N, K, cm, max_clusters) for cm in cluster_sizes(M))


def gemm_units(plan: GemmPlan):
    """Yield (cluster, rank, turn, m0, n0) for every tile a CTA computes, in
    the order the kernel (gemm_cluster_sm90.cuh::gemm_kernel) runs them;
    ``turn`` counts a cluster's units. Tiles past M compute zeros."""
    for c in range(plan.clusters):
        for turn, u in enumerate(range(c, plan.units, plan.clusters)):
            n0 = u // plan.m_groups * GEMM_TILE[1]
            for rank in range(plan.cm):
                yield c, rank, turn, (u % plan.m_groups * plan.cm + rank) * GEMM_TILE[0], n0


def stage_shares(cm: int) -> list[list[tuple[int, int, int, int]]]:
    """Each CTA's share of a B stage (GEMM_DEPTH K rows x GEMM_TILE[1]
    columns, MN-major) as the clustered kernel loads it by multicast: per
    rank, boxes of (first K row, first column, K rows, columns), 4 / cm
    boxes of 64 columns."""
    boxes = GEMM_TILE[1] // 64 // cm
    return [[(0, 64 * j, GEMM_DEPTH, 64) for j in range(r * boxes, (r + 1) * boxes)]
            for r in range(cm)]


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
def decode_max_clusters(dev: torch.device, cm: int) -> int:
    """Clusters of ``cm`` CTAs of the bf16 decode that ``dev`` holds at once,
    as the runtime reports them (a cluster's CTAs share a GPC, so this can
    be less than the SM count over cm)."""
    lib = load_library()
    n = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = lib.gm2_decode_threshold_pack_bf16_max_clusters(cm, ctypes.byref(n))
    _check_launch(lib, err, "decode cluster occupancy query")
    if n.value < 1:
        raise RuntimeError(f"decode: no cluster of {cm} CTAs fits the card")
    return n.value


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    """The grid of the persistent kernels (the tensor-core products, the
    gather, clip + Adam): one block per SM, the device's multiprocessor
    count (a tensor's device, which carries its index)."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _aligned_operand(t: torch.Tensor, pad_rows: int, pad_cols: int) -> torch.Tensor:
    """A 2-D operand as the GEMM cores take it (TMA boxes, cp.async and
    float4 loads): zero-padded by (pad_rows, pad_cols), contiguous,
    16-byte aligned."""
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
                                block: int = GATHER_BLOCK,
                                out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: ``out[i*block:(i+1)*block] = x[idx[i]*block : +block]``
    as one row gather (the JAX package's ``jnp.take`` fallback)."""
    rows = (block_idx.to(torch.int64)[:, None] * block
            + torch.arange(block, device=x.device)[None, :]).reshape(-1)
    if out is None:
        return x.index_select(0, rows)
    return torch.index_select(x, 0, rows, out=_gather_out(x, rows.numel(), out))


def _gather_out(x: torch.Tensor, rows: int, out: torch.Tensor) -> torch.Tensor:
    """Check a caller's output buffer: (rows, d) of x's dtype and device,
    contiguous (the epoch buffer a captured training graph writes)."""
    if (tuple(out.shape) != (rows, x.shape[1]) or out.dtype != x.dtype
            or out.device != x.device or not out.is_contiguous()):
        raise ValueError(f"gather_row_blocks: out {tuple(out.shape)} "
                         f"{out.dtype} on {out.device}; expected a contiguous "
                         f"({rows}, {x.shape[1]}) {x.dtype} tensor on {x.device}")
    return out


def gather_row_blocks(x: torch.Tensor, block_idx: torch.Tensor,
                      block: int = GATHER_BLOCK,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """Permute blocks of ``block`` rows: x (n, d), block_idx (m,) integer
    block ordinals (each < n // block; trailing rows are not addressed).
    Returns (m * block, d) in x's dtype, written into ``out`` when given
    (the same shape, contiguous). ``block=1`` is a row permutation."""
    if x.device.type == "cpu":
        return gather_row_blocks_reference(x, block_idx, block, out)
    if x.dim() != 2 or block_idx.dim() != 1 or block < 1:
        raise ValueError("gather_row_blocks expects x (n, d), block_idx (m,)")
    idx = block_idx.to(torch.int64).contiguous()
    _cuda_args("gather_row_blocks", x, idx)
    m = idx.shape[0]
    if out is None:
        out = torch.empty((m * block, x.shape[1]), dtype=x.dtype, device=x.device)
    else:
        out = _gather_out(x, m * block, out)
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
GEMM_DEPTH = 64         # its K block
SGEMM_TILE = (128, 128)  # output tile of the CUDA-core GEMM (sgemm_sm90.cuh)
SGEMM_DEPTH = 16         # its K stage


def dh_splits(batch: int, hidden: int, genes: int, slots: int,
              tile: tuple[int, int] = GEMM_TILE, depth: int = GEMM_DEPTH) -> int:
    """K splits of the dh product (dl (B, D) . W^T): its ``tile`` output
    tiles are few against K = D, so split K until the blocks fill the
    card's ``slots`` (blocks it holds at once) round by round (within 2 %),
    at most 16 ways and at least one ``depth`` block of K a split."""
    tiles = -(-batch // tile[0]) * -(-hidden // tile[1])
    best, best_eff = 1, 0.0
    for s in range(1, min(16, -(-genes // depth)) + 1):
        blocks = tiles * s
        eff = blocks / (-(-blocks // slots) * slots)
        if eff > best_eff + 0.02:
            best, best_eff = s, eff
    return best


class BwdPlan(NamedTuple):
    """How the backward of a (B, H, D) output layer runs: H and D padded to
    multiples of 8 (16-byte rows), the K splits of dh and the scratch
    tensors' shapes: the logits' cotangent in the operand dtype and the
    float32 partials of a split dh (None without a split)."""
    hidden: int
    genes: int
    splits: int
    dl: tuple[int, int]
    ws: tuple[int, int, int] | None


def bwd_plan(batch: int, hidden: int, genes: int, dtype: torch.dtype,
             sms: int, blocks_per_sm: int = 1) -> BwdPlan:
    """The plan of :func:`output_layer_bwd` on a card of ``sms`` SMs: bf16
    on the persistent tensor-core GEMM (one block an SM), float32 on the
    CUDA-core GEMM (``blocks_per_sm`` blocks of its dh an SM)."""
    h8, d8 = round_up(hidden, 8), round_up(genes, 8)
    if dtype == torch.float32:
        splits = dh_splits(batch, h8, d8, sms * blocks_per_sm, SGEMM_TILE,
                           SGEMM_DEPTH)
    else:
        splits = dh_splits(batch, h8, d8, sms)
    return BwdPlan(h8, d8, splits, (batch, d8),
                   (splits, batch, h8) if splits > 1 else None)


@functools.lru_cache(maxsize=None)
def sgemm_blocks_per_sm(dev: torch.device) -> int:
    """Blocks of the float32 dh product that one SM of ``dev`` holds at
    once (its registers and shared memory, as the runtime reports them)."""
    lib = load_library()
    n = ctypes.c_int(0)
    with torch.cuda.device(dev):
        _check_launch(lib, lib.gm2_output_layer_bwd_f32_blocks_per_sm(
            ctypes.byref(n)), "output_layer_bwd occupancy query")
    if n.value < 1:
        raise RuntimeError("output_layer_bwd: the float32 dh product fits no "
                           "block on an SM")
    return n.value


def output_layer_bwd(logits: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                     h: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                     g_logits: torch.Tensor | None = None):
    """Fused backward of ``bce = sum((softplus(l) - l y) mask)`` with ``l =
    h @ W + b``. logits (B, D) in the operand dtype (float32 or bf16),
    y (B, D) float32 or the operand dtype, mask (D,), h (B, H) and W (H, D)
    (rounded to the operand dtype here unless they have it already), g the
    0-dim cotangent of ``bce`` (read on the device), g_logits the optional
    (B, D) cotangent of the logits. Returns (dW, db, dh) in float32; under
    bf16, dW and dh hold bf16 values. Both routes store the logits'
    cotangent in a (B, D) scratch of the operand dtype, then run the two
    products: bf16 on the tensor cores, float32 on the CUDA cores."""
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
    sms = _sm_count(dev)
    f32 = cd == torch.float32
    plan = bwd_plan(B, H, D, cd, sms, sgemm_blocks_per_sm(dev) if f32 else 1)
    h8, d8 = plan.hidden, plan.genes
    # rows of 16-byte multiples: zero-pad H and D to multiples of 8 (a zero
    # mask column gives a zero cotangent)
    pad = lambda t: _aligned_operand(t, 0, d8 - D)  # noqa: E731
    lc, yc = pad(logits), pad(y)
    gl = None if gl is None else pad(gl)
    maskf = torch.nn.functional.pad(maskf, (0, d8 - D))
    hc, wc = _aligned_operand(hc, 0, h8 - H), _aligned_operand(wc, h8 - H, d8 - D)
    dl = torch.empty(plan.dl, dtype=cd, device=dev)
    ws = (torch.empty(plan.ws, dtype=torch.float32, device=dev)
          if plan.ws is not None else None)
    dw = torch.empty((h8, d8), dtype=torch.float32, device=dev)
    db = torch.empty((d8,), dtype=torch.float32, device=dev)
    dh = torch.empty((B, h8), dtype=torch.float32, device=dev)
    args = (lc.data_ptr(), yc.data_ptr(), maskf.data_ptr(), hc.data_ptr(),
            wc.data_ptr(), gf.data_ptr(), None if gl is None else gl.data_ptr(),
            dl.data_ptr(), None if ws is None else ws.data_ptr(),
            dw.data_ptr(), db.data_ptr(), dh.data_ptr(), B, h8, d8)
    if f32:
        err = lib.gm2_output_layer_bwd(*args, sms, plan.splits, _stream(dev))
    else:
        err = lib.gm2_output_layer_bwd_bf16(*args, _DTYPE_CODE[y.dtype], sms,
                                            plan.splits, _stream(dev))
    _check_launch(lib, err, "output_layer_bwd")
    output_layer_bwd.launches += 1
    if (h8, d8) != (H, D):
        dw, db, dh = dw[:H, :D], db[:D], dh[:, :H]
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
    f32 = lambda c: torch.full((), c, dtype=torch.float32, device=p.device)
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


def clip_adam_apply_leaves_reference(grads, ms, vs, ps, scalars,
                                     max_norm: float) -> None:
    """Plain version over the leaves: :func:`clip_adam_apply_reference`
    leaf by leaf."""
    for g, m, v, p in zip(grads, ms, vs, ps, strict=True):
        clip_adam_apply_reference(g, m, v, p, scalars, max_norm)


CLIP_ADAM_LEAVES = 64  # leaves a launch's table holds (kernel parameters < 4 KB)
CLIP_ADAM_UNIT = 8     # values a thread updates at a time: 32 bytes of g and of p
CLIP_ADAM_TILE = 32    # units a warp takes at a time (one a lane)
CLIP_ADAM_THREADS = 512  # a block, one an SM


class AdamLeaf(NamedTuple):
    """How the clip + Adam kernel cuts one leaf of n values into units of
    CLIP_ADAM_UNIT values: ``chunks`` vector units from value ``head`` on
    (every array 16-byte aligned there), then the scalar units of the
    values before ``head`` and after the chunks (the head and the tail),
    CLIP_ADAM_UNIT values each. ``head`` is -1 where the arrays share no
    aligned value with a whole chunk after it: every value is scalar."""
    n: int
    head: int
    chunks: int
    units: int
    begin: int  # the leaf's first unit in its launch


def adam_leaf_head(n: int, arrays) -> int:
    """The first value (< CLIP_ADAM_UNIT) at which every array, given as
    (address, bytes a value), is 16-byte aligned with a whole chunk of
    CLIP_ADAM_UNIT values from there; -1 if there is none."""
    for h in range(min(CLIP_ADAM_UNIT, n - CLIP_ADAM_UNIT + 1)):
        if all((addr + h * size) % 16 == 0 for addr, size in arrays):
            return h
    return -1


def clip_adam_plan(leaves) -> list[list[AdamLeaf]]:
    """The launches of one step: ``leaves`` as (n, [(address, bytes a
    value) of g, m, v, p]); up to CLIP_ADAM_LEAVES leaves a launch, each
    launch's units numbered from 0 in leaf order. Refuses a leaf of no
    values."""
    launches: list[list[AdamLeaf]] = []
    for i, (n, arrays) in enumerate(leaves):
        if n <= 0:
            raise ValueError(f"clip_adam: leaf {i} has no values")
        if i % CLIP_ADAM_LEAVES == 0:
            launches.append([])
        head = adam_leaf_head(n, arrays)
        chunks = 0 if head < 0 else (n - head) // CLIP_ADAM_UNIT
        scalar = n - chunks * CLIP_ADAM_UNIT
        units = chunks + -(-scalar // CLIP_ADAM_UNIT)
        last = launches[-1][-1] if launches[-1] else None
        begin = last.begin + last.units if last else 0
        launches[-1].append(AdamLeaf(n, head, chunks, units, begin))
    return launches


def clip_adam_blocks(units: int, sms: int) -> int:
    """The grid of a launch of ``units`` units: one block an SM, or fewer
    where one round of the blocks' tiles would not fill them."""
    per_block = CLIP_ADAM_THREADS // 32 * CLIP_ADAM_TILE
    return max(1, min(sms, -(-units // per_block)))


def clip_adam_apply_leaves(grads, ms, vs, ps, scalars: torch.Tensor,
                           max_norm: float) -> None:
    """Fused clip-by-global-norm + Adam + apply over every leaf of a step,
    in place on each m, v (float32 or bf16, one dtype for all) and p
    (float32); each g float32, of its p's size. ``scalars`` is a float32
    (4,) tensor [norm, bc1, bc2, lr] that the kernel reads on the device,
    so a step needs no host sync. One launch for up to CLIP_ADAM_LEAVES
    leaves (:func:`clip_adam_plan`), its table of leaves passed by value:
    nothing is copied from the host, so a CUDA graph captures it."""
    if not (len(grads) == len(ms) == len(vs) == len(ps)) or not ps:
        raise ValueError("clip_adam_apply_leaves: one g, m, v and p a leaf, "
                         "at least one leaf")
    if ps[0].device.type == "cpu":
        return clip_adam_apply_leaves_reference(grads, ms, vs, ps, scalars,
                                                max_norm)
    mdt = ms[0].dtype
    if (any(t.dtype != torch.float32 for t in [*grads, *ps])
            or any(t.dtype != mdt for t in [*ms, *vs]) or mdt not in _DTYPE_CODE
            or scalars.dtype != torch.float32 or scalars.numel() != 4):
        raise ValueError("clip_adam_apply_leaves: g, p float32; every m, v "
                         "float32 or every one bf16; scalars float32 (4,)")
    if any(not (g.numel() == m.numel() == v.numel() == p.numel())
           for g, m, v, p in zip(grads, ms, vs, ps)):
        raise ValueError("clip_adam_apply_leaves: size mismatch")
    _cuda_args("clip_adam_apply_leaves", *grads, *ms, *vs, *ps, scalars)
    leaves = list(zip(grads, ms, vs, ps))
    plan = clip_adam_plan([(leaf[3].numel(), [(t.data_ptr(), t.element_size())
                                              for t in leaf])
                           for leaf in leaves])
    dev = ps[0].device
    code = _DTYPE_CODE[mdt]
    lib = load_library()
    done = 0
    for launch in plan:
        table = np.array([[*(t.data_ptr() for t in leaves[done + i]), a.n,
                           a.begin, a.head] for i, a in enumerate(launch)],
                         dtype=np.int64)
        units = launch[-1].begin + launch[-1].units
        err = lib.gm2_clip_adam(table.ctypes.data, len(launch), units, code,
                                scalars.data_ptr(), float(max_norm),
                                clip_adam_blocks(units, _sm_count(dev)),
                                _stream(dev))
        _check_launch(lib, err, "clip_adam_apply_leaves")
        clip_adam_apply_leaves.launches += 1
        done += len(launch)


clip_adam_apply_leaves.launches = 0


def clip_adam_apply(g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                    p: torch.Tensor, scalars: torch.Tensor,
                    max_norm: float) -> None:
    """:func:`clip_adam_apply_leaves` of one leaf: on a card one launch of
    the same kernel with a table of one leaf (counted there)."""
    clip_adam_apply_leaves([g], [m], [v], [p], scalars, max_norm)


# ---------------------------------------------------------------------------
# the bf16 product's weight gradient
# ---------------------------------------------------------------------------

def mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 -> float32 product with float32 accumulation: on CUDA
    ``aten::mm.dtype`` (no global flag); on the CPU the operands are
    upcast, whose products are exact in float32."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def mm_f32_bf16(g: torch.Tensor, b: torch.Tensor, g_left: bool) -> torch.Tensor:
    """The float32 ``g`` times the bf16 ``b`` (``g @ b`` or ``b @ g``) as two
    bf16 products: g = g_hi + g_lo with g_hi = bf16(g), g_lo = bf16(g -
    g_hi), which leaves out at most about 2^-17 of g, far under the bf16
    rounding of the result."""
    g = g.float()
    hi = g.to(torch.bfloat16)
    lo = (g - hi.float()).to(torch.bfloat16)
    if g_left:
        return mm_bf16(hi, b) + mm_bf16(lo, b)
    return mm_bf16(b, hi) + mm_bf16(b, lo)


def weight_grad_bf16_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version: ``x^T g`` as two bf16 products (:func:`mm_f32_bf16`),
    rounded to bf16; float32 (D, N)."""
    return mm_f32_bf16(g, x.t(), False).to(torch.bfloat16).float()


def weight_grad_bf16(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The weight gradient of the bf16 product ``x @ W``: x (B, D) bf16, the
    output's cotangent g (B, N) float32; returns dW = round_bf16(x^T hi +
    x^T lo) (D, N) in float32, hi = bf16(g) and lo = bf16(g - hi). On a card
    one launch of ``csrc/weight_grad_bf16.cu`` on the current stream (D and
    N zero-padded to multiples of 8 where they are not: zero columns of x
    and g give zero rows and columns of dW, which are left out); B = 0 gives
    zeros and no launch. Raises for operands the kernel does not take."""
    if (x.dim() != 2 or g.dim() != 2 or x.shape[0] != g.shape[0]
            or x.dtype != torch.bfloat16 or g.dtype != torch.float32):
        raise ValueError(f"weight_grad_bf16 expects x (B, D) bf16 and g (B, N) "
                         f"float32; got x {tuple(x.shape)} {x.dtype}, g "
                         f"{tuple(g.shape)} {g.dtype}")
    if x.device.type == "cpu" and g.device.type == "cpu":
        return weight_grad_bf16_reference(x, g)
    dev = x.device
    if dev.type != "cuda" or g.device != dev:
        raise ValueError(f"weight_grad_bf16: x on {dev}, g on {g.device}; "
                         "expected both on one CUDA device (or the CPU)")
    (B, D), N = x.shape, g.shape[1]
    if B == 0 or D == 0 or N == 0:
        return torch.zeros((D, N), dtype=torch.float32, device=dev)
    d8, n8 = round_up(D, 8), round_up(N, 8)
    xc, gc = _aligned_operand(x, 0, d8 - D), _aligned_operand(g, 0, n8 - N)
    out = torch.empty((d8, n8), dtype=torch.float32, device=dev)
    lib = load_library()
    err = lib.gm2_weight_grad_bf16(xc.data_ptr(), gc.data_ptr(), out.data_ptr(),
                                   B, d8, n8, _sm_count(dev), _stream(dev))
    _check_launch(lib, err, "weight_grad_bf16")
    weight_grad_bf16.launches += 1
    return out if (d8, n8) == (D, N) else out[:D, :N]


weight_grad_bf16.launches = 0


# ---------------------------------------------------------------------------
# the counter-based random numbers
# ---------------------------------------------------------------------------

THREEFRY_KINDS = ("pairs", "bits", "uniform", "normal")  # csrc/threefry.cu's order


def _threefry_key(key) -> torch.Tensor:
    """A key or a table of keys the kernel takes: int64 (2,) or (N, 2) on a
    CUDA device; raises for anything else (before any build)."""
    if not isinstance(key, torch.Tensor) or key.dtype != torch.int64:
        raise ValueError(f"threefry: the key must be an int64 tensor, got "
                         f"{getattr(key, 'dtype', type(key).__name__)}")
    if tuple(key.shape) != (2,) and (key.dim() != 2 or key.shape[1] != 2):
        raise ValueError(f"threefry: the key must be (2,) or (N, 2), got "
                         f"{tuple(key.shape)}")
    if key.device.type != "cuda":
        raise ValueError(f"threefry: the key must be on a CUDA device (a key "
                         f"on {key.device} takes core/prng.py's torch code)")
    return key.contiguous()


def threefry(key: torch.Tensor, kind: str, n: int = 1, first: int = 0,
             counts: torch.Tensor | None = None, minval: float = 0.0,
             maxval: float = 1.0) -> torch.Tensor:
    """One launch of ``csrc/threefry.cu`` on the current stream: under each
    key of ``key`` (int64 (2,) or (N, 2) on a CUDA device), the Threefry-2x32
    of the 64-bit counts ``first .. first + n - 1``, or, where ``counts``
    (integer) is given, of each count's low word: with one key, one count
    an element of ``counts``; with N keys, one count for all or one a key.
    ``kind`` ``"pairs"`` returns both words, int64 (keys x counts, 2);
    ``"bits"`` their xor, int64 (keys x counts,); ``"uniform"`` and
    ``"normal"`` that word through ``core/prng.py``'s transforms, float32
    (keys x counts,), the uniform in [minval, maxval). The plain version
    is that module's torch code, bit for bit."""
    _threefry_kind(kind)
    key = _threefry_key(key)
    n_keys = key.numel() // 2
    stride = 0
    if counts is None:
        if n < 0 or not 0 <= first < 2 ** 32:
            raise ValueError(f"threefry: counts from {first}, {n} of them")
        per_key = n
    else:
        counts = counts.to(key.device, torch.int64).contiguous()
        m = counts.numel()
        if n_keys == 1:
            per_key, stride = m, 1
        elif m == 1 or (m == n_keys and counts.dim() == 1):
            per_key, stride = 1, int(m > 1)
        else:
            raise ValueError(f"threefry: {m} counts for {n_keys} keys; "
                             "expected one, or one a key")
    return _threefry_launch(key, n_keys, per_key, first, counts, stride, None,
                            kind, minval, maxval)


def threefry_words(words: torch.Tensor, kind: str, minval: float = 0.0,
                   maxval: float = 1.0) -> torch.Tensor:
    """The same launch on given 32-bit ``words`` (int64 on a CUDA device) in
    place of the threefry's: ``kind`` ``"bits"``, ``"uniform"`` or
    ``"normal"`` of each, as :func:`threefry` returns it. For holding the
    transforms to ``core/prng.py``'s on every word."""
    if _threefry_kind(kind) == 0 or words.dtype != torch.int64 \
            or words.device.type != "cuda":
        raise ValueError("threefry_words: int64 words on a CUDA device, kind "
                         "bits, uniform or normal")
    words = words.reshape(-1).contiguous()
    return _threefry_launch(None, 1, words.numel(), 0, None, 0, words, kind,
                            minval, maxval)


def _threefry_kind(kind: str) -> int:
    if kind not in THREEFRY_KINDS:
        raise ValueError(f"threefry: kind {kind!r} is none of {THREEFRY_KINDS}")
    return THREEFRY_KINDS.index(kind)


def _threefry_launch(key, n_keys, per_key, first, counts, stride, words, kind,
                     minval, maxval) -> torch.Tensor:
    dev = (key if words is None else words).device
    shape = (n_keys * per_key,) + ((2,) if kind == "pairs" else ())
    dtype = torch.int64 if kind in ("pairs", "bits") else torch.float32
    out = torch.empty(shape, dtype=dtype, device=dev)
    if out.numel() == 0:
        return out
    lib = load_library()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = lib.gm2_threefry(ptr(key), n_keys, per_key, first, ptr(counts), stride,
                           ptr(words), _threefry_kind(kind), minval, maxval,
                           out.data_ptr(), _stream(dev))
    _check_launch(lib, err, "threefry")
    threefry.launches += 1
    return out


threefry.launches = 0


# ---------------------------------------------------------------------------
# the dtype policy's product (the model's and the output layer's)
# ---------------------------------------------------------------------------

class _BF16Matmul(torch.autograd.Function):
    """The bf16 policy's product and its backward, the same roundings on
    the card and on the CPU. The operands come in at any float dtype and
    are rounded to bf16 here. The backward is JAX's transpose of its
    product (``jax.lax.dot_general`` with ``preferred_element_type``): the
    float32 cotangent times the bf16 operands (:func:`mm_f32_bf16`), each
    gradient rounded to bf16 and returned in its input's dtype. The
    weight's gradient is one launch of :func:`weight_grad_bf16` on a card
    (its plain version, the same two products, on the CPU)."""

    @staticmethod
    def forward(ctx, x, w):
        xc, wc = x.to(torch.bfloat16), w.to(torch.bfloat16)
        ctx.save_for_backward(xc, wc)
        ctx.dtypes = (x.dtype, w.dtype)
        return mm_bf16(xc, wc)

    @staticmethod
    def backward(ctx, g):
        xc, wc = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = mm_f32_bf16(g, wc.t(), True).to(torch.bfloat16).to(ctx.dtypes[0])
        if ctx.needs_input_grad[1]:
            dw = weight_grad_bf16(xc, g.float()).to(ctx.dtypes[1])
        return dx, dw


def matmul(x: torch.Tensor, w: torch.Tensor, policy: Policy) -> torch.Tensor:
    """Operands rounded to the compute dtype, float32 products and sums (the
    JAX ``preferred_element_type=float32`` contraction, ``vae.py:160-174``).

    Under bf16 the product takes bf16 operands with float32 output
    (:class:`_BF16Matmul`); under float32 on CUDA it requires IEEE float32
    (raises if TF32 is on). No process-global precision flag is written
    here."""
    if policy.compute_dtype == torch.bfloat16:
        return _BF16Matmul.apply(x, w)
    if x.device.type == "cuda":
        require_ieee_float32_matmul()
    return x.float() @ w.float()


KERNELS = (decode_threshold_pack, gather_row_blocks, output_layer_bwd,
           clip_adam_apply_leaves, weight_grad_bf16, threefry)


for _fn in KERNELS:
    _fn.replayed = 0  # of the launches, those made by replays of CUDA graphs


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = fn.replayed = 0


def launch_counts() -> dict[str, int]:
    """{kernel name: launches} of every wrapper."""
    return {fn.__name__: fn.launches for fn in KERNELS}


def set_launch_counts(counts: dict[str, int]) -> None:
    """Put the counts back to ``counts``: a CUDA graph's capture runs the
    wrappers' host code, which counts launches that did not happen."""
    for fn in KERNELS:
        fn.launches = counts[fn.__name__]


def add_launch_counts(counts: dict[str, int]) -> None:
    """Count the launches of one replay of a captured graph: the kernels it
    recorded, each launched again with the graph."""
    for fn in KERNELS:
        fn.launches += counts[fn.__name__]
        fn.replayed += counts[fn.__name__]

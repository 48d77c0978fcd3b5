#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (genome_minimizer_2_torch) on one
NVIDIA GPU (written for an H100, sm_90a).

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. Device: a CUDA device must be present; prints nvidia-smi's name and
   power limit, and turns TF32 off once (IEEE float32 products).
2. Build: nvcc builds the CUDA kernels from genome_minimizer_2_torch/csrc/
   (one compile per source, all at once) and g++ builds native/gm2min.cpp,
   both at the same time, into genome_minimizer_2_torch/build/.
3. Kernels against their plain versions on the card, at the main paths'
   shapes, each timed against its plain version, a library call where one
   computes the same function, and its bound. bf16 operands run on the
   tensor cores, float32 operands on the CUDA cores; both are checked:
   - decode_threshold_pack at (512, 1024, 55,040) in float32 and bfloat16
     and at ragged shapes (M = 300, N = 1000 / 1003). A bit may differ only
     where the plain logit is within 1e-3 of 0, and at most 1e-5 of all
     bits may differ;
   - gather_row_blocks: the epoch shuffle of 4,608 x 55,040 rows in 8-row
     blocks and as a row permutation, bf16 and float32, bit-equal; then
     timed against index_select in turns (index_select, kernel, kernel,
     index_select; 5 rounds of 20 launches queued behind a sleep, so that
     device time is measured), medians and ranges;
   - output_layer_bwd at (B, H, D) = (2,048, 1,024, 55,040) with and
     without the logits' cotangent, and at the ragged batches 512 and 856,
     bf16 operands: dW and dh (bf16 values) each element within 1 bf16 ulp
     of the plain one, or, where the float32 sum cancels, within 2^-16 of
     the sum of its terms' magnitudes (sums in another order), db within
     1e-4 of its largest value; float32 operands at (2,048, 1,024, 55,040):
     dW, db and dh within 1e-4 of the largest plain value;
   - clip_adam_apply over every leaf of the v0 model (117.3 M values) with
     float32 and bf16 moments, in the clip and the no-clip branch: within
     1 ulp of the plain version.
4. Pipeline path at full v0 width (55,039 genes, hidden 1024, latent 64): in
   a temporary GM2_ROOT it writes a gene vocabulary, essentials,
   phylogroups, a 4,641,652 bp GenBank file with ~4,000 genes and a random
   v0 checkpoint (seeded), then runs the port's CLI ``--mode pipeline`` on
   cuda for 2,048 genomes in chunks of 512, in default and in focused
   sampling mode. Checks: decode launches per run equal the run's decode
   chunks; the FASTA has every record with the expected header; the first
   chunk's records are byte-equal to a plain recompute (plain decode on the
   card + the numpy minimize), where a mismatch is allowed only for a
   record whose FASTA-relevant bits include a logit within 1e-3 of 0, and
   for at most 1% of the records (nearly every record holds such a bit, so
   the cap is what catches a systematic fault; the count is printed). Then
   ``--transfer feature-bits`` for the same genomes, default mode: its
   records must be byte-equal to the packed run's and its decode launches
   equal its chunks.
5. Training path at full v0 width: in a temporary GM2_ROOT it writes a
   synthetic 55,039-gene x 6,583-genome presence/absence CSV (70/20/10
   split: 4,608 training rows = 2 batches of 2,048 + 512), phylogroups and
   essentials, then runs the port's CLI ``--mode experiment --device cuda
   --trainer-version v0 --hidden-dim 1024 --latent-dim 64 --batch-size
   2048 --n-epochs 2`` (plus ``--checkpoint-every 1``, so the state after
   epoch 1 is on disk, and ``--no-generate-plots``: figures need
   matplotlib, which the card's machine may lack). Checks: launches equal the expected counts (one
   shuffle per train epoch, one output-layer backward per train step, one
   clip+Adam per leaf per step, one decode for the test-set metrics);
   losses are finite and epoch 2's train loss is below epoch 1's; the
   first step of epoch 2 is recomputed from the epoch-1 state and batch
   with the plain versions (the shuffle, the output layer's gradient by
   torch autograd, the update) and compared: the loss within 1e-5, the
   output layer's weight gradient elementwise as in phase 3 and its bias
   gradient within 1e-3 of its largest value, every other leaf within
   1e-2 in norm (and a dh with one tile zeroed must move some leaf beyond
   that), the update within 1 ulp of the plain update on
   the same gradients, and the parameters within 2e-2 x lr of the
   all-plain step wherever the two gradients agree to 1e-3; the saved
   checkpoint loads through load_sampler and decodes a chunk. Then the
   staged workflow from that checkpoint, through the CLI: the positions
   pickle and a GenBank whose gene names are the CSV's columns are written
   directly, ``--mode sample --num-samples 2048 --save-dtype packed --no-csv
   --no-generate-plots`` (default mode), ``--mode convert-samples`` on its
   ``.npz``, ``--mode minimizer --single-file``, then ``--mode pipeline``
   from the same checkpoint and seed. Checks: every bit of the sample file
   equals the plain decode of the same latents on the card, except where
   the plain logit is within 1e-3 of 0 (the differing and the near-zero
   bits are counted and printed); the staged FASTA's records equal the
   pipeline's byte for byte, except a record whose FASTA-relevant bits
   include a logit within 1e-3 of 0, at most 1% of the records (counted and
   printed: the sampler decodes 1,024 rows a chunk against the pipeline's
   512, so cuBLAS may sum the hidden layers in another order); sample
   mode's genome sizes and essential counts equal a host recompute from
   its ``.npz``; decode launches equal each run's chunks. Wall time and genomes/s of each run
   are printed.
6. The paths of elastic restarts, the trace, the bring-up and data
   parallelism, at full v0 width from phase 5's matrix cache, each with
   its launch counts set to 0 before it and held after it:
   - elastic: v0 for 3 epochs with a checkpoint every epoch and
     max_restarts 1 through the runner, uninterrupted and with one crash
     injected here after the epoch-1 checkpoint; loss histories,
     parameters, BatchNorm statistics and Adam moments must be bit-equal
     (a gap would be an operation on the card that is not deterministic:
     the script prints it and fails);
   - trace: one epoch with GM2_PROFILE_DIR set; the trace file must hold
     the trainer's ranges and the CUDA kernels of a step; prints the
     device's busy share of the traced epoch;
   - bring-up: ``--mode experiment --data-parallel 0`` through the CLI
     under torchrun's variables for one rank: it must form an NCCL group,
     and its train-state files and history must be bit-equal to phase 5's;
   - data parallel: two ranks sharing the card on a gloo group (this
     script again, ``--dp-worker``): v0 for 2 epochs at float32 and at
     bf16, each rank holding its half of the rows; the ranks' histories
     must be identical, epoch 1's train loss within rtol 2e-4 / atol 1e-5
     (float32) or 6e-3 (bf16) of one process taking the same row order,
     and a train step from the same state and global batch must agree with
     one process's: the loss and the output layer's gradients within those
     bounds and, at float32, every other leaf within 1e-2 in norm, while
     each rank's own BatchNorm statistics must exceed that (at bf16 those
     leaves are printed, not held); later history entries are
     printed, not held (PERF.md §6); then ``--mode sample
     --data-parallel 2``, whose packed file must equal the one-process file
     of phase 5 byte for byte. Every rank's launch counts are printed.
7. Prints the per-kernel JSON line, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

``--profile DIR`` adds, after the checks, one more default-mode pipeline
run (half the genomes, over the same output file) and one more training
epoch from the epoch-1 state, each under torch.profiler: it prints the
device time by kernel and the device's busy share of each one's wall time,
and writes Chrome traces into DIR. The main-path runs above are never
profiled.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

V0_INPUT_DIM = 55_039
V0_PADDED = 55_040   # the gene axis padded to a multiple of 128
GENOME_LENGTH = 4_641_652
N_FEATURES = 4_000
N_ESSENTIAL = 300
NUM_SAMPLES = 2_048
CHUNK = 512
N_PROBES = 100
SAMPLER_CHUNK = 1024  # load_sampler's chunk size: the focused probe decode
NEAR_ZERO = 1e-3
# records that may differ from their recompute at near-zero logits, of all
MAX_EXCUSED_FRACTION = 1e-2
MAX_DIFF_FRACTION = 1e-5
# H100 SXM published peaks (dense): bf16 tensor cores, fp32 CUDA cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
DEVICE = "cuda"
# training path: 6,583 genomes -> 4,608 training rows (70/20/10 split)
TRAIN_GENOMES = 6_583
TRAIN_BATCH = 2_048
TRAIN_EPOCHS = 2
V0_HIDDEN, V0_LATENT = 1024, 64
BWD_RTOL = 1e-4     # output_layer_bwd vs plain, of the largest plain value
CANCEL = 2.0 ** -16  # bf16 products: slack of a cancelling sum, of sum |terms|
GRAD_RTOL = 1e-3    # output-layer bias gradient, kernel path vs plain autograd
UPSTREAM_RTOL = 1e-2  # other leaves' gradients, in norm (bf16 cotangents)
GATHER_ROUNDS, GATHER_LAUNCHES = 5, 20  # the gather's A/B against index_select
QUEUE_CYCLES = 20_000_000  # ~10 ms of sleep on the stream ahead of timed launches


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------

def build_all() -> dict:
    from genome_minimizer_2_torch.ops import _build

    results, errors = {}, []

    def run(name, fn):
        try:
            results[name] = fn()
        except Exception as e:  # re-raised below, after both builds end
            errors.append((name, e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(n, f)) for n, f in
               (("cuda_kernels", _build.build_cuda_kernels),
                ("native", _build.build_native))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f"build failed: {errors}")
    wall = time.perf_counter() - t0
    for name, (path, secs) in results.items():
        log(f"build {name}: {path.name} in {secs:.2f}s")
    log(f"build wall time {wall:.2f}s")
    return {name: secs for name, (_, secs) in results.items()}


# ---------------------------------------------------------------------------
# phase 3: kernel against its plain version
# ---------------------------------------------------------------------------

def unpack_bits_dev(packed, n):
    import torch

    shifts = torch.arange(8, device=packed.device, dtype=torch.uint8)
    bits = (packed.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(packed.shape[0], -1)[:, :n]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_kernel_case(M, K, N, dtype, gen, timed: bool) -> dict:
    import torch

    from genome_minimizer_2_torch.ops import kernels as KR

    dev = DEVICE
    h = torch.randn(M, K, generator=gen, device=dev)
    w = torch.randn(K, N, generator=gen, device=dev) / math.sqrt(K)
    b = torch.randn(N, generator=gen, device=dev) * 0.1
    wc = w.to(dtype).contiguous()
    out = KR.decode_threshold_pack(h, wc, b, compute_dtype=dtype)
    torch.cuda.synchronize()
    logits = KR.decode_logits_reference(h, wc, b, dtype)
    ref = KR.decode_threshold_pack_reference(h, wc, b, dtype)
    width = (N + 7) // 8
    if tuple(out.shape) != (M, width) or out.dtype != torch.uint8:
        raise AssertionError(f"kernel output {tuple(out.shape)} {out.dtype}")
    diff = unpack_bits_dev(out, N) != unpack_bits_dev(ref[:, :width], N)
    n_diff = int(diff.sum())
    pad_bits = unpack_bits_dev(out, width * 8)[:, N:]
    if int(pad_bits.sum()):
        raise AssertionError("bits beyond N are set")
    max_logit_at_diff = float(logits.abs()[diff].max()) if n_diff else 0.0
    frac = n_diff / (M * N)
    name = str(dtype).replace("torch.", "")
    log(f"kernel {name} M={M} K={K} N={N}: {n_diff} of {M * N} bits differ "
        f"(fraction {frac:.3g}); max |plain logit| at a differing bit "
        f"{max_logit_at_diff:.3g}")
    if n_diff and max_logit_at_diff >= NEAR_ZERO:
        raise AssertionError(f"a bit differs where |logit| = {max_logit_at_diff}")
    if frac > MAX_DIFF_FRACTION:
        raise AssertionError(f"{frac} of bits differ (budget {MAX_DIFF_FRACTION})")
    res = {"bits_differing": n_diff, "bits": M * N,
           "max_abs_err": float(diff.any()),
           "max_abs_logit_at_differing_bit": max_logit_at_diff}
    if timed:
        # h in the compute dtype, as the library call takes it; each input
        # read once (h, W, b float32), the packed output written once
        hc = h.to(dtype)
        flops = 2.0 * M * K * N
        nbytes = (hc.numel() * hc.element_size() + wc.numel() * wc.element_size()
                  + N * 4 + M * width)
        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
        t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
        res["ms"] = time_ms(lambda: KR.decode_threshold_pack(hc, wc, b, dtype))
        res["plain_ms"] = time_ms(
            lambda: KR.decode_threshold_pack_reference(hc, wc, b, dtype))
        res["library_ms"] = time_ms(lambda: torch.matmul(hc, wc))
        res["bound_ms"] = max(t_ops, t_bytes)
        res["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        log(f"  time {name}: kernel {res['ms']:.4f} ms, plain "
            f"{res['plain_ms']:.4f} ms, torch.matmul {res['library_ms']:.4f} "
            f"ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}; "
            f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)")
    return res


def check_kernel() -> dict:
    """The bf16 result at the main shape, with the float32 one beside it."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(1234)
    main = {}
    worst = 0.0
    for M, K, N in ((CHUNK, 1024, 55_040), (300, 1024, 1000), (300, 1024, 1003)):
        for dtype in (torch.float32, torch.bfloat16):
            timed = M == CHUNK
            res = check_kernel_case(M, K, N, dtype, gen, timed)
            worst = max(worst, res["max_abs_err"])
            if timed:
                main[dtype] = res
    res = main[torch.bfloat16]
    res["max_abs_err"] = worst
    res["float32"] = main[torch.float32]
    return res


def ulp_distance(a, b) -> int:
    """Largest distance in units of the last place between two float
    tensors of one dtype (float32 or bf16)."""
    import torch

    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    ai = a.contiguous().view(view).to(torch.int64)
    bi = b.contiguous().view(view).to(torch.int64)
    return int((ai - bi).abs().max())


def bound(flops: float, nbytes: float, peak_flops: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def device_ms(fn, iters: int) -> float:
    """Device time of one launch, the mean of ``iters``: the launches queue
    behind a sleep on the stream, so the host's cost per call (the
    wrapper's Python) does not enter the device's timeline."""
    import torch

    torch.cuda._sleep(QUEUE_CYCLES)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ab_times(a, b, rounds: int = GATHER_ROUNDS, iters: int = GATHER_LAUNCHES):
    """Device times (ms a launch) of two functions in turns, a b b a,
    ``rounds`` times, each the mean of ``iters`` launches: two lists of
    2 x rounds."""
    import torch

    for fn in (a, b, a, b):
        fn()
    torch.cuda.synchronize()
    ta, tb = [], []
    for _ in range(rounds):
        for fn, ts in ((a, ta), (b, tb), (b, tb), (a, ta)):
            ts.append(device_ms(fn, iters))
    return ta, tb


def check_gather() -> dict:
    """The epoch shuffle at the training path's shape (4,608 x 55,040), bf16
    and float32, in 8-row blocks and as a row permutation (block 1): first
    bit-equality with the plain version in all four cases, then each case
    timed against ``index_select`` in turns (index_select, kernel, kernel,
    index_select; GATHER_ROUNDS rounds of GATHER_LAUNCHES launches)."""
    import statistics

    import torch

    from genome_minimizer_2_torch.core import prng
    from genome_minimizer_2_torch.ops import kernels as KR

    n, d = 4_608, 55_040
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        x = (torch.rand(n, d, generator=gen, device=DEVICE) < 0.5).to(dtype)
        x[:, -1] = torch.arange(n, device=DEVICE).to(dtype)  # row identity
        for blk in (KR.GATHER_BLOCK, 1):
            bperm = prng.permutation(prng.key(3, DEVICE), n // blk)
            out = KR.gather_row_blocks(x, bperm, blk)
            torch.cuda.synchronize()
            ref = KR.gather_row_blocks_reference(x, bperm, blk)
            same = torch.equal(out, ref)
            err = float((out.float() - ref.float()).abs().max())
            name = str(dtype).replace("torch.", "")
            log(f"gather_row_blocks {name} ({n}, {d}) block {blk}: "
                f"{'bit-equal' if same else 'DIFFERS'}, max |err| {err}")
            if not same:
                raise AssertionError(f"gather_row_blocks {name} block {blk} differs")
            del out, ref
            cases.append((name, blk, x, bperm, err))
    res = {}
    for name, blk, x, bperm, err in cases:
        rows = (bperm[:, None] * blk + torch.arange(blk, device=DEVICE)).reshape(-1)
        nbytes = 2 * x.numel() * x.element_size() + bperm.numel() * 8
        b_ms, b_by = bound(0.0, nbytes, PEAK_BF16_FLOPS)
        t_lib, t_kernel = ab_times(lambda: x.index_select(0, rows),
                                   lambda: KR.gather_row_blocks(x, bperm, blk))
        ms, lib_ms = statistics.median(t_kernel), statistics.median(t_lib)
        r = {"max_abs_err": err, "ms": ms,
             "ms_range": [min(t_kernel), max(t_kernel)],
             "plain_ms": time_ms(lambda: KR.gather_row_blocks_reference(x, bperm, blk)),
             "library_ms": lib_ms, "library_ms_range": [min(t_lib), max(t_lib)],
             "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms}
        log(f"  time {name} block {blk} ({len(t_kernel)} timings a side, in turns): "
            f"kernel median {ms:.4f} ms [{min(t_kernel):.4f}, {max(t_kernel):.4f}], "
            f"index_select median {lib_ms:.4f} ms [{min(t_lib):.4f}, {max(t_lib):.4f}] "
            f"({ms / lib_ms:.3f}x), plain {r['plain_ms']:.4f} ms, bound {b_ms:.4f} "
            f"ms ({b_by}; {nbytes / 1e6:.1f} MB; the kernel at {r['bound_share']:.3f} "
            f"of it)")
        res[(name, blk)] = r
    main = res[("bfloat16", KR.GATHER_BLOCK)]
    return {**main, "float32": res[("float32", KR.GATHER_BLOCK)],
            "block_1": {"bfloat16": res[("bfloat16", 1)],
                        "float32": res[("float32", 1)]}}


def bf16_ulps(a, b):
    """Elementwise distance in bf16 units of the last place of two float
    tensors holding bf16 values (ordered through the sign)."""
    import torch

    def ordered(x):
        i = x.to(torch.bfloat16).view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def bf16_outside(o, r, terms) -> int:
    """Elements of o (bf16 values) neither within 1 bf16 ulp of r nor, where
    the float32 sum cancels, within CANCEL of ``terms``, the sum of the
    magnitudes of its terms."""
    return int(((bf16_ulps(o, r) > 1) & ((o - r).abs() > CANCEL * terms)).sum())


def bwd_inputs(B, H, D, cd, gen, y_dtype=None):
    import torch

    h = torch.relu(torch.randn(B, H, generator=gen, device=DEVICE))
    w = torch.randn(H, D, generator=gen, device=DEVICE) * 0.02
    w[:, V0_INPUT_DIM:] = 0.0
    b = torch.randn(D, generator=gen, device=DEVICE) * 0.1
    logits = (h.to(cd).float() @ w.to(cd).float() + b).to(cd)
    y = (torch.rand(B, D, generator=gen, device=DEVICE) < 0.4).to(y_dtype or cd)
    mask = torch.zeros(D, device=DEVICE)
    mask[:V0_INPUT_DIM] = 1.0
    gl = (torch.randn(B, D, generator=gen, device=DEVICE) * 1e-2).to(cd)
    return h.to(cd), w.to(cd), logits, y, mask, gl


def check_output_layer_bwd() -> dict:
    """dW, db, dh at (2,048, 1,024, 55,040) as the training path calls it
    (h and W already in the operand dtype, as the forward saved them), and
    at the ragged batches; bf16 (tensor cores) and float32 (CUDA cores)."""
    import torch

    from genome_minimizer_2_torch.core.dtypes import require_ieee_float32_matmul
    from genome_minimizer_2_torch.ops import kernels as KR

    H, D = V0_HIDDEN, V0_PADDED
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    g = torch.ones((), device=DEVICE)
    absmm = lambda a, b: torch.mm(a.abs(), b.abs(), out_dtype=torch.float32)
    res, worst_abs, worst_rel, ulp1 = {}, 0.0, 0.0, 0
    # the training path's ragged last batch (512), and the one of 10k
    # genomes (856; with float32 targets)
    for B, y_dtype in ((TRAIN_BATCH, None), (512, None), (856, torch.float32)):
        h, w, logits, y, mask, gl = bwd_inputs(B, H, D, torch.bfloat16, gen, y_dtype)
        for g_logits in ((None, gl) if B == TRAIN_BATCH else (None,)):
            out = KR.output_layer_bwd(logits, y, mask, h, w, g, g_logits)
            torch.cuda.synchronize()
            ref = KR.output_layer_bwd_reference(logits, y, mask, h, w, g, g_logits)
            dl = KR.output_layer_dl(logits, y, mask, g, g_logits).to(torch.bfloat16)
            terms = {"dW": absmm(h.t(), dl), "dh": absmm(dl, w.t())}
            for name, o, r in zip(("dW", "db", "dh"), out, ref):
                err = float((o - r).abs().max())
                rel = err / float(r.abs().max())
                worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
                if name == "db":
                    bad = int(rel > BWD_RTOL)
                    note = ""
                else:
                    bad = bf16_outside(o, r, terms[name])
                    n1 = int((bf16_ulps(o, r) == 1).sum())
                    ulp1 += n1
                    note = (f"; {n1} of {o.numel()} elements 1 ulp apart, "
                            f"{bad} beyond 1 ulp and the cancellation slack")
                log(f"output_layer_bwd bf16 B={B} {name} (g_logits "
                    f"{'none' if g_logits is None else 'given'}, y "
                    f"{str(y.dtype)[6:]}): max |err| {err:.3g}, {rel:.3g} of "
                    f"max |plain|{note}")
                if bad:
                    raise AssertionError(f"output_layer_bwd bf16 B={B} {name}")
            del out, ref, dl, terms
        if B == TRAIN_BATCH:
            flops = 2 * 2.0 * B * H * D
            nbytes = (logits.numel() * 2 + y.numel() * 2 + D * 4 + h.numel() * 2
                      + w.numel() * 2 + 4 + (H * D + D + B * H) * 4)
            b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
            dl = KR.output_layer_dl(logits, y, mask, g).to(torch.bfloat16)

            def library():
                torch.mm(h.t(), dl, out_dtype=torch.float32)
                torch.mm(dl, w.t(), out_dtype=torch.float32)
                dl.sum(dim=0, dtype=torch.float32)

            res = {"ms": time_ms(lambda: KR.output_layer_bwd(logits, y, mask, h, w, g),
                                 iters=10, warmup=2),
                   "plain_ms": time_ms(lambda: KR.output_layer_bwd_reference(
                       logits, y, mask, h, w, g), iters=5, warmup=1),
                   "library_ms": time_ms(library, iters=10, warmup=2),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "dh_splits": KR.dh_splits(B, H, D, torch.cuda.get_device_properties(
                       0).multi_processor_count)}
            log(f"  time bf16: kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} "
                f"ms, 2 x torch.mm(bf16, out_dtype=float32) + sum "
                f"{res['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
                f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)")
            del dl
    # float32 operands: the CUDA-core kernels
    B = TRAIN_BATCH
    h, w, logits, y, mask, gl = bwd_inputs(B, H, D, torch.float32, gen)
    out = KR.output_layer_bwd(logits, y, mask, h, w, g, gl)
    torch.cuda.synchronize()
    ref = KR.output_layer_bwd_reference(logits, y, mask, h, w, g, gl)
    f32 = {}
    for name, o, r in zip(("dW", "db", "dh"), out, ref):
        err = float((o - r).abs().max())
        rel = err / float(r.abs().max())
        f32["max_abs_err"] = max(f32.get("max_abs_err", 0.0), err)
        log(f"output_layer_bwd float32 B={B} {name}: max |err| {err:.3g}, "
            f"{rel:.3g} of max |plain|")
        if not rel <= BWD_RTOL:
            raise AssertionError(f"output_layer_bwd float32 {name}: {rel} > {BWD_RTOL}")
    del out, ref
    flops = 2 * 2.0 * B * H * D
    nbytes = 3 * B * D * 4 + D * 4 + (B * H + H * D) * 4 + 4 + (H * D + D + B * H) * 4
    b_ms, b_by = bound(flops, nbytes, PEAK_FP32_FLOPS)
    dl = KR.output_layer_dl(logits, y, mask, g)  # float32

    def library32():  # IEEE float32 products: TF32 is off (main)
        torch.mm(h.t(), dl)
        torch.mm(dl, w.t())
        dl.sum(dim=0)

    require_ieee_float32_matmul()
    f32.update({"ms": time_ms(lambda: KR.output_layer_bwd(logits, y, mask, h, w, g),
                              iters=3, warmup=1),
                "plain_ms": time_ms(lambda: KR.output_layer_bwd_reference(
                    logits, y, mask, h, w, g), iters=3, warmup=1),
                "library_ms": time_ms(library32, iters=3, warmup=1),
                "bound_ms": b_ms, "bound_by": b_by})
    log(f"  time float32: kernel {f32['ms']:.4f} ms, plain {f32['plain_ms']:.4f} ms, "
        f"2 x torch.mm(float32, TF32 off) + sum {f32['library_ms']:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    del dl
    res.update({"max_abs_err": worst_abs, "max_rel_err": worst_rel,
                "elements_1ulp": ulp1, "float32": f32})
    return res


def v0_leaf_shapes() -> dict:
    from genome_minimizer_2_torch.models import vae

    cfg = vae.VAEConfig(input_dim=V0_INPUT_DIM, hidden_dim=V0_HIDDEN,
                        latent_dim=V0_LATENT)
    return {k: tuple(t.shape) for k, t in vae.VAE(cfg).flat_params().items()}


def check_clip_adam() -> dict:
    """Every v0 leaf through the kernel and the plain version, from the same
    inputs: float32 and bf16 moments, clip and no-clip branches."""
    import torch

    from genome_minimizer_2_torch.ops import kernels as KR
    from genome_minimizer_2_torch.ops.optimizer import global_norm

    shapes = v0_leaf_shapes()
    n = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    rnd = lambda s, scale: torch.randn(s, generator=gen, device=DEVICE) * scale
    g = {k: rnd(s, 1e-4) for k, s in shapes.items()}
    p0 = {k: rnd(s, 0.05) for k, s in shapes.items()}
    norm = global_norm(g.values())
    res, worst, worst_abs = {}, 0, 0.0
    for mdt in (torch.float32, torch.bfloat16):
        m0 = {k: rnd(s, 1e-5).to(mdt) for k, s in shapes.items()}
        v0 = {k: (rnd(s, 1e-4) ** 2).to(mdt) for k, s in shapes.items()}
        for branch, max_norm in (("clip", 0.5 * float(norm)),
                                 ("no-clip", 2.0 * float(norm))):
            scalars = torch.stack([norm, torch.tensor(0.271, device=DEVICE),
                                   torch.tensor(0.00399, device=DEVICE),
                                   torch.tensor(1e-3, device=DEVICE)]).float()
            ulps, errs = [], []
            for k in shapes:
                m, v, p = m0[k].clone(), v0[k].clone(), p0[k].clone()
                mr, vr, pr = m0[k].clone(), v0[k].clone(), p0[k].clone()
                KR.clip_adam_apply(g[k], m, v, p, scalars, max_norm)
                KR.clip_adam_apply_reference(g[k], mr, vr, pr, scalars, max_norm)
                pairs = ((m, mr), (v, vr), (p, pr))
                ulps.append(max(ulp_distance(a, b) for a, b in pairs))
                errs.append(max(float((a.float() - b.float()).abs().max())
                                for a, b in pairs))
            torch.cuda.synchronize()
            worst = max(worst, max(ulps))
            worst_abs = max(worst_abs, max(errs))
            name = str(mdt).replace("torch.", "")
            log(f"clip_adam_apply {name} moments, {branch}: {len(shapes)} leaves, "
                f"{n} values, max {max(ulps)} ulp and max |err| {max(errs)} "
                f"over m, v and p from the plain version")
            if max(ulps) > 1:
                raise AssertionError(f"clip_adam_apply {name} {branch}: {max(ulps)} ulp")
        nbytes = n * (4 + 4 + 4 + 4 + 4 * (2 if mdt == torch.float32 else 1))
        b_ms, b_by = bound(15.0 * n, nbytes, PEAK_FP32_FLOPS)
        m, v, p = m0, v0, {k: t.clone() for k, t in p0.items()}

        def run(fn):
            for k in shapes:
                fn(g[k], m[k], v[k], p[k], scalars, 1e30)

        r = {"ms": time_ms(lambda: run(KR.clip_adam_apply), iters=10),
             "plain_ms": time_ms(lambda: run(KR.clip_adam_apply_reference),
                                 iters=3, warmup=1),
             "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        log(f"  time {name} moments, all {len(shapes)} leaves: kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {b_ms:.4f} "
            f"ms ({b_by}; {nbytes / 1e9:.3f} GB)")
        res[name] = r
    res["max_ulp"] = worst
    res["max_abs_err"] = worst_abs
    res["values"] = n
    res["leaves"] = len(shapes)
    return res


# ---------------------------------------------------------------------------
# phase 4: inputs for the pipeline path
# ---------------------------------------------------------------------------

def write_genbank(gb: Path, genes, rng) -> Path:
    """A 4,641,652 bp GenBank file with ~4,000 gene features of 300-1,500 bp
    whose names are drawn from ``genes`` (the vocabulary), so sampled masks
    decide what is kept."""
    import numpy as np

    seq = np.frombuffer(b"acgt", np.uint8)[rng.randint(0, 4, GENOME_LENGTH)]
    seq = seq.tobytes().decode()
    starts = np.sort(rng.choice(GENOME_LENGTH - 2000, N_FEATURES, replace=False))
    lengths = rng.randint(300, 1500, N_FEATURES)
    names = np.asarray(genes, dtype=object)[
        rng.choice(len(genes), N_FEATURES, replace=False)]
    lines = [f"LOCUS       SMOKE001             {GENOME_LENGTH} bp    DNA     "
             "circular BCT 01-JAN-2024",
             "FEATURES             Location/Qualifiers",
             f"     source          1..{GENOME_LENGTH}"]
    for k, (s, n, name) in enumerate(zip(starts, lengths, names)):
        loc = f"{s + 1}..{s + n}"
        lines.append(f"     gene            {'complement(' + loc + ')' if k % 7 == 0 else loc}")
        lines.append(f'                     /gene="{name}"')
    lines.append("ORIGIN")
    for i in range(0, GENOME_LENGTH, 60):
        chunk = seq[i:i + 60]
        groups = " ".join(chunk[j:j + 10] for j in range(0, len(chunk), 10))
        lines.append(f"{i + 1:>9} {groups}")
    lines.append("//")
    gb.write_text("\n".join(lines) + "\n")
    return gb


def write_inputs(root: Path, seed: int = 0) -> dict:
    import numpy as np
    import pandas as pd
    import torch

    from genome_minimizer_2_torch.models import vae
    from genome_minimizer_2_torch.utils import checkpoint as ckpt
    from genome_minimizer_2_torch.utils.config import get_v0_config

    rng = np.random.RandomState(seed)
    data = root / "data"
    data.mkdir(parents=True)
    genes = np.array([f"gene{i:05d}" for i in range(V0_INPUT_DIM)], dtype=object)
    samples = [f"sample_{i}" for i in range(4)]
    mat = (rng.rand(V0_INPUT_DIM, len(samples)) < 0.5).astype(np.uint8)
    df = pd.DataFrame(mat, index=genes, columns=samples)
    lineage = pd.DataFrame([rng.randint(1, 20, len(samples))],
                           index=["Lineage"], columns=samples)
    pd.concat([lineage, df]).to_csv(data / "F4_complete_presence_absence.csv")
    pd.DataFrame({"ID": [s.upper() for s in samples],
                  "Phylogroup": ["A", "B1", "B2", "D"]}).to_csv(
        data / "accessionID_phylogroup_BD.csv", index=False)
    # essentials: a few hundred vocabulary genes plus one outside it
    ess = list(genes[rng.choice(V0_INPUT_DIM, N_ESSENTIAL, replace=False)]) + ["madeUpEss"]
    pd.DataFrame({"# gene": ess}).to_csv(data / "essential_genes.csv", index=False)

    gb = write_genbank(data / "wild_type_sequence.gb", genes, rng)

    config = get_v0_config()
    cfg = vae.VAEConfig(input_dim=V0_INPUT_DIM, hidden_dim=config.hidden_dim,
                        latent_dim=config.latent_dim)
    model = vae.init(cfg, torch.Generator(device=DEVICE).manual_seed(seed))
    model_path = root / "models" / "v0_smoke.npz"
    ckpt.save_checkpoint(model_path, model.flat_params(), model.flat_stats(),
                         config, extra={"input_dim": V0_INPUT_DIM})
    return {"genbank": str(gb), "model": str(model_path)}


# ---------------------------------------------------------------------------
# phase 4-5: main path through the CLI, and its checks
# ---------------------------------------------------------------------------

def skip_header(f) -> None:
    """Read past the three '#' lines that open a FASTA the port writes."""
    for _ in range(3):
        line = f.readline()
        if not line.startswith(b"# "):
            raise AssertionError(f"bad header line in {f.name}: {line[:80]!r}")


def iter_records(path: str, header: bool):
    """Yield (header_line, seq_line) byte pairs of a FASTA written by the
    pipeline (after its three '#' lines when ``header``)."""
    with open(path, "rb") as f:
        if header:
            skip_header(f)
        while True:
            head = f.readline()
            if not head:
                return
            yield head, f.readline()


def plain_lookup(model_path: str, genbank: str):
    """The checkpoint's sampler on the card, the GenBank's minimizer engine,
    its packed feature lookup (col_idx, ess) and the FASTA-relevant columns
    (those of the non-essential named features, on the card)."""
    import numpy as np
    import torch

    from genome_minimizer_2_torch.data.dataset import load_gene_vocab
    from genome_minimizer_2_torch.genome.converter import (
        dedupe_columns, load_essential_set)
    from genome_minimizer_2_torch.genome.minimizer import MinimizerEngine
    from genome_minimizer_2_torch.sample.sampler import load_sampler
    from genome_minimizer_2_torch.utils import directories

    cols = load_gene_vocab()
    essential = load_essential_set(directories.paper_essential_genes())
    sampler, _ = load_sampler(model_path, input_dim=len(cols), device=DEVICE)
    engine = MinimizerEngine.from_genbank(genbank)
    cols_arr, keep = dedupe_columns(np.asarray(cols))
    col_idx, ess = engine.feature_lookup_packed(cols_arr, keep, essential)
    relevant = torch.as_tensor(np.unique(col_idx[(col_idx >= 0) & ~ess]),
                               device=DEVICE)
    return sampler, engine, col_idx, ess, relevant


def plain_decode(sampler, z):
    """The plain decode of the latents z on the card: the logits of the D
    genes and the packed bits, (n, ceil(D/8)) uint8."""
    import torch

    from genome_minimizer_2_torch.ops import kernels as KR

    with torch.no_grad():
        h = sampler.model.decode_hidden(z)
        cd = sampler.cfg.policy.compute_dtype
        out_w, out_b = sampler.model.output.w, sampler.model.output.b
        logits = KR.decode_logits_reference(h, out_w, out_b, cd)
        packed = KR.decode_threshold_pack_reference(h, out_w, out_b, cd)
    D = sampler.cfg.input_dim
    return logits[:, :D], packed[:, : (D + 7) // 8]


def check_excused(label: str, excused: int, n: int) -> None:
    """A record held to equality only up to near-zero logits is excused;
    nearly every record holds such a bit, so the excused ones are capped."""
    cap = int(MAX_EXCUSED_FRACTION * n)
    if excused > cap:
        raise AssertionError(f"{label}: {excused} of {n} records differ at "
                             f"near-zero logits (cap {cap})")


def check_first_chunk(inputs: dict, out: str, mode: str, seed: int) -> dict:
    """Recompute chunk 0 with the plain decode on the card and the numpy
    minimize, and compare its records with the pipeline's FASTA."""
    import torch

    from genome_minimizer_2_torch.core import prng

    sampler, engine, col_idx, ess, relevant = plain_lookup(inputs["model"],
                                                           inputs["genbank"])
    key = prng.key(seed, DEVICE)
    anchor = None
    if mode == "focused":
        probe_key, key = prng.split(key)
        anchor = torch.as_tensor(sampler.focused_anchor(probe_key, N_PROBES),
                                 device=DEVICE)
    z = prng.draw_latents(key, torch.arange(CHUNK, device=DEVICE),
                          sampler.cfg.latent_dim)
    if anchor is not None:
        z = anchor + torch.tensor(0.1, device=DEVICE) * z
    logits, packed = plain_decode(sampler, z)
    packed = packed.cpu().numpy()
    near = (logits[:, relevant].abs() < NEAR_ZERO).any(dim=1).cpu().numpy()

    expected = out + ".plain_chunk0"
    engine.minimize_packed_to_fasta(packed, col_idx, ess, expected,
                                    use_native=False)
    same = excused = 0
    got = iter_records(out, header=True)
    for i, (want_h, want_s) in enumerate(iter_records(expected, header=False)):
        got_h, got_s = next(got)
        if got_h != want_h:
            raise AssertionError(f"record {i}: header {got_h!r} != {want_h!r}")
        if got_s == want_s:
            same += 1
        elif near[i]:
            excused += 1
        else:
            raise AssertionError(
                f"{mode}: record {i} differs from the plain recompute and "
                f"has no relevant logit within {NEAR_ZERO} of 0")
    os.remove(expected)
    check_excused(f"{mode} chunk 0", excused, CHUNK)
    log(f"{mode}: chunk 0 vs plain recompute: {same} of {CHUNK} records "
        f"byte-equal, {excused} differ and hold a relevant bit with |logit| < "
        f"{NEAR_ZERO} (not held to equality); {int(near.sum())} of {CHUNK} "
        f"records hold such a bit")
    return {"equal": same, "near_zero_mismatch": excused,
            "near_zero_records": int(near.sum())}


def check_fasta(out: str, n: int) -> int:
    count, total = 0, 0
    for i, (head, seq) in enumerate(iter_records(out, header=True)):
        want = f">Minimized_E_coli_K12_MG1655_{i + 1}\n".encode()
        if head != want or not seq.endswith(b"\n"):
            raise AssertionError(f"record {i}: header {head[:60]!r}")
        count += 1
        total += len(seq) - 1
    if count != n:
        raise AssertionError(f"{count} records, expected {n}")
    return total // max(count, 1)


def same_records(a: str, b: str) -> bool:
    """The two FASTA files hold the same bytes after their '#' lines."""
    with open(a, "rb") as fa, open(b, "rb") as fb:
        skip_header(fa)
        skip_header(fb)
        while True:
            x, y = fa.read(16 << 20), fb.read(16 << 20)
            if x != y:
                return False
            if not x:
                return True


def run_main_path(inputs: dict, root: Path, card: str) -> dict:
    from genome_minimizer_2_torch import cli
    from genome_minimizer_2_torch.ops import kernels as KR

    runs = {}
    seed = 0
    for mode in ("default", "focused"):
        # the default run's file stays for the feature-bits comparison below
        out = str(root / ("smoke.fasta" if mode == "default" else "smoke_focused.fasta"))
        args = cli.parse_arguments([
            "--mode", "pipeline", "--device", DEVICE,
            "--model-path", inputs["model"], "--genome-path", inputs["genbank"],
            "--output-file", out, "--num-samples", str(NUM_SAMPLES),
            "--chunk-size", str(CHUNK), "--seed", str(seed),
            "--sampling-mode", mode, "--model-name", "v0_smoke"])
        if not cli.check_data_availability():
            raise AssertionError("smoke data tree incomplete")
        KR.decode_threshold_pack.launches = 0
        stats = cli.run_pipeline(args)
        launches = KR.decode_threshold_pack.launches
        if stats is None:
            raise AssertionError(f"{mode}: pipeline did not run")
        chunks = math.ceil(NUM_SAMPLES / CHUNK)
        if mode == "focused":
            chunks += math.ceil(N_PROBES / SAMPLER_CHUNK)  # the probe decode
        log(f"{mode}: decode_threshold_pack launches {launches}, decode "
            f"chunks {chunks}")
        if launches != chunks:
            raise AssertionError(f"{mode}: {launches} launches != {chunks} chunks")
        if stats.genomes != NUM_SAMPLES:
            raise AssertionError(f"{mode}: {stats.genomes} genomes")
        mean_len = check_fasta(out, NUM_SAMPLES)
        log(f"{mode}: FASTA has {NUM_SAMPLES} records, mean length "
            f"{mean_len} bp of {GENOME_LENGTH}")
        cmp = check_first_chunk(inputs, out, mode, seed)
        log(f"{mode}: {stats.rate():.1f} genomes/s whole-run, "
            f"{stats.steady_rate():.1f} genomes/s steady (sample "
            f"{stats.sample_s:.2f}s, minimize {stats.minimize_s:.2f}s, total "
            f"{stats.total_s:.2f}s) on {card}")
        runs[mode] = {"launches": launches, "chunks": chunks,
                      "genomes_per_s": stats.rate(),
                      "steady_genomes_per_s": stats.steady_rate(),
                      "total_s": stats.total_s, "sample_s": stats.sample_s,
                      "minimize_s": stats.minimize_s,
                      "mean_record_bp": mean_len, **cmp}
    os.remove(root / "smoke_focused.fasta")

    # --transfer feature-bits: the same genomes and seed, default mode
    out = str(root / "smoke_feature_bits.fasta")
    args = cli.parse_arguments([
        "--mode", "pipeline", "--device", DEVICE, "--transfer", "feature-bits",
        "--model-path", inputs["model"], "--genome-path", inputs["genbank"],
        "--output-file", out, "--num-samples", str(NUM_SAMPLES),
        "--chunk-size", str(CHUNK), "--seed", str(seed), "--model-name", "v0_smoke"])
    KR.decode_threshold_pack.launches = 0
    t0 = time.perf_counter()
    stats = cli.run_pipeline(args)
    wall = time.perf_counter() - t0
    launches = KR.decode_threshold_pack.launches
    chunks = math.ceil(NUM_SAMPLES / CHUNK)
    if stats is None or stats.genomes != NUM_SAMPLES:
        raise AssertionError("feature-bits: pipeline did not run")
    if launches != chunks:
        raise AssertionError(f"feature-bits: {launches} launches != {chunks} chunks")
    if not same_records(out, str(root / "smoke.fasta")):
        raise AssertionError("feature-bits FASTA differs from the packed run's")
    os.remove(out)
    log(f"feature-bits: {NUM_SAMPLES} records byte-equal to the packed run's; "
        f"decode_threshold_pack launches {launches}, chunks {chunks}; "
        f"{stats.rate():.1f} genomes/s whole-run (wall {wall:.2f}s, sample "
        f"{stats.sample_s:.2f}s, minimize {stats.minimize_s:.2f}s) on {card}")
    runs["feature-bits"] = {"launches": launches, "chunks": chunks,
                            "genomes_per_s": stats.rate(),
                            "steady_genomes_per_s": stats.steady_rate(),
                            "total_s": stats.total_s, "wall_s": wall,
                            "sample_s": stats.sample_s,
                            "minimize_s": stats.minimize_s,
                            "records_equal_to_packed": NUM_SAMPLES}
    return runs


# ---------------------------------------------------------------------------
# phase 5: the training path
# ---------------------------------------------------------------------------

def write_training_inputs(root: Path, seed: int = 0) -> tuple[list, list]:
    """The training tree; returns (the CSV's gene names, the essentials)."""
    from genome_minimizer_2_torch.data import synthetic

    data = root / "data"
    data.mkdir(parents=True)
    genes, samples = synthetic.write_presence_absence_fast(
        data / "F4_complete_presence_absence.csv", TRAIN_GENOMES, V0_INPUT_DIM,
        seed)
    synthetic.write_phylogroups_csv(data / "accessionID_phylogroup_BD.csv",
                                    samples, seed)
    essentials = synthetic.write_essential_genes_csv(
        data / "essential_genes.csv", genes, N_ESSENTIAL, seed)
    return genes, essentials


def training_argv(extra=()) -> list:
    """The training path's CLI arguments; a later flag overrides an earlier."""
    return ["--mode", "experiment", "--device", DEVICE, "--trainer-version",
            "v0", "--hidden-dim", str(V0_HIDDEN), "--latent-dim", str(V0_LATENT),
            "--batch-size", str(TRAIN_BATCH), "--n-epochs", str(TRAIN_EPOCHS),
            "--experiment-name", "v0_smoke", "--no-generate-plots", *extra]


def training_args(extra=()):
    from genome_minimizer_2_torch import cli

    return cli.parse_arguments(training_argv(extra))


def run_training_path(card: str) -> tuple[dict, dict]:
    """The training path through the CLI; returns (results, launches)."""
    import torch

    from genome_minimizer_2_torch import cli
    from genome_minimizer_2_torch.ops import kernels as KR

    args = training_args(["--checkpoint-every", "1"])
    if not cli.check_data_availability():
        raise AssertionError("training data tree incomplete")
    KR.reset_launch_counts()
    t0 = time.perf_counter()
    results = cli.run_custom_experiment(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in KR.KERNELS}
    results["wall_s"] = wall
    rates = [results["n_train"] / s for s in results["epoch_seconds"]]
    for e, (s, r) in enumerate(zip(results["epoch_seconds"], rates)):
        log(f"training epoch {e + 1}: {s:.3f} s, {r:.1f} examples/s "
            f"(train {results['n_train']} rows + validation) on {card}")
    results["examples_per_s"] = rates
    log(f"training path: whole experiment {wall:.1f} s; launches {launches}")
    return results, launches


def check_training(results: dict, launches: dict, root: Path) -> dict:
    """Launch counts, losses, a plain recompute of epoch 2's first step and
    the saved checkpoint through load_sampler."""
    import torch

    from genome_minimizer_2_torch.core import prng
    from genome_minimizer_2_torch.data import dataset as D
    from genome_minimizer_2_torch.data import split as S
    from genome_minimizer_2_torch.ops import kernels as KR
    from genome_minimizer_2_torch.ops import losses as L
    from genome_minimizer_2_torch.ops.optimizer import AdamState, clip_adam_step
    from genome_minimizer_2_torch.sample.sampler import load_sampler
    from genome_minimizer_2_torch.train import trainer as T
    from genome_minimizer_2_torch.utils import checkpoint as ckpt
    from genome_minimizer_2_torch.utils.config import setup_experiment_config

    n_train = results["n_train"]
    steps = math.ceil(n_train / TRAIN_BATCH)
    leaves = len(v0_leaf_shapes())
    expected = {"gather_row_blocks": TRAIN_EPOCHS,
                "output_layer_bwd": TRAIN_EPOCHS * steps,
                "clip_adam_apply": TRAIN_EPOCHS * steps * leaves,
                "decode_threshold_pack": 1}  # the test set, one 2,048 batch
    log(f"training path: expected launches {expected}, counted {launches}")
    if launches != expected:
        raise AssertionError(f"launches {launches} != expected {expected}")
    tl, vl = results["train_loss_vals"], results["val_loss_vals"]
    log(f"training path: train loss {tl}, validation loss {vl}, F1 "
        f"{results['f1_overall']:.4f}, accuracy {results['accuracy_overall']:.4f}")
    if not all(math.isfinite(v) for v in tl + vl):
        raise AssertionError("non-finite loss")
    if not tl[1] < tl[0]:
        raise AssertionError(f"epoch 2 train loss {tl[1]} not below epoch 1's {tl[0]}")

    # -- epoch 2's first step, kernels vs plain versions, from the epoch-1 state
    config = setup_experiment_config(training_args())
    trainer = T.create_trainer("v0", config, V0_INPUT_DIM, device=DEVICE)
    state_file = root / "models" / "trained_models" / "v0_smoke" / "train_state_1.npz"
    state, epoch, _ = ckpt.load_train_state(state_file, trainer)
    matrix = D.load_matrix()
    sp = S.three_way_split(matrix.n_samples, config.test_size, config.val_ratio,
                           config.random_state)
    train_x = trainer.prepare_data(matrix.data[sp.train_idx])
    rng, perm_key = prng.split(state.rng)
    bperm = prng.permutation(perm_key, n_train // KR.GATHER_BLOCK)
    shuffled = KR.gather_row_blocks(train_x, bperm)
    if not torch.equal(shuffled, KR.gather_row_blocks_reference(train_x, bperm)):
        raise AssertionError("epoch-2 shuffle differs from its plain version")
    batch = shuffled[:TRAIN_BATCH]
    _, key = prng.split(rng)
    comps_k, grads_k, _ = trainer.loss_and_grads(state, batch, epoch, key)
    model, policy = state.model, trainer.model_cfg.policy
    params = model.flat_params()
    h, mu, logvar, _ = model.forward_hidden(batch, key, True)
    logits = model.output(h, policy).to(policy.logits_dtype)
    mask = trainer.model_cfg.feature_mask(DEVICE)
    kl = (L.beta_schedule(trainer.spec, epoch, state.counter)
          * L.kl_divergence(mu, logvar))
    total = L.bce_sum_logits(logits, batch, mask) + kl
    grads_p = dict(zip(params, torch.autograd.grad(
        total, list(params.values()), retain_graph=True)))
    total = float(total.detach())
    loss_k = float(comps_k["total"].detach())
    loss_rel = abs(loss_k - total) / abs(total)
    # The output layer's gradients are the kernel's own output. Its weight
    # gradient is a bf16 rounding of a float32 sum on both paths, in
    # different orders: held elementwise as in check_output_layer_bwd (1 bf16
    # ulp, or the cancellation slack); its bias gradient, a float32 sum, to
    # GRAD_RTOL of its largest value. Every other leaf receives the kernel's
    # dh through more bf16 products, whose backward rounds its gradients to
    # bf16, and through BatchNorm backwards, whose centring subtracts nearly
    # equal sums: a value's rounding can flip either way, so these leaves
    # are held in norm, to UPSTREAM_RTOL, and the margin a wrong dh has
    # against that is measured below. Linear biases ahead of a BatchNorm
    # have a zero gradient in exact arithmetic: theirs is rounding noise,
    # reported and not held.
    grad_rel, prebn = {}, {}
    for k in params:
        gk, gp = grads_k[k], grads_p[k]
        if k.endswith("/b") and k.split("/")[0] in ("encoder", "decoder") \
                and k != "decoder/3/b":
            prebn[k] = float(torch.maximum(gk.abs().max(), gp.abs().max()))
        elif k == "decoder/3/b":
            grad_rel[k] = float((gk - gp).abs().max() / gp.abs().max()) / GRAD_RTOL
        elif k != "decoder/3/w":
            grad_rel[k] = float((gk - gp).norm() / gp.norm()) / UPSTREAM_RTOL
    dl = KR.output_layer_dl(logits.detach(), batch, mask, torch.ones((), device=DEVICE))
    terms = torch.mm(h.detach().to(torch.bfloat16).t().abs(),
                     dl.to(torch.bfloat16).abs(), out_dtype=torch.float32)
    w_out_bad = bf16_outside(grads_k["decoder/3/w"], grads_p["decoder/3/w"], terms)
    w_out_ulp1 = int((bf16_ulps(grads_k["decoder/3/w"], grads_p["decoder/3/w"]) == 1).sum())
    del dl, terms
    worst = max(grad_rel, key=grad_rel.get)
    log(f"step recompute: loss {loss_k:.6f} vs plain {total:.6f} "
        f"({loss_rel:.3g} relative); output-layer weight gradient: "
        f"{w_out_ulp1} of {grads_p['decoder/3/w'].numel()} elements 1 bf16 ulp "
        f"apart, {w_out_bad} beyond 1 ulp and the cancellation slack; bias "
        f"gradient within {grad_rel['decoder/3/b'] * GRAD_RTOL:.3g} of its max "
        f"(tolerance {GRAD_RTOL}); worst leaf against its tolerance: {worst} at "
        f"{grad_rel[worst]:.3g}x; pre-BatchNorm bias gradients (rounding noise) "
        f"up to {max(prebn.values()):.3g}")
    if loss_rel > 1e-5 or grad_rel[worst] > 1.0 or w_out_bad:
        raise AssertionError("kernel step and plain step disagree")

    # -- the margin: the upstream leaves' gradients from the plain dh and
    # from a dh with one of its (64, 128) tiles zeroed (one block of the
    # kernel's dh launch left unwritten), the rest of the backward as it is
    upstream = [k for k in grad_rel if k != "decoder/3/b"]
    dh = KR.output_layer_bwd_reference(
        logits.detach(), batch, mask, h.detach(), params["decoder/3/w"].detach(),
        torch.ones((), device=DEVICE))[2]

    def upstream_grads(dh_):
        return torch.autograd.grad((h, kl), [params[k] for k in upstream],
                                   (dh_, torch.ones_like(kl)), retain_graph=True)

    bad = dh.clone()
    bad[:64, :128] = 0.0
    fault = {k: float((a - b).norm() / b.norm()) / UPSTREAM_RTOL for k, a, b in
             zip(upstream, upstream_grads(bad), upstream_grads(dh))}
    caught = max(fault, key=fault.get)
    log(f"step recompute: a dh with one (64, 128) tile zeroed moves the "
        f"upstream leaves by {min(fault.values()):.3g}x to {fault[caught]:.3g}x "
        f"their tolerance (worst {caught})")
    if fault[caught] <= 1.0:
        raise AssertionError("the upstream tolerance would pass a wrong dh")

    lr = torch.full((), T.step_lr(config.learning_rate, config.scheduler_step_size,
                                  config.scheduler_gamma, epoch), device=DEVICE)

    def updated(grads, apply_leaf):
        p = {k: v.detach().clone() for k, v in params.items()}
        opt = AdamState(state.opt.count.clone(),
                        {k: v.clone() for k, v in state.opt.mu.items()},
                        {k: v.clone() for k, v in state.opt.nu.items()})
        clip_adam_step(p, grads, opt, lr, config.max_norm, apply_leaf)
        return p

    p_kernel = updated(grads_k, KR.clip_adam_apply)
    p_plain_update = updated(grads_k, KR.clip_adam_apply_reference)
    p_plain = updated(grads_p, KR.clip_adam_apply_reference)
    update_ulp = max(ulp_distance(p_kernel[k], p_plain_update[k]) for k in params)
    lr_value = float(lr)
    # The all-plain step is held where the two gradients agree to 1e-3 of
    # the plain one. There Adam's step lr * u, u = m^ / (sqrt(v^) + eps),
    # moves by at most (0.58 + |u|) x the gradient's relative difference
    # plus the same times the clip factor's (the global norms differ by at
    # most the worst leaf, under UPSTREAM_RTOL); |u| <= 1 at this count
    # (Cauchy-Schwarz over four steps): under 2e-2 x lr. Elsewhere a
    # gradient near zero turns its rounding into a step of up to a few lr,
    # which is reported; the pre-BatchNorm biases are left out.
    held, moved, n_held, n_all = 0.0, 0.0, 0, 0
    for k in params:
        if k in prebn:
            continue
        diff = (p_kernel[k] - p_plain[k]).abs()
        agree = (grads_k[k] - grads_p[k]).abs() <= 1e-3 * grads_p[k].abs()
        held = max(held, float((diff * agree).max()) / lr_value)
        moved = max(moved, float(diff.max()) / lr_value)
        n_held, n_all = n_held + int(agree.sum()), n_all + diff.numel()
    log(f"step recompute: update kernel vs plain from the same gradients: max "
        f"{update_ulp} ulp; params after the kernel step vs the all-plain step: "
        f"max |diff| {held:.3g} x lr over the {n_held} of {n_all} values whose "
        f"gradients agree to 1e-3 (tolerance 2e-2 x lr), {moved:.3g} x lr over "
        f"all (pre-BatchNorm biases excluded)")
    if update_ulp > 1 or held > 2e-2:
        raise AssertionError("kernel step params disagree with the plain step")

    # -- the saved checkpoint through load_sampler, one decoded chunk
    sampler, _ = load_sampler(results["model_path"], device=DEVICE)
    packed, z = sampler.sample_packed(prng.key(0, DEVICE), CHUNK)
    with torch.no_grad():
        hz = sampler.model.decode_hidden(torch.as_tensor(z, device=DEVICE))
        cd = sampler.cfg.policy.compute_dtype
        w_out, b_out = sampler.model.output.w, sampler.model.output.b
        ref_logits = KR.decode_logits_reference(hz, w_out, b_out, cd)
        ref = KR.decode_threshold_pack_reference(hz, w_out, b_out, cd)
    D_ = V0_INPUT_DIM
    got = KR.unpack_bits(packed, D_)
    want = KR.unpack_bits(ref[:, : (D_ + 7) // 8].cpu().numpy(), D_)
    diff = got != want
    near = ref_logits[:, :D_].abs().cpu().numpy() < NEAR_ZERO
    if packed.shape != (CHUNK, (D_ + 7) // 8) or (diff & ~near).any():
        raise AssertionError("checkpoint decode differs from its plain recompute")
    genes = got.sum(axis=1)
    log(f"checkpoint -> load_sampler -> {CHUNK} genomes decoded: {int(diff.sum())} "
        f"bits differ from the plain decode, all at |logit| < {NEAR_ZERO}; "
        f"genes per genome {int(genes.min())}-{int(genes.max())} of {D_}")
    checks = {"expected_launches": expected, "step_loss_rel": loss_rel,
            "step_grad_worst_vs_tolerance": {worst: grad_rel[worst]},
            "step_out_w_elements_1ulp": w_out_ulp1,
            "step_upstream_worst_vs_tolerance": max(grad_rel[k] for k in grad_rel
                                                    if k != "decoder/3/b"),
            "step_dh_tile_fault_vs_tolerance": {caught: fault[caught]},
            "step_update_ulp": update_ulp, "step_param_held_max_lr": held,
            "step_param_held_values": n_held, "step_param_max_lr": moved,
            "decode_bits_differing": int(diff.sum())}
    return checks, (trainer, state, train_x, epoch)


# ---------------------------------------------------------------------------
# phase 5: the staged workflow from the trained checkpoint
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def logged_stdout(path: Path):
    """Send a stage's stdout (the minimizer prints a line per genome) to a
    file; on failure print its tail."""
    with open(path, "w") as f:
        try:
            with contextlib.redirect_stdout(f):
                yield
        except BaseException:
            f.flush()
            print(path.read_text()[-4000:], flush=True)
            raise


def staged_mismatches(staged: str, pipe: str) -> list:
    """Indices of the records of two FASTA files that differ; raises if
    their headers or record counts differ."""
    diff, n = [], 0
    got = iter_records(pipe, header=True)
    for i, (head, seq) in enumerate(iter_records(staged, header=True)):
        other = next(got, None)
        if other is None or other[0] != head:
            raise AssertionError(f"record {i}: header {head[:60]!r} against "
                                 f"{None if other is None else other[0][:60]!r}")
        if other[1] != seq:
            diff.append(i)
        n += 1
    if next(got, None) is not None or n != NUM_SAMPLES:
        raise AssertionError(f"record counts differ ({n} staged)")
    return diff


def check_staged_bits(model_path: str, genbank: str, staged, diff: list) -> dict:
    """The sample file's bits (``staged``, default mode, seed 0) against the
    plain decode of the same latents on the card: a bit may differ only where
    its logit is within NEAR_ZERO of 0. Each record of ``diff`` (where the
    staged FASTA differs from the pipeline's) must hold a FASTA-relevant bit
    within NEAR_ZERO of 0, and they are capped by check_excused."""
    import numpy as np
    import torch

    from genome_minimizer_2_torch.core import prng

    sampler, _, _, _, relevant = plain_lookup(model_path, genbank)
    D = sampler.cfg.input_dim
    near_rows = np.zeros(NUM_SAMPLES, bool)
    diff_bits = near_bits = 0
    for lo in range(0, NUM_SAMPLES, CHUNK):
        hi = min(lo + CHUNK, NUM_SAMPLES)
        z = prng.draw_latents(prng.key(0, DEVICE),
                              torch.arange(lo, hi, device=DEVICE),
                              sampler.cfg.latent_dim)
        logits, packed = plain_decode(sampler, z)
        got = torch.as_tensor(staged[lo:hi], device=DEVICE)
        flips = unpack_bits_dev(got ^ packed, D).bool()
        near = logits.abs() < NEAR_ZERO
        if (flips & ~near).any():
            raise AssertionError(f"sample mode's bits in rows {lo}-{hi} differ "
                                 f"from the plain decode at |logit| >= {NEAR_ZERO}")
        diff_bits += int(flips.sum())
        near_bits += int(near.sum())
        near_rows[lo:hi] = near[:, relevant].any(dim=1).cpu().numpy()
    bad = [i for i in diff if not near_rows[i]]
    if bad:
        raise AssertionError(f"staged records {bad[:10]} differ from the "
                             f"pipeline's with no relevant logit within "
                             f"{NEAR_ZERO} of 0")
    check_excused("staged vs pipeline", len(diff), NUM_SAMPLES)
    log(f"staged bits vs plain decode: {diff_bits} of {NUM_SAMPLES * D} bits "
        f"differ, all among the {near_bits} at |logit| < {NEAR_ZERO}; "
        f"{int(near_rows.sum())} of {NUM_SAMPLES} records hold a relevant such "
        f"bit")
    return {"bits_differing": diff_bits, "near_zero_bits": near_bits,
            "near_zero_records": int(near_rows.sum())}


def run_staged_path(results: dict, genes: list, essentials: list, root: Path,
                    card: str) -> dict:
    """--mode sample -> convert-samples -> minimizer from the trained
    checkpoint, against --mode pipeline from the same checkpoint and seed."""
    import pickle

    import numpy as np

    from genome_minimizer_2_torch import cli
    from genome_minimizer_2_torch.ops import kernels as KR
    from genome_minimizer_2_torch.sample import sampler as SMP
    from genome_minimizer_2_torch.utils import directories

    data = root / "data"
    # the essential genes are CSV columns here, so each maps to its own
    # column, as --mode preprocess would map it (without parsing the CSV)
    col = {g: i for i, g in enumerate(genes)}
    positions = {g: [col[g]] for g in essentials if g in col}
    pos_path = Path(directories.essential_genes_positions())
    pos_path.parent.mkdir(parents=True, exist_ok=True)
    with open(pos_path, "wb") as f:
        pickle.dump(positions, f)
    gb = str(write_genbank(data / "wild_type_sequence.gb", genes,
                           np.random.RandomState(1)))
    model = results["model_path"]
    common = ["--device", DEVICE, "--model-name", "v0_smoke", "--genome-path", gb]
    timings, launches = {}, {}

    def stage(name, runner, argv):
        KR.decode_threshold_pack.launches = 0
        t0 = time.perf_counter()
        with logged_stdout(root / f"{name}.log"):
            out = runner(cli.parse_arguments(argv + common))
        timings[name] = time.perf_counter() - t0
        launches[name] = KR.decode_threshold_pack.launches
        if out is None:
            raise AssertionError(f"{name}: the mode did not run")
        log(f"staged {name}: {timings[name]:.2f}s wall, "
            f"{NUM_SAMPLES / timings[name]:.1f} genomes/s on {card}")
        return out

    sample = stage("sample", cli.run_sampling, [
        "--mode", "sample", "--model-path", model, "--num-samples",
        str(NUM_SAMPLES), "--save-dtype", "packed", "--no-csv",
        "--no-generate-plots", "--seed", "0"])
    ids = str(root / "staged_ids.npy")
    conv = stage("convert-samples", cli.run_binary_converter, [
        "--mode", "convert-samples", "--genes-path", sample["samples_path"],
        "--output-file", ids])
    staged = str(root / "staged.fasta")
    minimized = stage("minimizer", cli.run_genome_minimizer, [
        "--mode", "minimizer", "--genes-path", conv["with_essentials"],
        "--output-file", staged])
    pipe = str(root / "pipeline.fasta")
    piped = stage("pipeline", cli.run_pipeline, [
        "--mode", "pipeline", "--model-path", model, "--num-samples",
        str(NUM_SAMPLES), "--chunk-size", str(CHUNK), "--seed", "0",
        "--output-file", pipe])

    chunks = {"sample": math.ceil(NUM_SAMPLES / SAMPLER_CHUNK),
              "convert-samples": 0, "minimizer": 0,
              "pipeline": math.ceil(NUM_SAMPLES / CHUNK)}
    log(f"staged path: decode launches {launches}, chunks {chunks}")
    if launches != chunks:
        raise AssertionError(f"decode launches {launches} != chunks {chunks}")

    # sample mode's analytics against a host recompute from its .npz
    with np.load(sample["samples_path"]) as z:
        packed, width = z["packed"], int(z["input_dim"])
    if packed.shape != (NUM_SAMPLES, (V0_INPUT_DIM + 7) // 8) or width != V0_INPUT_DIM:
        raise AssertionError(f"samples file holds {packed.shape}, {width}")
    sizes = SMP.popcount_rows(packed)
    counts = SMP.count_essential_genes_packed(packed, positions, width)
    if not (np.array_equal(sizes, sample["genome_sizes"])
            and np.array_equal(counts, sample["essential_counts"])):
        raise AssertionError("sample mode's sizes or essential counts differ "
                             "from the recompute")

    t0 = time.perf_counter()
    if minimized["genome_count"] != NUM_SAMPLES or piped.genomes != NUM_SAMPLES:
        raise AssertionError(f"{minimized['genome_count']} staged and "
                             f"{piped.genomes} pipeline records")
    # one pass over 16 MB blocks when the files agree (each is ~6.5 GB);
    # record by record only to find the ones that differ
    diff = [] if same_records(staged, pipe) else staged_mismatches(staged, pipe)
    bits = check_staged_bits(model, gb, packed, diff)
    log(f"staged vs pipeline: {NUM_SAMPLES - len(diff)} of {NUM_SAMPLES} records "
        f"byte-equal, {len(diff)} differ and hold a relevant bit with |logit| < "
        f"{NEAR_ZERO} (cap {int(MAX_EXCUSED_FRACTION * NUM_SAMPLES)}; compared "
        f"in {time.perf_counter() - t0:.1f}s); sample "
        f"mode's sizes {int(sizes.min())}-{int(sizes.max())} genes and essential "
        f"counts {int(counts.min())}-{int(counts.max())} of {len(positions)} "
        f"equal the host recompute")
    return {"wall_s": timings, "launches": launches, "chunks": chunks,
            "genomes_per_s": {k: NUM_SAMPLES / v for k, v in timings.items()},
            "records_equal": NUM_SAMPLES - len(diff),
            "near_zero_mismatch": len(diff), **bits,
            "samples_path": sample["samples_path"], "genbank": gb}


def device_busy(trace_path: str) -> tuple[float, dict]:
    """Device busy seconds in a Chrome trace: the union of its kernel,
    memcpy and memset spans (op-level profiler averages would count a copy
    twice), and {name: (total us, count)} per device activity."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    if not spans:
        raise AssertionError("the profiler recorded no device activity")
    busy_us, end = 0.0, float("-inf")
    by_name: dict = {}
    for t0, t1, name in spans:
        busy_us += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + t1 - t0, cnt + 1)
    return busy_us / 1e6, by_name


def profile_main_path(inputs: dict, root: Path, trace_dir: str) -> dict:
    """One default-mode pipeline run under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from genome_minimizer_2_torch import cli

    args = cli.parse_arguments([
        "--mode", "pipeline", "--device", DEVICE,
        "--model-path", inputs["model"], "--genome-path", inputs["genbank"],
        "--output-file", str(root / "smoke.fasta"), "--num-samples",
        str(NUM_SAMPLES // 2), "--chunk-size", str(CHUNK), "--seed", "1"])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stats = cli.run_pipeline(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    os.makedirs(trace_dir, exist_ok=True)
    trace = os.path.join(trace_dir, "pipeline_trace.json")
    prof.export_chrome_trace(trace)
    busy_s, by_name = device_busy(trace)
    log(f"profile: wall {wall:.3f}s, device busy {busy_s:.4f}s "
        f"({100 * busy_s / wall:.3f}% of wall), {stats.genomes} genomes, "
        f"pipeline total {stats.total_s:.3f}s, minimize {stats.minimize_s:.3f}s")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (tot, cnt) in top:
        log(f"  {tot / 1e3:10.3f} ms  x{cnt:<5d} {name[:90]}")
    return {"wall_s": wall, "device_busy_s": busy_s,
            "device_busy_share": busy_s / wall,
            "top": [(n[:90], tot / 1e3, cnt) for n, (tot, cnt) in top]}


def profile_training(trainer, state, train_x, epoch: int, trace_dir: str) -> dict:
    """One more training epoch (the shuffle and 3 steps) from the epoch-1
    state under torch.profiler: device time by kernel and busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    lr = torch.full((), trainer.config.learning_rate, device=DEVICE)
    n = train_x.shape[0]
    trainer.run_epoch(state, train_x, n, epoch, lr, train=True)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run_epoch(state, train_x, n, epoch, lr, train=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    os.makedirs(trace_dir, exist_ok=True)
    trace = os.path.join(trace_dir, "train_epoch_trace.json")
    prof.export_chrome_trace(trace)
    busy_s, by_name = device_busy(trace)
    log(f"profile training: one epoch of {n} rows, wall {wall:.4f}s, device "
        f"busy {busy_s:.4f}s ({100 * busy_s / wall:.2f}% of wall)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:16]
    for name, (tot, cnt) in top:
        log(f"  {tot / 1e3:10.3f} ms  x{cnt:<5d} {name[:90]}")
    return {"wall_s": wall, "device_busy_s": busy_s,
            "device_busy_share": busy_s / wall,
            "top": [(nm[:90], tot / 1e3, cnt) for nm, (tot, cnt) in top]}


# ---------------------------------------------------------------------------
# phase 6: elastic restarts, the trace, the NCCL bring-up, data parallel
# ---------------------------------------------------------------------------

ELASTIC_EPOCHS = 3
DP_RTOL, DP_ATOL = 2e-4, 1e-5  # the JAX contract, tests/test_multiprocess.py:90-96
# bf16: the relative gap the port's bf16 tests allow between two valid bf16
# computations of one step's gradients (BF16_STEP_RTOL,
# tests/test_torch_train_ops.py); the W = 2 step rounds each rank's dW and
# dh to bf16 before the sum, one process rounds the sum once
BF16_DP_RTOL = 6e-3
TRACE_RANGES = ("gm2/shuffle", "gm2/train_step", "gm2/validation",
                "gm2/checkpoint")
# the CUDA kernels of a training step: the shuffle, the output layer's
# backward (its cotangent pass and its tensor-core products), clip + Adam
TRACE_KERNELS = ("gather_bulk_kernel", "dl_pass_kernel", "gemm_kernel",
                 "clip_adam_kernel")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def check_launches(what: str, got: dict, want: dict) -> None:
    if got != want:
        raise AssertionError(f"{what}: launches {got} != expected {want}")


def launch_counts() -> dict:
    from genome_minimizer_2_torch.ops import kernels as KR

    return {fn.__name__: fn.launches for fn in KR.KERNELS}


def experiment_runner(extra, data=None):
    """An IntegratedExperimentRunner for the training path's config plus
    ``extra`` flags, its model built; ``data`` = (matrix, splits) of an
    earlier runner, else read from the cache."""
    from genome_minimizer_2_torch.experiments import IntegratedExperimentRunner
    from genome_minimizer_2_torch.utils.config import setup_experiment_config

    runner = IntegratedExperimentRunner(
        setup_experiment_config(training_args(extra)), device=DEVICE)
    if data is None:
        runner.prep_data()
    else:
        runner._matrix, runner._splits = data
        runner.input_dim = data[0].n_genes
    runner.setup_model_and_training()
    return runner


def run_elastic(card: str) -> tuple[dict, tuple]:
    """v0 for 3 epochs with a checkpoint each epoch and max_restarts 1, once
    uninterrupted and once with a crash injected after the epoch-1
    checkpoint; histories and final parameters must be bit-equal."""
    import torch

    from genome_minimizer_2_torch.ops import kernels as KR
    from genome_minimizer_2_torch.train import trainer as T

    data, out = None, {}
    for name in ("straight", "crashed"):
        runner = experiment_runner(
            ["--n-epochs", str(ELASTIC_EPOCHS), "--checkpoint-every", "1",
             "--max-restarts", "1", "--experiment-name", f"v0_elastic_{name}"],
            data)
        data = runner._matrix, runner._splits
        crashed = []
        if name == "crashed":
            trainer = runner.trainer

            def boom(epoch, tr, vl):
                if epoch == 1 and not crashed:
                    crashed.append(epoch)
                    raise RuntimeError("crash injected by chip_smoke.py")

            def train(*args, **kwargs):
                kwargs["progress_cb"] = boom
                return T.VAETrainer.train(trainer, *args, **kwargs)

            trainer.train = train
        KR.reset_launch_counts()
        t0 = time.perf_counter()
        runner.train_model()
        runner.calculate_metrics()
        torch.cuda.synchronize()
        out[name] = {"wall_s": time.perf_counter() - t0,
                     "launches": launch_counts(),
                     "restarts": runner.results["restarts"],
                     "crashed_at": crashed, "runner": runner}
        log(f"elastic {name}: {out[name]['wall_s']:.1f}s, restarts "
            f"{out[name]['restarts']}, launches {out[name]['launches']} on {card}")
    n_train = out["straight"]["runner"].results["n_train"]
    steps, leaves = math.ceil(n_train / TRAIN_BATCH), len(v0_leaf_shapes())
    for name, epochs in (("straight", ELASTIC_EPOCHS), ("crashed", ELASTIC_EPOCHS + 1)):
        want = {"decode_threshold_pack": 1, "gather_row_blocks": epochs,
                "output_layer_bwd": epochs * steps,
                "clip_adam_apply": epochs * steps * leaves}
        check_launches(f"elastic {name}", out[name]["launches"], want)
    a, b = out["straight"]["runner"], out["crashed"]["runner"]
    if out["crashed"]["crashed_at"] != [1] or out["crashed"]["restarts"] != 1:
        raise AssertionError("the injected crash did not restart training once")
    gaps = {}
    for key in ("train_loss_vals", "val_loss_vals"):
        x, y = a.results[key], b.results[key]
        if x != y:
            gaps[key] = max(abs(p - q) for p, q in zip(x, y))
    sa, sb = a.trainer.final_state, b.trainer.final_state
    for what, da, db in (("params", sa.params, sb.params),
                         ("batch_stats", sa.batch_stats, sb.batch_stats),
                         ("adam mu", sa.opt.mu, sb.opt.mu),
                         ("adam nu", sa.opt.nu, sb.opt.nu)):
        for k in da:
            if not torch.equal(da[k], db[k]):
                gaps[f"{what}/{k}"] = float((da[k].float() - db[k].float()).abs().max())
    if gaps:
        # a run and its restart take the same shapes in the same order: any
        # gap is an operation on the card that is not deterministic
        log(f"elastic: NOT bit-equal: {gaps}")
        raise AssertionError(f"restarted run differs from the uninterrupted "
                             f"one (non-deterministic op on the card): {gaps}")
    log(f"elastic: crash after the epoch-1 checkpoint, 1 restart; loss "
        f"histories {a.results['train_loss_vals']} and every parameter, "
        f"BatchNorm statistic and Adam moment bit-equal to the uninterrupted run")
    summary = {n: {k: v for k, v in o.items() if k != "runner"}
               for n, o in out.items()}
    return summary, data


def trace_window_busy(events) -> tuple[float, float]:
    """(device busy s, window s) over the traced epoch: from the first
    shuffle range to the end of validation, device spans (kernels, copies,
    fills) united."""
    ranges = [e for e in events if e.get("name") in TRACE_RANGES
              and e.get("ph") == "X"]
    lo = min(e["ts"] for e in ranges if e["name"] == "gm2/shuffle")
    hi = max(e["ts"] + e["dur"] for e in ranges if e["name"] == "gm2/validation")
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                   and lo <= e["ts"] < hi)
    busy, end = 0.0, float("-inf")
    for t0, t1 in spans:
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    return busy / 1e6, (max(hi, end) - lo) / 1e6


def run_trace(data, root: Path, card: str) -> dict:
    """One epoch through the runner with GM2_PROFILE_DIR set: the trace file
    must hold the trainer's ranges and the training kernels."""
    import torch

    from genome_minimizer_2_torch.ops import kernels as KR

    runner = experiment_runner(["--n-epochs", "1", "--checkpoint-every", "1",
                                "--experiment-name", "v0_trace"], data)
    trace_dir = root / "trace"
    os.environ["GM2_PROFILE_DIR"] = str(trace_dir)
    try:
        KR.reset_launch_counts()
        t0 = time.perf_counter()
        runner.train_model()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del os.environ["GM2_PROFILE_DIR"]
    files = sorted(trace_dir.glob("gm2_rank0.*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"GM2_PROFILE_DIR: trace files {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    missing = [r for r in TRACE_RANGES if r not in names]
    missing += [k for k in TRACE_KERNELS if not any(k in n for n in names)]
    if missing:
        raise AssertionError(f"the trace lacks {missing}")
    busy, window = trace_window_busy(events)
    launches = launch_counts()
    steps = math.ceil(runner.results["n_train"] / TRAIN_BATCH)
    want = {"decode_threshold_pack": 0, "gather_row_blocks": 1,
            "output_layer_bwd": steps,
            "clip_adam_apply": steps * len(v0_leaf_shapes())}
    check_launches("trace", launches, want)
    log(f"trace: {files[0].name} ({files[0].stat().st_size / 1e6:.1f} MB), "
        f"ranges {list(TRACE_RANGES)} and kernels {list(TRACE_KERNELS)} "
        f"present; traced epoch: device busy {busy:.4f}s of {window:.4f}s "
        f"({100 * busy / window:.2f}%); train_model {wall:.1f}s under the "
        f"profiler; launches {launches} on {card}")
    return {"file_mb": files[0].stat().st_size / 1e6, "wall_s": wall,
            "epoch_window_s": window, "device_busy_s": busy,
            "device_busy_share": busy / window, "launches": launches}


def run_nccl_bringup(results: dict, expected: dict, root: Path,
                     card: str) -> dict:
    """The CLI under torchrun's variables for one rank: --mode experiment
    --data-parallel 0 forms an NCCL group of 1 and must train bit-equal to
    the run with no group (phase 5)."""
    import numpy as np

    from genome_minimizer_2_torch import cli
    from genome_minimizer_2_torch.ops import kernels as KR

    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port())}
    os.environ.update(env)
    logfile = root / "nccl.log"
    try:
        KR.reset_launch_counts()
        t0 = time.perf_counter()
        with logged_stdout(logfile):
            rc = cli.main(training_argv(["--checkpoint-every", "1",
                                         "--data-parallel", "0",
                                         "--experiment-name", "v0_nccl"]))
        wall = time.perf_counter() - t0
    finally:
        for k in env:
            del os.environ[k]
    launches = launch_counts()
    check_launches("NCCL bring-up", launches, expected)
    text = logfile.read_text()
    backend = "nccl" if DEVICE == "cuda" else "gloo"
    if rc != 0 or f"(process 1/1, {backend})" not in text:
        raise AssertionError(f"the CLI did not run in an {backend} group (rc {rc})")
    models = root / "models" / "trained_models"
    for epoch in range(1, TRAIN_EPOCHS + 1):
        with np.load(models / "v0_nccl" / f"train_state_{epoch}.npz") as a, \
                np.load(models / "v0_smoke" / f"train_state_{epoch}.npz") as b:
            if set(a.files) != set(b.files):
                raise AssertionError("NCCL run's train state has other leaves")
            for k in a.files:
                if k != "__config_json__" and not np.array_equal(a[k], b[k]):
                    raise AssertionError(f"NCCL W = 1 train state, epoch {epoch}, "
                                         f"{k} differs from the run with no group")
            extra = json.loads(bytes(a["__config_json__"]).decode())["extra"]
    if (extra["train_losses"]["total"] != results["train_loss_vals"]
            or extra["val_losses"]["total"] != results["val_loss_vals"]):
        raise AssertionError("NCCL W = 1 loss history differs")
    log(f"NCCL bring-up: '(process 1/1, {backend})', {wall:.1f}s; loss history and "
        f"both train-state files bit-equal to the run with no group; "
        f"launches {launches} on {card}")
    return {"wall_s": wall, "launches": launches}


def dp_step_gaps(trainer, train_x) -> dict:
    """A train step from the initial state on epoch 1's first batch, on W
    ranks (this rank's share, gradients summed over the ranks) and on one
    process (the whole global batch, here, with no collective): the loss's
    and every leaf's relative gap in norm. It takes epoch 2's schedule
    (beta 0.5): at beta 0 the mean head's bias, like the pre-BatchNorm
    Linear biases, has a zero gradient in exact arithmetic (BatchNorm
    removes a shift common to all rows). The pre-BatchNorm biases' gradient
    is rounding noise: its largest value is reported, not held. The same
    step with each rank's own BatchNorm statistics (a wrong data axis) gives
    the margin of the bounds."""
    import torch

    from genome_minimizer_2_torch.core import prng
    from genome_minimizer_2_torch.models import vae

    n, B, axis = train_x.shape[0], trainer.config.batch_size, trainer.axis
    state = trainer.init_state()
    rng, perm_key = prng.split(state.rng)
    order = prng.permutation(perm_key, n)
    _, key = prng.split(rng)
    rows, batches = trainer._shard_rows(trainer.prepare_data(train_x), n, order)
    lo, hi, share = batches[0]
    comps, grads, _ = trainer.loss_and_grads(state, rows[lo:hi], 1, key, share)
    grads = trainer._sum_over_ranks(grads)
    total = float(axis.all_reduce_(comps["total"].detach().clone()))
    block_forward = vae.Block.forward
    vae.Block.forward = lambda self, x, policy, train=False, share=None: \
        block_forward(self, x, policy, train, None)
    try:
        _, trap, _ = trainer.loss_and_grads(state, rows[lo:hi], 1, key, share)
        trap = trainer._sum_over_ranks(trap)
    finally:
        vae.Block.forward = block_forward
    del rows
    trainer.axis = None  # the one-process code, on the whole batch
    try:
        batch = trainer.prepare_data(train_x).index_select(0, order[:B])
        comps1, grads1, _ = trainer.loss_and_grads(trainer.init_state(), batch,
                                                   1, key)
    finally:
        trainer.axis = axis
    gaps, traps, prebn = {}, {}, {}
    for k, g in grads.items():
        g1 = grads1[k]
        if k.split("/")[0] in ("encoder", "decoder") and k.endswith("/b") \
                and k != "decoder/3/b":
            prebn[k] = float(torch.maximum(g.abs().max(), g1.abs().max()))
        else:
            gaps[k] = float((g - g1).norm() / g1.norm())
            traps[k] = float((trap[k] - g1).norm() / g1.norm())
    total1 = float(comps1["total"])
    return {"loss_gap": abs(total - total1) / abs(total1), "grad_gaps": gaps,
            "trap_gaps": traps, "prebn_max": max(prebn.values())}


def dp_worker(rank: int, world: int, port: int, model_path: str,
              genbank: str) -> int:
    """One rank of phase 6's data-parallel check (a subprocess): a gloo group
    of ``world`` ranks on the one card; trains v0 at float32 and bf16
    through the runner, then runs --mode sample --data-parallel; prints one
    JSON line."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from genome_minimizer_2_torch import cli
    from genome_minimizer_2_torch.ops import kernels as KR
    from genome_minimizer_2_torch.parallel.mesh import local_row_range

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    out, data = {"rank": rank}, None
    for name, dtype in (("float32", "float32"), ("bfloat16", "auto")):
        runner = experiment_runner(["--compute-dtype", dtype, "--data-parallel",
                                    "0", "--experiment-name", f"v0_dp_{name}"],
                                   data)
        data = runner._matrix, runner._splits
        step = dp_step_gaps(runner.trainer, data[0].data[data[1].train_idx])
        torch.cuda.empty_cache()
        rows, prepare = [], runner.trainer.prepare_data

        def recording(x, prepare=prepare, rows=rows):
            t = prepare(x)
            rows.append([int(np.shape(x)[0]), int(t.shape[0])])
            return t

        runner.trainer.prepare_data = recording
        KR.reset_launch_counts()
        t0 = time.perf_counter()
        runner.train_model()
        runner.calculate_metrics()
        torch.cuda.synchronize()
        out[name] = {"train": runner.results["train_loss_vals"],
                     "val": runner.results["val_loss_vals"],
                     "rows": rows, "launches": launch_counts(), "step": step,
                     "wall_s": time.perf_counter() - t0,
                     "shares": [list(local_row_range(n, rank, world))
                                for n, _ in rows]}
        del runner
        torch.cuda.empty_cache()
    KR.reset_launch_counts()
    t0 = time.perf_counter()
    args = cli.parse_arguments([
        "--mode", "sample", "--device", DEVICE, "--model-path", model_path,
        "--num-samples", str(NUM_SAMPLES), "--save-dtype", "packed", "--no-csv",
        "--no-generate-plots", "--seed", "0", "--model-name", "v0_smoke",
        "--genome-path", genbank, "--data-parallel", str(world)])
    res = cli.run_sampling(args)
    torch.cuda.synchronize()
    out["sample"] = {"path": res["samples_path"], "launches": launch_counts(),
                     "wall_s": time.perf_counter() - t0}
    dist.barrier()
    dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


def run_data_parallel(results: dict, staged: dict, data, root: Path,
                      card: str) -> dict:
    """Two ranks on the one card (gloo): float32 and bf16 v0 training and
    data-parallel --mode sample, against one process."""
    import torch

    # the W = 1 references take the exact row permutation, as W = 2 does
    # (and the JAX trainer under any mesh larger than 1): the block shuffle
    # of one card draws another order of the rows
    refs, t0 = {}, time.perf_counter()
    for name, dtype in (("float32", "float32"), ("bfloat16", "auto")):
        ref = experiment_runner(["--compute-dtype", dtype, "--experiment-name",
                                 f"v0_w1_{name}"], data)
        ref.config.use_pallas_gather = False
        ref.train_model()
        refs[name] = (ref.results["train_loss_vals"], ref.results["val_loss_vals"])
        del ref
        torch.cuda.empty_cache()
    ref_wall = time.perf_counter() - t0
    log(f"data parallel: W = 1 references (row permutation) {ref_wall:.1f}s, "
        f"losses {refs}")
    one = Path(staged["samples_path"])
    kept = root / "sample_one_process.npz"
    shutil.move(one, kept)

    world, port = 2, free_port()
    logs = [root / f"dp_rank{r}.log" for r in range(world)]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="4")
    t0 = time.perf_counter()
    procs = []
    for r in range(world):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--dp-worker",
                 str(r), str(world), str(port), results["model_path"],
                 staged["genbank"]], stdout=f, stderr=subprocess.STDOUT,
                env=env, cwd=str(REPO)))
    try:
        rcs = [p.wait(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    outs = []
    for r, (rc, path) in enumerate(zip(rcs, logs)):
        text = path.read_text()
        if rc != 0:
            print(text[-6000:], flush=True)
            raise AssertionError(f"data-parallel rank {r} exited {rc}")
        outs.append(json.loads([line for line in text.splitlines()
                                if line.startswith('{"rank"')][-1]))
    for o in outs:
        log(f"data parallel rank {o['rank']}: launches float32 "
            f"{o['float32']['launches']}, bf16 {o['bfloat16']['launches']}, "
            f"sample {o['sample']['launches']}; rows held (of the set) "
            f"{o['float32']['rows']}")
    steps = math.ceil(results["n_train"] / TRAIN_BATCH)
    want = {"gather_row_blocks": 0, "output_layer_bwd": TRAIN_EPOCHS * steps,
            "clip_adam_apply": TRAIN_EPOCHS * steps * len(v0_leaf_shapes()),
            "decode_threshold_pack": 1}
    want_sample = {"gather_row_blocks": 0, "output_layer_bwd": 0,
                   "clip_adam_apply": 0,
                   "decode_threshold_pack": math.ceil(NUM_SAMPLES / SAMPLER_CHUNK)}
    gaps = {}
    for name, bound in (("float32", DP_RTOL), ("bfloat16", BF16_DP_RTOL)):
        base = refs[name]
        for o in outs:
            if (o[name]["train"], o[name]["val"]) != (outs[0][name]["train"],
                                                      outs[0][name]["val"]):
                raise AssertionError(f"{name}: ranks report different histories")
            if any(held != hi - lo for (_, held), (lo, hi) in
                   zip(o[name]["rows"], o[name]["shares"])):
                raise AssertionError(f"{name}: rank {o['rank']} held "
                                     f"{o[name]['rows']}, not its share")
            check_launches(f"data parallel {name}, rank {o['rank']}",
                           o[name]["launches"], want)
        # the first step, W = 2 against one process from the same state and
        # global batch: the loss, and the output layer's gradients (products
        # and sums, no BatchNorm behind them) to the bound. At float32 every
        # other leaf, which receives its gradient through BatchNorm
        # backwards whose centring subtracts nearly equal sums, is held in
        # norm to UPSTREAM_RTOL, as the step recompute holds it, and each
        # rank's own BatchNorm statistics must exceed that. At bf16 those
        # leaves are reported, not held: the global statistics' float32
        # sums in another order flip bf16 roundings, which the same
        # cancellations magnify (PERF.md §6)
        step = outs[0][name]["step"]
        held = {k: bound if k.startswith("decoder/3/") else UPSTREAM_RTOL
                for k in step["grad_gaps"]
                if name == "float32" or k.startswith("decoder/3/")}
        ratio = {k: step["grad_gaps"][k] / held[k] for k in held}
        trap = {k: step["trap_gaps"][k] / held[k] for k in held}
        worst, caught = max(ratio, key=ratio.get), max(trap, key=trap.get)
        upstream = {k: g for k, g in step["grad_gaps"].items()
                    if not k.startswith("decoder/3/")}
        loose = max(upstream, key=upstream.get)
        gaps[name] = {"step_loss": step["loss_gap"],
                      "step_held_worst_vs_limit": {worst: ratio[worst]},
                      "step_output_layer": {k: step["grad_gaps"][k] for k in
                                            ("decoder/3/w", "decoder/3/b")},
                      "step_upstream_worst": {loose: upstream[loose]},
                      "step_per_rank_bn_vs_limit": {caught: trap[caught]},
                      "step_prebn_max": step["prebn_max"]}
        # the histories: epoch 1's train loss is held; after it, Adam's
        # response to rounding noise in gradients near zero (the pre-BatchNorm
        # biases reach validation through BatchNorm's running means) and the
        # KL term, unweighted in epoch 1 (beta = 0) and weighted from epoch 2,
        # carry any difference far beyond a rounding: reported, not held
        hist = outs[0][name]["train"] + outs[0][name]["val"]
        ref_ = base[0] + base[1]
        gaps[name]["history"] = [abs(g - w) / abs(w) for g, w in zip(hist, ref_)]
        log(f"data parallel {name}: first step W = 2 vs W = 1: loss "
            f"{step['loss_gap']:.3g} (bound {bound}), output layer dW "
            f"{step['grad_gaps']['decoder/3/w']:.3g} and db "
            f"{step['grad_gaps']['decoder/3/b']:.3g} in norm (bound {bound}), "
            f"worst upstream leaf {loose} {upstream[loose]:.3g} in norm "
            f"({'held to ' + str(UPSTREAM_RTOL) if name == 'float32' else 'not held'}); "
            f"worst held leaf {worst} at {ratio[worst]:.3g}x its limit, with "
            f"each rank's own BatchNorm statistics {trap[caught]:.3g}x "
            f"({caught}); "
            f"pre-BatchNorm bias gradients (rounding noise) up to "
            f"{step['prebn_max']:.3g}; histories W = 2 {outs[0][name]['train']} "
            f"/ {outs[0][name]['val']} against W = 1 {base[0]} / {base[1]}: "
            f"relative gaps {[f'{x:.3g}' for x in gaps[name]['history']]} "
            f"(train, then validation; epoch 1's train loss held to {bound})")
        first = abs(hist[0] - ref_[0])
        if (step["loss_gap"] > bound or ratio[worst] > 1.0
                or first > (DP_ATOL if name == "float32" else 0.0)
                + bound * abs(ref_[0])):
            raise AssertionError(f"data parallel {name}: W = 2 differs from "
                                 f"W = 1 beyond its limits")
        if name == "float32" and trap[caught] <= 1.0:
            raise AssertionError(f"data parallel {name}: the limits would pass "
                                 "per-rank BatchNorm statistics")
    for o in outs:
        check_launches(f"data-parallel sample, rank {o['rank']}",
                       o["sample"]["launches"], want_sample)
    same = kept.read_bytes() == Path(outs[0]["sample"]["path"]).read_bytes()
    if not same:
        raise AssertionError("data-parallel sample file differs from the "
                             "one-process file")
    log(f"data parallel: two ranks on {card} in {wall:.1f}s (float32 "
        f"{outs[0]['float32']['wall_s']:.1f}s, bf16 "
        f"{outs[0]['bfloat16']['wall_s']:.1f}s, sample "
        f"{outs[0]['sample']['wall_s']:.1f}s on rank 0); the packed sample file "
        f"is byte-equal to the one-process file")
    return {"wall_s": wall, "reference_wall_s": ref_wall, "references": refs,
            "worst_rel_gap": gaps, "sample_byte_equal": same,
            "ranks": [{k: (v if k == "rank" else
                           {kk: vv for kk, vv in v.items() if kk != "path"})
                       for k, v in o.items()} for o in outs]}


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="also profile one pipeline run and one training "
                             "epoch; traces into DIR")
    parser.add_argument("--dp-worker", nargs=5, help=argparse.SUPPRESS,
                        metavar=("RANK", "WORLD", "PORT", "MODEL", "GENBANK"))
    opts = parser.parse_args()
    t_all = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (REPO / "genome_minimizer_2_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    # the runner logs each stage; timestamps show where the path's time goes
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="%(asctime)s %(name)s: %(message)s")
    if opts.dp_worker:  # one rank of phase 6's data-parallel check
        rank, world, port, model, genbank = opts.dp_worker
        return dp_worker(int(rank), int(world), int(port), model, genbank)
    smi = nvidia_smi_line()
    card = torch.cuda.get_device_name(0)
    log(f"device: {card} ({smi}), torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    # IEEE float32 products for the float32 checks; set once, here
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build = build_all()
    kernel = check_kernel()
    gather = check_gather()
    bwd = check_output_layer_bwd()
    adam = check_clip_adam()

    with gm2_root("gm2_smoke_") as root:
        t0 = time.perf_counter()
        inputs = write_inputs(root)
        log(f"pipeline inputs written in {time.perf_counter() - t0:.1f}s")
        runs = run_main_path(inputs, root, card)
        profiled = (profile_main_path(inputs, root, opts.profile)
                    if opts.profile else None)
    with gm2_root("gm2_train_") as root:
        t0 = time.perf_counter()
        genes, essentials = write_training_inputs(root)
        log(f"training inputs written in {time.perf_counter() - t0:.1f}s")
        results, train_launches = run_training_path(card)
        train_checks, loaded = check_training(results, train_launches, root)
        if opts.profile:
            profiled_train = profile_training(*loaded, opts.profile)
        staged = run_staged_path(results, genes, essentials, root, card)
        t6 = time.perf_counter()
        elastic, data = run_elastic(card)
        traced = run_trace(data, root, card)
        nccl = run_nccl_bringup(results, train_checks["expected_launches"],
                                root, card)
        dp = run_data_parallel(results, staged, data, root, card)
        del data
        phase6_s = time.perf_counter() - t6
        log(f"{smi}: phase 6 {phase6_s:.1f}s (elastic "
            + ", ".join(f"{k} {v['wall_s']:.1f}s" for k, v in elastic.items())
            + f"; trace {traced['wall_s']:.1f}s; NCCL bring-up "
            f"{nccl['wall_s']:.1f}s; data parallel {dp['wall_s']:.1f}s + W = 1 "
            f"references {dp['reference_wall_s']:.1f}s)")

    def record(name, source, replaces, launches, res, **extra):
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
        return {"name": name, "route": "cuda",
                "source": f"genome_minimizer_2_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                **{k: res[k] for k in keys}, **extra}

    decode_by_path = {**{f"pipeline {m}": r["launches"] for m, r in runs.items()},
                      "training": train_launches["decode_threshold_pack"],
                      "sample default": staged["launches"]["sample"],
                      "pipeline from the trained checkpoint":
                          staged["launches"]["pipeline"]}
    # the paths of phase 6, each counted from 0 just before it
    slice_paths = {
        **{f"elastic {k}": v["launches"] for k, v in elastic.items()},
        "trace": traced["launches"], "nccl W=1": nccl["launches"],
        **{f"data parallel rank {o['rank']} {m}": o[m]["launches"]
           for o in dp["ranks"] for m in ("float32", "bfloat16", "sample")}}
    by_path = lambda name: {p: c[name] for p, c in slice_paths.items()}  # noqa: E731
    records = [
        record("decode_threshold_pack", "decode_threshold_pack.cu",
               "genome_minimizer_2_tpu/ops/pallas_kernels.py:110",
               sum(decode_by_path.values()), kernel,
               shape=[CHUNK, 1024, 55_040], dtype="bfloat16",
               bits_differing=kernel["bits_differing"], float32=kernel["float32"],
               launches_by_path={**decode_by_path,
                                 **by_path("decode_threshold_pack")}),
        record("gather_row_blocks", "gather_row_blocks.cu",
               "genome_minimizer_2_tpu/ops/pallas_kernels.py:190",
               train_launches["gather_row_blocks"], gather,
               shape=[4_608, 55_040], block=8, dtype="bfloat16",
               launches_by_path=by_path("gather_row_blocks"),
               **{k: gather[k] for k in ("ms_range", "library_ms_range",
                                         "bound_share", "float32", "block_1")}),
        record("output_layer_bwd", "output_layer_bwd.cu",
               "tools/bol_probe.py:22 (make_bwd) and :156 (make_bwd_fullk)",
               train_launches["output_layer_bwd"], bwd,
               shape=[TRAIN_BATCH, V0_HIDDEN, 55_040], dtype="bfloat16",
               launches_by_path=by_path("output_layer_bwd"),
               max_rel_err=bwd["max_rel_err"], dh_splits=bwd["dh_splits"],
               elements_1ulp=bwd["elements_1ulp"], float32=bwd["float32"]),
        record("clip_adam_apply", "clip_adam.cu",
               "tools/opt_microbench3.py:61 (adam_pallas_loop)",
               train_launches["clip_adam_apply"],
               {**adam["bfloat16"], "max_abs_err": adam["max_abs_err"]},
               values=adam["values"], leaves=adam["leaves"],
               moments="bfloat16", max_ulp=adam["max_ulp"],
               launches_by_path=by_path("clip_adam_apply"),
               float32_moments=adam["float32"],
               ms_scope="one optimizer step: every leaf, one launch each"),
    ]
    train_summary = {k: results[k] for k in (
        "train_loss_vals", "val_loss_vals", "epoch_seconds", "examples_per_s",
        "n_train", "f1_overall", "accuracy_overall", "wall_s")}
    log(f"{smi}: pipeline feature-bits {runs['feature-bits']['wall_s']:.2f}s wall, "
        f"{runs['feature-bits']['genomes_per_s']:.1f} genomes/s; staged "
        + ", ".join(f"{k} {v:.2f}s ({staged['genomes_per_s'][k]:.1f} genomes/s)"
                    for k, v in staged["wall_s"].items()))
    log(json.dumps({"pipeline": runs, "training": train_summary,
                    "training_checks": train_checks, "staged": staged,
                    "build_s": build,
                    "profile": profiled,
                    "profile_training": profiled_train if opts.profile else None,
                    "elastic": elastic, "trace": traced, "nccl": nccl,
                    "data_parallel": dp, "phase6_s": phase6_s,
                    "wall_s": time.perf_counter() - t_all}))
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


@contextlib.contextmanager
def gm2_root(prefix: str):
    """A temporary GM2_ROOT for one path, removed afterwards."""
    root = Path(tempfile.mkdtemp(prefix=prefix))
    old_root = os.environ.get("GM2_ROOT")
    os.environ["GM2_ROOT"] = str(root)
    try:
        yield root
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if old_root is None:
            os.environ.pop("GM2_ROOT", None)
        else:
            os.environ["GM2_ROOT"] = old_root


if __name__ == "__main__":
    sys.exit(main())

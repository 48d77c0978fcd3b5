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
   computes the same function, and its bound (each timing line prints the
   kernel's time over both). bf16 operands run on the tensor cores
   (the decode on csrc/gemm_cluster_sm90.cuh, the backward on
   csrc/gemm_sm90.cuh), float32 operands on the CUDA cores
   (csrc/sgemm_sm90.cuh); both are checked. The bf16 kernels are timed on
   the device in turns with their library calls (kernel, library, library,
   kernel; 10 timings a side of launches queued behind a sleep, medians
   and ranges), the bf16 backward also launch by launch beside each
   launch's bound and against the same-function counterparts (PyTorch's
   ops for the cotangent pass, the library's products):
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
     1e-4 of its largest value; float32 operands at (2,048, 1,024, 55,040)
     with and without the logits' cotangent, at the ragged batches 512 and
     856 and at the ragged D = 1,003: dW, db and dh within 1e-4 of the
     largest plain value, and bit-identical across two calls;
   - clip_adam_apply_leaves over every leaf of the v0 model (117.2 M
     values, one launch) with float32 and bf16 moments, in the clip and
     the no-clip branch: bit-equal to the plain version; then a no-clip
     step timed in turns with ``torch._fused_adam_`` (kernel, library,
     library, kernel; device time), which computes the same update at
     float32 moments (held to the kernel's step within 1e-4 in norm) and
     refuses bf16 moments beside float32 parameters (its refusal is
     printed), beside the bound from the bytes a step moves (28 B a value
     at float32 moments, 20 at bf16); and the instructions a value takes
     on the kernel's vector path, counted in ``cuobjdump -sass`` of the
     built library, with the compute floor they set;
   - weight_grad_bf16, the bf16 product's weight gradient, at v0's and
     v2's input layer at the cells' batch (32 x 55,040 x 1,024 and x 512)
     and at ragged shapes (the last batch of 24, the gene slice, the
     unpadded genes, a head, D and N not multiples of 8, several k blocks):
     bf16 values, each within 1 bf16 ulp of the plain version or, where the
     sum cancels, within 2^-16 of the sum of its terms' magnitudes; at the
     input layers timed in turns with the route it replaced (two
     torch.mm(out_dtype=float32) of the cotangent's bf16 terms, the add and
     the casts), beside its bound;
   - the three kernels of the tensor-parallel path at a gene slice of
     27,520 genes (model axis 2), bf16, each held as above and timed beside
     its bound and library call: the decode at (512, 1,024, 27,520), the
     output layer's backward at (2,048, 1,024, 27,520) on the last slice
     (its padding column included), clip + Adam over the 60.8 M values one
     rank holds (bf16 moments).
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
   matplotlib, which the card's machine may lack). The trainer runs each
   epoch as CUDA graphs: epoch 1 eagerly on the capture stream, then the
   captures; epoch 2 as replays. Checks: launches equal the expected counts (one
   shuffle per train epoch, one output-layer backward per train step, one
   clip + Adam launch per step over all 30 leaves, one decode for the test-set metrics), and
   epoch 2's all come from replays;
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
   - graphs: the trainer's epoch programs built from a state (each one's
     first epoch eagerly on the capture stream, then the captures) and the
     state put back; 2 epochs of replays against 2 epochs of the eager
     ``run_epoch`` from an equal state, at bf16 and float32: every state
     tensor and loss sum bit-equal (else the differing leaves are printed
     and the run fails), each epoch's launches equal and all from replays;
     then eager and graphed epoch wall times in turns (5 rounds of e g g
     e, medians), a traced epoch of each with the device's busy share, and
     the graph pool's size; every timed and traced epoch starts from the
     state after the two checked epochs, put back outside the timing, and
     all must give the same finite sums (the epoch repeated on its own
     result is printed: it diverges);
   - trace: two epochs with GM2_PROFILE_DIR set; the trace file must hold
     the trainer's ranges and the CUDA kernels of a step; prints the
     device's busy share of the traced epoch 2 (the graphs' replays);
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
7. Gene-axis tensor parallelism at full v0 width, from phase 5's cache,
   on gloo ranks sharing the card (this script again, ``--tp-worker``;
   the ranks' collectives are a correctness path, not a speed):
   - data 1 x model 2 (two ranks): a train step from the initial state on
     epoch 1's first batch against one process on the same global batch
     (the exact row permutation): at float32 the loss and the output
     layer's dW and db (gathered) within 1e-5 in norm, every other leaf
     within 1e-2, and the same step with the KL term counted on both model
     ranks must move some leaf past its limit (its factor printed); at bf16
     the loss and dW within 6e-3, the other leaves printed. Then ``--mode
     experiment --model-parallel 2`` through the CLI (2 epochs, a
     train-state file at epoch 2): per rank, one output-layer backward per
     step and one decode per test-set batch, both at the gene slice, one
     clip + Adam launch per step and no shuffle; the train-state file
     and the saved model rank 0 writes hold full leaves equal to the ranks'
     gathered state; the test-set bits equal a one-process decode of the
     gathered parameters, a bit differing only at a logit within 1e-3 of
     0, at most 1% of the records (counted and printed);
   - data 2 x model 2 (four ranks): the float32 step as above, across the
     data and model subgroups.
8. The reference: the port at float32, TF32 off, through its entry points
   at full v0 width, held to the JAX package's answers, which
   tests/_torch_jax_golden.py computed on the CPU from the same seeds
   (tests/golden/torch_port_jax_v0.json, read as JSON: JAX need not be
   installed beside the card). The inputs are rebuilt from the file's
   recipe by the port's own generators and ``init_from_key``; their
   SHA-256 digests must equal the file's ("inputs differ" otherwise)
   before anything runs. Then, with
   the launch counts set to 0: the CLI ``--mode pipeline`` for 2,048
   genomes in chunks of 512, default and focused, ``--mode sample
   --save-dtype packed`` of the default latents, and the trainer on the
   card (``create_trainer`` + ``train``, graphed epochs, 2 epochs at
   batch 2,048 on the 4,608 training rows, the block shuffle) and the test
   set's metrics. Checks:
   - each kernel launched as the path expects (decode per chunk, probe
     decode, sample chunk and metrics batch; a shuffle per epoch; a
     backward and a clip + Adam launch per step), on its float32 route (the
     sampler's and the trainer's compute dtype, the epoch data's and the
     moments' dtype);
   - FASTA records and packed rows: each byte-equal to the reference's
     digest, or, where it differs, equal to it once its bits at the genes
     whose reference logit lies within the file's near_zero (1e-5) of 0
     take the reference's value (the kernel's decode of its chunk must
     first give the record again); otherwise excused only if a bit of it
     has a plain float32 logit within 1e-3 of 0 here, at most 1 % of the
     rows. Each count is printed;
   - the first gradient (``first_gradient``): the loss's gradient at the
     initial state on the first batch, one step before Adam can amplify
     anything. A ReLU whose input lies within 1e-4 of 0 may fall on the
     other side here, as a near-zero bit may in a record; with the
     reference's decisions at those inputs (the golden file lists them)
     each leaf's norm, sum and projection on a fixed normal vector must lie
     within rtol 1e-4 of its norm. The count that fell the other way is
     printed, and the gradient as it is, not held;
   - training (``training_gaps``): the counter, rng key and
     early-stopping count equal; each epoch's
     losses (train rtol 1e-4 / atol 1e-6, validation rtol 1e-4 / atol
     5e-3, and the early-stopping best loss) and each parameter's,
     BatchNorm statistic's and Adam moment's sums (within what
     ``_assert_same_run``'s update tolerance implies, 5e-2 for v0). A
     quantity is held at that stated tolerance or at three times the
     farthest that the reference's own reordered runs move it, whichever is
     wider (the golden file's ``training.reorders``: its sums over genes,
     hidden units or the batch in another order, equal in exact
     arithmetic): full-width v0 moves that far from itself under rounding
     alone. Each class's worst share of its limit is printed;
   - the test set's F1 and accuracy within 1e-3 of the reference's.
   bf16 runs too (the first chunk of the default pipeline) and its records
   that differ from the float32 reference are counted and printed, not
   held: the JAX package's bf16 on the CPU is not what its TPU computes, so
   it is no reference. Prints the phase's wall time beside nvidia-smi's
   line.
9. Prints the per-kernel JSON line, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

``--reference`` runs only phases 1–2 and 8 (about a minute and a half), to
iterate on phase 8 alone; it has no checks of its own.

``--bf16-times`` runs only phases 1–2 and the bf16 decode's and backward's
timings (at the main shapes and the gene slice) and prints them as JSON;
with ``--package-root DIR`` the port is imported from DIR, a checkout of
another commit, so that two commits are timed in turns on one card.

``--step-phases`` runs only phases 1–2, then for the benchmark's training
cells at their inputs the eager step's device time by ``gm2/step/*``
range (``utils/profiling.py::step_phases``, 8 steps) beside one replayed
epoch's by range (the phases' sum must lie within 15 % of a replayed
step), and the ranges' host cost a step and a sampler chunk with the
profiler off and on, and prints them as JSON. Its inputs are the
benchmark's own: it builds them with ``portbench/drivers/train.py`` and
``sample.py``, so it measures what those drivers set up, and is to be run
again whenever they change.

``--profile DIR`` adds, after the checks, one more default-mode pipeline
run (half the genomes, over the same output file) and one more training
epoch from the epoch-1 state (a replay of its graphs), each under
torch.profiler: it prints the
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
# H100 SXM dispatch rates at its 1,980 MHz boost clock, 132 SMs: 4 warp
# instructions an SM a clock, 16 MUFU results an SM a clock
SM_CLOCK, SMS = 1.98e9, 132
DISPATCH_WARP_INSTR = SMS * 4 * SM_CLOCK
PEAK_MUFU = SMS * 16 * SM_CLOCK
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
# tensor parallelism: the model axis of 2 splits the padded gene axis into
# slices of 27,520 genes; the last slice holds the one padding column
TP_MODEL = 2
TP_SLICE = V0_PADDED // TP_MODEL
TP_STEP_RTOL = 1e-5  # float32 step on the grid vs one process: loss, dW, db
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
        except Exception as e:  # re-raised below, after every build ends
            errors.append((name, e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(n, f)) for n, f in
               (("cuda_kernels", _build.build_cuda_kernels),
                ("native", _build.build_native),
                ("host_counts", _build.build_host_counts))]
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
        res["bound_ms"], res["bound_by"] = bound(flops, nbytes, peak)
        kernel = lambda: KR.decode_threshold_pack(hc, wc, b, dtype)  # noqa: E731
        library = lambda: torch.matmul(hc, wc)  # noqa: E731
        if dtype == torch.bfloat16:
            # device time in turns with the library call (kernel, library,
            # library, kernel), so the wrapper's Python does not enter
            res.update(turns(kernel, library))
            if hasattr(KR, "decode_plan"):  # CTAs a cluster, clusters
                plan = KR.decode_plan(M, N, K, lambda cm: KR.decode_max_clusters(
                    torch.device(DEVICE), cm))
                res["cluster"], res["clusters"] = plan.cm, plan.clusters
            how = f"device time, {len(res['ms_all'])} timings a side in turns"
        else:
            res["ms"], res["library_ms"] = time_ms(kernel), time_ms(library)
            how = "back-to-back launches"
        res["plain_ms"] = time_ms(
            lambda: KR.decode_threshold_pack_reference(hc, wc, b, dtype))
        if "cluster" in res:
            how += f"; clusters of {res['cluster']}, {res['clusters']} of them"
        log(f"  time {name} ({how}): kernel {spread(res, 'ms')}, plain "
            f"{res['plain_ms']:.4f} ms, torch.matmul {spread(res, 'library_ms')}, "
            f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}; "
            f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB); "
            f"{ratios(res)}")
    return res


def turns(kernel, library, rounds: int = GATHER_ROUNDS,
          iters: int = GATHER_LAUNCHES) -> dict:
    """A kernel and its library call timed in turns (ab_times): medians,
    ranges and every timing, in ms a launch."""
    import statistics

    t_k, t_l = ab_times(kernel, library, rounds, iters)
    return {"ms": statistics.median(t_k), "ms_range": [min(t_k), max(t_k)],
            "ms_all": t_k, "library_ms": statistics.median(t_l),
            "library_ms_range": [min(t_l), max(t_l)], "library_ms_all": t_l}


def spread(res: dict, key: str) -> str:
    """``key``'s time with its range, where it has one."""
    rng = res.get(f"{key}_range")
    if rng is None:
        return f"{res[key]:.4f} ms"
    return f"median {res[key]:.4f} ms [{rng[0]:.4f}, {rng[1]:.4f}]"


def check_kernel() -> dict:
    """The bf16 result at the main shape, with the float32 one beside it;
    each route's max_abs_err over every checked shape."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(1234)
    main, worst = {}, {}
    for M, K, N in ((CHUNK, 1024, 55_040), (300, 1024, 1000), (300, 1024, 1003)):
        for dtype in (torch.float32, torch.bfloat16):
            timed = M == CHUNK
            res = check_kernel_case(M, K, N, dtype, gen, timed)
            worst[dtype] = max(worst.get(dtype, 0.0), res["max_abs_err"])
            if timed:
                main[dtype] = res
    for dtype, res in main.items():
        res["max_abs_err"] = worst[dtype]
    return {**main[torch.bfloat16], "float32": main[torch.float32]}


def ratios(res: dict) -> str:
    """The bound over the kernel's time, and the kernel's time over its
    library call's."""
    return (f"bound / kernel {res['bound_ms'] / res['ms']:.3f}, kernel / "
            f"library {res['ms'] / res['library_ms']:.3f}")


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


def bwd_inputs(B, H, D, cd, gen, y_dtype=None, real=V0_INPUT_DIM):
    """Inputs of the output layer's backward whose first ``real`` of D
    genes are real and the rest padding."""
    import torch

    h = torch.relu(torch.randn(B, H, generator=gen, device=DEVICE))
    w = torch.randn(H, D, generator=gen, device=DEVICE) * 0.02
    w[:, real:] = 0.0
    b = torch.randn(D, generator=gen, device=DEVICE) * 0.1
    logits = (h.to(cd).float() @ w.to(cd).float() + b).to(cd)
    y = (torch.rand(B, D, generator=gen, device=DEVICE) < 0.4).to(y_dtype or cd)
    mask = torch.zeros(D, device=DEVICE)
    mask[:real] = 1.0
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
            res = time_bwd_bf16(logits, y, mask, h, w, g, "bf16")
    # float32 operands: the CUDA-core route, at the training shape with and
    # without the logits' cotangent, at the ragged batches and at a ragged D
    f32 = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    for B, D_, with_gl in ((TRAIN_BATCH, D, False), (TRAIN_BATCH, D, True),
                           (512, D, False), (856, D, True),
                           (TRAIN_BATCH, 1003, True)):
        h, w, logits, y, mask, gl = bwd_inputs(B, H, D_, torch.float32, gen,
                                               real=min(D_, V0_INPUT_DIM))
        gl = gl if with_gl else None
        out = KR.output_layer_bwd(logits, y, mask, h, w, g, gl)
        torch.cuda.synchronize()
        ref = KR.output_layer_bwd_reference(logits, y, mask, h, w, g, gl)
        for name, o, r in zip(("dW", "db", "dh"), out, ref):
            err = float((o - r).abs().max())
            rel = err / float(r.abs().max())
            f32["max_abs_err"] = max(f32["max_abs_err"], err)
            f32["max_rel_err"] = max(f32["max_rel_err"], rel)
            log(f"output_layer_bwd float32 B={B} D={D_} {name} (g_logits "
                f"{'given' if with_gl else 'none'}): max |err| {err:.3g}, "
                f"{rel:.3g} of max |plain|")
            if not rel <= BWD_RTOL:
                raise AssertionError(f"output_layer_bwd float32 B={B} D={D_} "
                                     f"{name}: {rel} > {BWD_RTOL}")
        if B == TRAIN_BATCH and D_ == D and with_gl:
            # no atomics: a second call gives the same bits
            again = KR.output_layer_bwd(logits, y, mask, h, w, g, gl)
            same = [torch.equal(a, b) for a, b in zip(out, again)]
            log(f"output_layer_bwd float32 dW, db, dh bit-identical across "
                f"two calls: {same}")
            if not all(same):
                raise AssertionError("output_layer_bwd float32 is not deterministic")
            del again
        del out, ref
    B = TRAIN_BATCH
    h, w, logits, y, mask, _ = bwd_inputs(B, H, D, torch.float32, gen)
    flops = 2 * 2.0 * B * H * D
    nbytes = 2 * B * D * 4 + D * 4 + (B * H + H * D) * 4 + 4 + (H * D + D + B * H) * 4
    b_ms, b_by = bound(flops, nbytes, PEAK_FP32_FLOPS)
    dl = KR.output_layer_dl(logits, y, mask, g)  # float32

    def library32():  # IEEE float32 products: TF32 is off (main)
        torch.mm(h.t(), dl)
        torch.mm(dl, w.t())
        dl.sum(dim=0)

    require_ieee_float32_matmul()
    f32.update({"ms": time_ms(lambda: KR.output_layer_bwd(logits, y, mask, h, w, g),
                              iters=5, warmup=2),
                "plain_ms": time_ms(lambda: KR.output_layer_bwd_reference(
                    logits, y, mask, h, w, g), iters=3, warmup=1),
                "library_ms": time_ms(library32, iters=5, warmup=2),
                "bound_ms": b_ms, "bound_by": b_by,
                "dh_splits": KR.bwd_plan(B, H, D, torch.float32, torch.cuda.
                                         get_device_properties(0).multi_processor_count,
                                         KR.sgemm_blocks_per_sm(torch.device(DEVICE))
                                         ).splits})
    f32["parts_ms"] = bwd_parts(lambda: KR.output_layer_bwd(logits, y, mask, h, w, g))
    log(f"  time float32: kernel {f32['ms']:.4f} ms, plain {f32['plain_ms']:.4f} ms, "
        f"2 x torch.mm(float32, TF32 off) + sum {f32['library_ms']:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}; {flops / 1e9:.1f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB); {ratios(f32)}; dh splits {f32['dh_splits']}; "
        "device ms by launch: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                           f32["parts_ms"].items()))
    del dl
    res.update({"max_abs_err": worst_abs, "max_rel_err": worst_rel,
                "elements_1ulp": ulp1, "float32": f32})
    return res


def time_bwd_bf16(logits, y, mask, h, w, g, label: str) -> dict:
    """The bf16 backward timed on the device: the whole call in turns with
    the products-only library call (two ``torch.mm`` and the column sum,
    given the rounded cotangent), its launches one by one beside their own
    bounds (torch.profiler), and the same-function counterparts of its
    parts: the cotangent pass against PyTorch's own ops computing it (the
    cotangent rounded to bf16 and its column sum), the products against
    the library's."""
    import torch

    from genome_minimizer_2_torch.ops import kernels as KR

    B, D = logits.shape
    H = h.shape[1]
    y_bytes = y.element_size()
    flops = 2 * 2.0 * B * H * D
    nbytes = (logits.numel() * 2 + y.numel() * y_bytes + D * 4 + h.numel() * 2
              + w.numel() * 2 + 4 + (H * D + D + B * H) * 4)
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    dl = KR.output_layer_dl(logits, y, mask, g).to(torch.bfloat16)

    def kernel():
        KR.output_layer_bwd(logits, y, mask, h, w, g)

    def library():
        torch.mm(h.t(), dl, out_dtype=torch.float32)
        torch.mm(dl, w.t(), out_dtype=torch.float32)
        dl.sum(dim=0, dtype=torch.float32)

    def dl_library():
        KR.output_layer_dl(logits, y, mask, g).to(torch.bfloat16).sum(
            dim=0, dtype=torch.float32)

    res = {**turns(kernel, library, iters=10), "bound_ms": b_ms, "bound_by": b_by,
           "plain_ms": time_ms(lambda: KR.output_layer_bwd_reference(
               logits, y, mask, h, w, g), iters=5, warmup=1),
           "dh_splits": KR.bwd_plan(B, H, D, torch.bfloat16, torch.cuda.
                                    get_device_properties(0).multi_processor_count
                                    ).splits}
    dl_lib = turns(dl_library, library, iters=10)
    res["dl_library_ms"], res["dl_library_ms_range"] = dl_lib["ms"], dl_lib["ms_range"]
    res["library_with_dl_ms"] = res["dl_library_ms"] + res["library_ms"]
    parts = bwd_parts(kernel, BWD_PARTS_BF16, calls=10)
    res["parts_ms"] = parts
    res["parts_bound_ms"] = bwd_part_bounds(B, H, D, y_bytes, res["dh_splits"])
    res["floor_ms"] = sum(res["parts_bound_ms"].get(k, 0.0) for k in parts)
    res["products_ms"] = sum(v for k, v in parts.items() if k != "dl pass")
    log(f"  time {label} ({len(res['ms_all'])} timings a side in turns, device "
        f"time): kernel {spread(res, 'ms')}, 2 x torch.mm(bf16, out_dtype="
        f"float32) + sum given the cotangent {spread(res, 'library_ms')}, "
        f"plain {res['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
        f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB); {ratios(res)}; dh "
        f"splits {res['dh_splits']}")
    log(f"  {label} by launch (device ms a call, mean of 10 calls; bound): "
        + ", ".join(f"{k} {v:.4f} ({res['parts_bound_ms'].get(k, float('nan')):.4f})"
                    for k, v in parts.items())
        + f"; the launches' floor {res['floor_ms']:.4f} ms")
    log(f"  {label} same-function counterparts: the cotangent pass "
        f"{parts.get('dl pass', 0.0):.4f} ms against PyTorch's ops (sigmoid, mask, round "
        f"to bf16, column sum) {spread(res, 'dl_library_ms')}; the products "
        f"{res['products_ms']:.4f} ms against the library's "
        f"{res['library_ms']:.4f} ms; the whole call {res['ms']:.4f} ms against "
        f"PyTorch's ops and the library's products {res['library_with_dl_ms']:.4f} ms")
    return res


# the bf16 backward's launches, by a piece of their kernel's name
BWD_PARTS_BF16 = (("dl_pass_kernel", "dl pass"), ("gemm_kernel<false, false", "dh"),
                  ("splitk_sum_kernel", "split-K sum"), ("gemm_kernel<true, true", "dW"))
BWD_PARTS_F32 = (("dl_pass_kernel", "dl pass"), ("sgemm_kernel<true, true", "dh"),
                 ("splitk_sum_kernel", "split-K sum"), ("sgemm_kernel<false, false", "dW"))


def bwd_part_bounds(B, H, D, y_bytes, splits) -> dict:
    """Each launch's own bound in the bf16 backward, from the shapes: the
    cotangent pass's bytes (l, y, mask read, dl and db written), each
    product's operations, the split-K sum's bytes."""
    flops = 2.0 * B * H * D
    return {"dl pass": bound(0.0, B * D * (2 + y_bytes + 2) + D * 8 + 4,
                             PEAK_BF16_FLOPS)[0],
            "dh": bound(flops, 0.0, PEAK_BF16_FLOPS)[0],
            "dW": bound(flops, 0.0, PEAK_BF16_FLOPS)[0],
            "split-K sum": (bound(0.0, (splits + 1) * B * H * 4, PEAK_BF16_FLOPS)[0]
                            if splits > 1 else 0.0)}


def bwd_parts(fn, names=BWD_PARTS_F32, calls: int = 3) -> dict:
    """Device ms a call of the backward spends in each of its launches
    (torch.profiler over ``calls`` calls); ``names`` maps a piece of a
    kernel's name to its part, a launch a call. A named part is its
    kernel's mean over the launches the trace holds (after many profiled
    runs in one process the trace can drop some), the rest the sum over
    the calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    parts = {}
    for e in prof.key_averages():
        name = next((n for k, n in names if k in e.key), "other")
        per = max(e.count, 1) if name != "other" else calls
        parts[name] = parts.get(name, 0.0) + e.device_time_total / per / 1e3
    return parts


# weight_grad_bf16 launches a bf16 training step makes: one a product but
# the output layer's (encoder 0-2, mean, logvar, decoder 0-2)
WGRAD_A_STEP = 8
# (B, D, N) of the input layer's weight gradient at the cells' batch: v0, v2
WGRAD_TIMED = {"v0 encoder/0": (32, V0_PADDED, V0_HIDDEN),
               "v2 encoder/0": (32, V0_PADDED, 512)}
# ragged shapes: the cells' last batch, the gene slice, the unpadded genes,
# a head, a width and a D not multiples of 8, several k blocks of 32 rows
WGRAD_RAGGED = ((24, V0_PADDED, V0_HIDDEN), (32, TP_SLICE, V0_HIDDEN),
                (16, V0_INPUT_DIM, V0_HIDDEN), (32, V0_HIDDEN, V0_LATENT),
                (7, 1003, 130), (33, 200, 4), (256, 300, 32))


def check_weight_grad() -> dict:
    """weight_grad_bf16 against its plain version (the route it replaced:
    two ``torch.mm(out_dtype=float32)`` of the cotangent's bf16 terms, the
    add, the round to bf16 and back): bf16-valued, each element within 1
    bf16 ulp or, where the sum cancels, within CANCEL of the sum of its
    terms' magnitudes, one launch a call; at each preset's input layer
    timed on the device in turns with that route, beside its bound (the
    float32 result written once)."""
    import torch

    from genome_minimizer_2_torch.ops import kernels as KR

    gen = torch.Generator(device=DEVICE).manual_seed(21)
    res, worst = {}, 0.0
    cases = [*WGRAD_TIMED.items(), *((f"ragged {s}", s) for s in WGRAD_RAGGED)]
    for label, (B, D, N) in cases:
        x = torch.randn(B, D, generator=gen, device=DEVICE).to(torch.bfloat16)
        g = torch.randn(B, N, generator=gen, device=DEVICE) * 1e-3
        before = KR.weight_grad_bf16.launches
        out = KR.weight_grad_bf16(x, g)
        torch.cuda.synchronize()
        if KR.weight_grad_bf16.launches != before + 1:
            raise AssertionError(f"weight_grad_bf16 {label}: not one launch")
        ref = KR.weight_grad_bf16_reference(x, g)
        terms = x.float().abs().t() @ g.abs()
        if not torch.equal(out, out.to(torch.bfloat16).float()):
            raise AssertionError(f"weight_grad_bf16 {label}: values not bf16")
        outside = bf16_outside(out, ref, terms)
        err = float((out - ref).abs().max())
        worst = max(worst, err)
        log(f"weight_grad_bf16 {label} (B, D, N) = ({B}, {D}, {N}): "
            f"{int((out != ref).sum())} of {out.numel()} elements differ from the "
            f"plain version, {int((bf16_ulps(out, ref) == 1).sum())} by 1 bf16 ulp, "
            f"{outside} beyond 1 ulp and the cancellation slack; max |diff| {err:.3g}")
        if outside:
            raise AssertionError(f"weight_grad_bf16 {label}: {outside} elements "
                                 "off the plain version")
        if label not in WGRAD_TIMED:
            continue
        flops = 2 * 2.0 * B * D * N
        nbytes = D * N * 4 + B * D * 2 + B * N * 4
        r = {**turns(lambda: KR.weight_grad_bf16(x, g),  # noqa: B023
                     lambda: KR.weight_grad_bf16_reference(x, g)),  # noqa: B023
             "shape": [B, D, N]}
        r["bound_ms"], r["bound_by"] = bound(flops, nbytes, PEAK_BF16_FLOPS)
        # the plain version is the library route, timed in the turns
        r["plain_ms"] = r["library_ms"]
        res[label] = r
        log(f"  time weight_grad_bf16 {label} ({len(r['ms_all'])} timings a side "
            f"in turns, device time): kernel {spread(r, 'ms')}, the library route "
            f"(2 x torch.mm(bf16, out_dtype=float32) + add + casts) "
            f"{spread(r, 'library_ms')}, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); "
            f"{ratios(r)}")
        del x, g, out, ref, terms
    for r in res.values():
        r["max_abs_err"] = worst
    return res


def bf16_times() -> dict:
    """The bf16 kernels alone (``--bf16-times``): the decode and the
    backward at the main paths' shapes and at the gene slice, the decode's
    bits held to the plain version, each timed as in phase 3; then the
    bf16 product's weight gradient as phase 3 holds and times it."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(1234)
    res = {}
    for label, D in (("main", V0_PADDED), ("gene slice", TP_SLICE)):
        res[f"decode {label}"] = check_kernel_case(CHUNK, V0_HIDDEN, D,
                                                   torch.bfloat16, gen, timed=True)
        h, w, logits, y, mask, _ = bwd_inputs(
            TRAIN_BATCH, V0_HIDDEN, D, torch.bfloat16, gen,
            real=min(D, V0_INPUT_DIM) if D == V0_PADDED else V0_INPUT_DIM - D)
        res[f"backward {label}"] = time_bwd_bf16(logits, y, mask, h, w,
                                                 torch.ones((), device=DEVICE),
                                                 f"bf16 {label}")
        del h, w, logits, y, mask
    res["weight_grad_bf16"] = check_weight_grad()
    return res


def v0_leaf_shapes() -> dict:
    from genome_minimizer_2_torch.models import vae

    cfg = vae.VAEConfig(input_dim=V0_INPUT_DIM, hidden_dim=V0_HIDDEN,
                        latent_dim=V0_LATENT)
    return {k: tuple(t.shape) for k, t in vae.VAE(cfg).flat_params().items()}


def adam_launches() -> int:
    """clip + Adam launches a v0 step makes: one a table of leaves."""
    from genome_minimizer_2_torch.ops import kernels as KR

    return -(-len(v0_leaf_shapes()) // KR.CLIP_ADAM_LEAVES)


def tp_leaf_shapes() -> dict:
    """The v0 leaves one rank holds under a model axis of TP_MODEL: its gene
    slice of the gene-axis leaves, every other leaf whole."""
    from genome_minimizer_2_torch.parallel.mesh import gene_dim

    return {k: tuple(TP_SLICE if d == gene_dim(k) else n for d, n in enumerate(s))
            for k, s in v0_leaf_shapes().items()}


def fused_adam_library(g, m, v, p, lr):
    """The one PyTorch call that computes clip + Adam's no-clip branch over
    every leaf: ``torch._fused_adam_`` (its ``tensor_lr`` overload, the op
    behind ``torch.optim.Adam(fused=True)``), amsgrad off, no weight decay,
    no grad scale. Its denominator is ``sqrt(v) / sqrt(bc2) + eps``, the
    kernel's ``sqrt(v / bc2) + eps``: the same function, rounded elsewhere.
    A yardstick only; the port never calls it."""
    import torch

    steps = [torch.full((), 5.0, device=DEVICE) for _ in p]
    return lambda: torch._fused_adam_(
        p, g, m, v, [], steps, lr=lr, beta1=0.9, beta2=0.999,
        weight_decay=0.0, eps=1e-8, amsgrad=False, maximize=False,
        grad_scale=None, found_inf=None)


def fused_adam_refusal(mdt) -> str | None:
    """Whether ``torch._fused_adam_`` takes moments of ``mdt`` beside
    float32 parameters: None if it computes Adam's update there (held to
    float32 moments at 1e-6), else its refusal or what it computed. Tried
    once, on 64 values a leaf, which lie inside one block of the caching
    allocator whatever dtype the call reads them as."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(9)
    g = [torch.randn(64, generator=gen, device=DEVICE) * 1e-3]
    p = [torch.randn(64, generator=gen, device=DEVICE)]
    m0 = [torch.randn(64, generator=gen, device=DEVICE) * 1e-4]
    v0 = [torch.rand(64, generator=gen, device=DEVICE) * 1e-6]
    lr = torch.full((), 1e-3, device=DEVICE)
    m, v, pm = [m0[0].to(mdt)], [v0[0].to(mdt)], [p[0].clone()]
    want = [p[0].clone()]
    try:
        fused_adam_library(g, m, v, pm, lr)()
        torch.cuda.synchronize()
    except (RuntimeError, TypeError) as e:
        return f"refused: {str(e).splitlines()[0]}"
    fused_adam_library(g, [m0[0].to(mdt).float()], [v0[0].to(mdt).float()],
                       want, lr)()
    err = float((pm[0] - want[0]).abs().max())
    return None if err <= 1e-6 else f"accepted, but |p - Adam's p| reached {err:.3g}"


def clip_adam_sass(values: int) -> dict:
    """The instructions a value takes on clip + Adam's vector path (the
    float32-moment kernel, the 8 values of a lane's tile between its
    128-bit loads and stores, in the no-clip and the clip branch), read
    from ``cuobjdump -sass`` of the built library, and the compute floor
    they set over ``values`` values: dispatch, FP32 and MUFU time."""
    import re
    from collections import Counter

    from genome_minimizer_2_torch.ops import _build

    lib, _ = _build.build_cuda_kernels()
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    fn = text[text.index("clip_adam_kernelIfE"):]
    fn = fn[:fn.find("Function :")] if "Function :" in fn else fn
    ins = [(int(a, 16), op.split(".")[0], op) for a, op in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", fn)]
    loads = [i for i, (_, _, op) in enumerate(ins) if op == "LDG.E.128"]
    stores = [i for i, (_, _, op) in enumerate(ins) if op == "STG.E.128"]
    body = ins[loads[7] + 1: stores[0]]
    split = next(int(m, 16) for m in re.findall(
        r"@P\d BRA 0x([0-9a-f]+)", fn[fn.index(f"{body[0][0]:04x}*/"):])[:1])
    res = {}
    for name, part in (("no-clip", [x for x in body if x[0] < split]),
                       ("clip", [x for x in body if x[0] >= split])):
        c = Counter(op for _, op, _ in part)
        per = {"all": len(part) / 8, "fp32": (c["FFMA"] + c["FMUL"] + c["FADD"]) / 8,
               "mufu": c["MUFU"] / 8, "fchk": c["FCHK"] / 8}
        per["floor_ms"] = {
            "dispatch": values * per["all"] / 32 / DISPATCH_WARP_INSTR * 1e3,
            "fp32": values * per["fp32"] * 2 / PEAK_FP32_FLOPS * 1e3,
            "mufu": values * per["mufu"] / PEAK_MUFU * 1e3}
        res[name] = per
        log(f"clip_adam SASS, {name} branch, a value: {per['all']:.1f} "
            f"instructions, {per['fp32']:.1f} FP32, {per['mufu']:.1f} MUFU, "
            f"{per['fchk']:.1f} FCHK; over {values} values: dispatch "
            f"{per['floor_ms']['dispatch']:.4f} ms, FP32 {per['floor_ms']['fp32']:.4f} "
            f"ms, MUFU {per['floor_ms']['mufu']:.4f} ms")
    return res


def check_clip_adam(shapes=None, moment_dtypes=None) -> dict:
    """Every leaf (the v0 model's unless ``shapes``) through the kernel and
    the plain version, from the same inputs: float32 and bf16 moments (or
    ``moment_dtypes``), clip and no-clip branches, bit-equal. Then one
    no-clip step over every leaf timed in turns against the library call
    (kernel, library, library, kernel; device time, the launches queued
    behind a sleep), where ``torch._fused_adam_`` takes the moments, and
    the plain version; beside the bound from the bytes a step must move."""
    import statistics

    import torch

    from genome_minimizer_2_torch.ops import kernels as KR
    from genome_minimizer_2_torch.ops.optimizer import (bias_corrections,
                                                        global_norm)

    shapes = shapes or v0_leaf_shapes()
    n = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    rnd = lambda s, scale: torch.randn(s, generator=gen, device=DEVICE) * scale
    g = {k: rnd(s, 1e-4) for k, s in shapes.items()}
    p0 = {k: rnd(s, 0.05) for k, s in shapes.items()}
    norm = global_norm(g)
    res, worst, worst_abs = {}, 0, 0.0

    def kernel_step(ms, vs, ps, scalars, max_norm):  # one launch
        KR.clip_adam_apply_leaves(list(g.values()), list(ms.values()),
                                  list(vs.values()), list(ps.values()),
                                  scalars, max_norm)

    def plain_step(ms, vs, ps, scalars, max_norm):
        KR.clip_adam_apply_leaves_reference(
            list(g.values()), list(ms.values()), list(vs.values()),
            list(ps.values()), scalars, max_norm)

    for mdt in moment_dtypes or (torch.float32, torch.bfloat16):
        m0 = {k: rnd(s, 1e-5).to(mdt) for k, s in shapes.items()}
        v0 = {k: (rnd(s, 1e-4) ** 2).to(mdt) for k, s in shapes.items()}
        name = str(mdt).replace("torch.", "")
        for branch, max_norm in (("clip", 0.5 * float(norm)),
                                 ("no-clip", 2.0 * float(norm))):
            scalars = torch.stack([norm, torch.tensor(0.271, device=DEVICE),
                                   torch.tensor(0.00399, device=DEVICE),
                                   torch.tensor(1e-3, device=DEVICE)]).float()
            mk, vk, pk = ({k: t.clone() for k, t in d.items()} for d in (m0, v0, p0))
            mr, vr, pr = ({k: t.clone() for k, t in d.items()} for d in (m0, v0, p0))
            kernel_step(mk, vk, pk, scalars, max_norm)
            torch.cuda.synchronize()
            plain_step(mr, vr, pr, scalars, max_norm)
            pairs = [(a[k], b[k]) for a, b in ((mk, mr), (vk, vr), (pk, pr))
                     for k in shapes]
            ulps = max(ulp_distance(a, b) for a, b in pairs)
            errs = max(float((a.float() - b.float()).abs().max()) for a, b in pairs)
            del mk, vk, pk, mr, vr, pr, pairs
            worst, worst_abs = max(worst, ulps), max(worst_abs, errs)
            log(f"clip_adam {name} moments, {branch}: {len(shapes)} leaves, "
                f"{n} values, max {ulps} ulp and max |err| {errs} over m, v "
                f"and p from the plain version")
            if ulps:
                raise AssertionError(f"clip_adam {name} {branch}: {ulps} ulp")
        # a step reads g, m, v, p once and writes m, v, p once
        f32, moment = 4, (4 if mdt == torch.float32 else 2)
        nbytes = n * (f32 + moment + moment + f32      # read g, m, v, p
                      + moment + moment + f32)         # write m, v, p
        b_ms, b_by = bound(15.0 * n, nbytes, PEAK_FP32_FLOPS)
        m, v, p = ({k: t.clone() for k, t in d.items()} for d in (m0, v0, p0))
        # the no-clip branch (max_norm 1e30), the only one the library has,
        # at the fifth step's bias corrections (the library's state_steps)
        lr = torch.full((), 1e-3, device=DEVICE)
        step = torch.stack([norm, *bias_corrections(
            torch.full((), 5, dtype=torch.int32, device=DEVICE)), lr]).float()
        run_kernel = lambda: kernel_step(m, v, p, step, 1e30)  # noqa: E731
        refusal = fused_adam_refusal(mdt) if mdt != torch.float32 else None
        library, gap = None, None
        if refusal is None:
            lm, lv, lp = ([t.clone() for t in d.values()] for d in (m0, v0, p0))
            library = fused_adam_library(list(g.values()), lm, lv, lp, lr)
            # one step of each from the same state: the same function, its
            # roundings elsewhere (the norm of the steps' gap over the
            # kernel's step's, held to 1e-4; a missing bias correction
            # would read above 0.1)
            library()
            run_kernel()
            torch.cuda.synchronize()
            gap = math.sqrt(sum(float((a - b).double().square().sum())
                                for a, b in zip(lp, p.values()))
                            / sum(float((b - a).double().square().sum())
                                  for a, b in zip(p0.values(), p.values())))
            log(f"torch._fused_adam_ with {name} moments: one step from the "
                f"kernel's state; |p_library - p_kernel| / |p_kernel - p| = "
                f"{gap:.3g} in norm (held to 1e-4)")
            if gap > 1e-4:
                raise AssertionError("torch._fused_adam_ computes another update")
        else:
            log(f"torch._fused_adam_ with {name} moments and float32 "
                f"parameters: {refusal}; no library call at {name}")
        if library is not None:
            t_kernel, t_lib = ab_times(run_kernel, library, iters=5)
        else:
            run_kernel()
            t_kernel = [device_ms(run_kernel, 5) for _ in range(2 * GATHER_ROUNDS)]
        ms = statistics.median(t_kernel)
        r = {"ms": ms, "ms_range": [min(t_kernel), max(t_kernel)],
             "plain_ms": time_ms(lambda: plain_step(m, v, p, scalars, 1e30),
                                 iters=3, warmup=1),
             "library_ms": statistics.median(t_lib) if library else None,
             "library_ms_range": [min(t_lib), max(t_lib)] if library else None,
             "library_refusal": refusal, "library_step_gap": gap,
             "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
             "bytes": nbytes}
        lib = (f"torch._fused_adam_ median {r['library_ms']:.4f} ms "
               f"[{min(t_lib):.4f}, {max(t_lib):.4f}] ({ms / r['library_ms']:.3f}x)"
               if library else "no library call")
        log(f"  time {name} moments, one no-clip step over all {len(shapes)} "
            f"leaves ({len(t_kernel)} timings a side, in turns): kernel median "
            f"{ms:.4f} ms [{min(t_kernel):.4f}, {max(t_kernel):.4f}], {lib}, "
            f"plain {r['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
            f"{nbytes / 1e9:.3f} GB; the kernel at {b_ms / ms:.3f} of it)")
        res[name] = r
        del m, v, p, library
    res["max_ulp"] = worst
    res["max_abs_err"] = worst_abs
    res["values"] = n
    res["leaves"] = len(shapes)
    return res


def check_tp_slices() -> dict:
    """The three kernels of the tensor-parallel path at a gene slice of
    TP_SLICE genes, bf16 as the path runs them, each held to its plain
    version and timed beside its bound (and the library call, where one
    computes the same function): the test-set decode at (512, 1,024,
    27,520), the output layer's backward at (2,048, 1,024, 27,520) on the
    last slice (27,519 genes and the padding column), clip + Adam over the
    leaves one rank holds (bf16 moments)."""
    import torch

    from genome_minimizer_2_torch.ops import kernels as KR

    gen = torch.Generator(device=DEVICE).manual_seed(2024)
    decode = check_kernel_case(CHUNK, V0_HIDDEN, TP_SLICE, torch.bfloat16, gen,
                               timed=True)

    B, H, D = TRAIN_BATCH, V0_HIDDEN, TP_SLICE
    h, w, logits, y, mask, _ = bwd_inputs(B, H, D, torch.bfloat16, gen,
                                          real=V0_INPUT_DIM - TP_SLICE)
    g = torch.ones((), device=DEVICE)
    out = KR.output_layer_bwd(logits, y, mask, h, w, g)
    torch.cuda.synchronize()
    ref = KR.output_layer_bwd_reference(logits, y, mask, h, w, g)
    dl = KR.output_layer_dl(logits, y, mask, g).to(torch.bfloat16)
    absmm = lambda a, b: torch.mm(a.abs(), b.abs(), out_dtype=torch.float32)  # noqa: E731
    terms = {"dW": absmm(h.t(), dl), "dh": absmm(dl, w.t())}
    worst = 0.0
    for name, o, r in zip(("dW", "db", "dh"), out, ref):
        err = float((o - r).abs().max())
        rel = err / float(r.abs().max())
        worst = max(worst, err)
        bad = int(rel > BWD_RTOL) if name == "db" else bf16_outside(o, r, terms[name])
        log(f"output_layer_bwd bf16 gene slice ({B}, {H}, {D}) {name}: max |err| "
            f"{err:.3g}, {rel:.3g} of max |plain|, {bad} elements beyond the limit")
        if bad:
            raise AssertionError(f"output_layer_bwd at the gene slice: {name}")
    del out, ref, terms, dl
    bwd = {"shape": [B, H, D], "max_abs_err": worst,
           **time_bwd_bf16(logits, y, mask, h, w, g, "bf16 gene slice")}
    del h, w, logits, y

    adam = check_clip_adam(tp_leaf_shapes(), (torch.bfloat16,))
    clip = {**adam["bfloat16"], "max_abs_err": adam["max_abs_err"],
            "max_ulp": adam["max_ulp"], "values": adam["values"],
            "leaves": adam["leaves"]}
    keep = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    return {"decode_threshold_pack": {"shape": [CHUNK, V0_HIDDEN, TP_SLICE],
                                      **{k: decode[k] for k in keep},
                                      "bits_differing": decode["bits_differing"]},
            "output_layer_bwd": bwd, "clip_adam_apply_leaves": clip}


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


def plain_lookup(model_path: str, genbank: str, device: str = DEVICE):
    """The checkpoint's sampler on ``device``, the GenBank's minimizer
    engine, its packed feature lookup (col_idx, ess) and the FASTA-relevant
    columns (those of the non-essential named features, on ``device``)."""
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
    sampler, _ = load_sampler(model_path, input_dim=len(cols), device=device)
    engine = MinimizerEngine.from_genbank(genbank)
    cols_arr, keep = dedupe_columns(np.asarray(cols))
    col_idx, ess = engine.feature_lookup_packed(cols_arr, keep, essential)
    relevant = torch.as_tensor(np.unique(col_idx[(col_idx >= 0) & ~ess]),
                               device=device)
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


def pipeline_latents(sampler, seed: int, mode: str, n_probes: int = N_PROBES,
                     noise_level: float = 0.1):
    """A function of (lo, hi): the latents of genomes lo..hi-1 of the
    pipeline's run in ``mode`` at ``seed`` (pipeline.py, ``submit``), on the
    sampler's device."""
    import torch

    from genome_minimizer_2_torch.core import prng

    dev = sampler.device
    key = prng.key(seed, dev)
    anchor = None
    if mode == "focused":
        probe_key, key = prng.split(key)
        anchor = torch.as_tensor(sampler.focused_anchor(probe_key, n_probes),
                                 device=dev)

    def latents(lo: int, hi: int):
        z = prng.draw_latents(key, torch.arange(lo, hi, device=dev),
                              sampler.cfg.latent_dim)
        if anchor is not None:
            z = anchor + torch.tensor(noise_level, device=dev) * z
        return z

    return latents


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
    sampler, engine, col_idx, ess, relevant = plain_lookup(inputs["model"],
                                                           inputs["genbank"])
    z = pipeline_latents(sampler, seed, mode)(0, CHUNK)
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
        log(f"{mode}: {stats.rate():.1f} genomes/s whole-run (sample "
            f"{stats.sample_s:.2f}s, minimize {stats.minimize_s:.2f}s, total "
            f"{stats.total_s:.2f}s) on {card}")
        runs[mode] = {"launches": launches, "chunks": chunks,
                      "genomes_per_s": stats.rate(),
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
    results["replayed"] = {fn.__name__: fn.replayed for fn in KR.KERNELS}
    results["wall_s"] = wall
    rates = [results["n_train"] / s for s in results["epoch_seconds"]]
    for e, (s, r) in enumerate(zip(results["epoch_seconds"], rates)):
        log(f"training epoch {e + 1}: {s:.3f} s, {r:.1f} examples/s "
            f"(train {results['n_train']} rows + validation) on {card}")
    results["examples_per_s"] = rates
    log(f"training path: whole experiment {wall:.1f} s; launches {launches}, "
        f"of them from CUDA graph replays {results['replayed']}")
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
    expected = {"gather_row_blocks": TRAIN_EPOCHS,
                "output_layer_bwd": TRAIN_EPOCHS * steps,
                "clip_adam_apply_leaves": TRAIN_EPOCHS * steps * adam_launches(),
                "weight_grad_bf16": TRAIN_EPOCHS * steps * WGRAD_A_STEP,
                "decode_threshold_pack": 1}  # the test set, one 2,048 batch
    log(f"training path: expected launches {expected}, counted {launches}")
    if launches != expected:
        raise AssertionError(f"launches {launches} != expected {expected}")
    # epoch 1 runs eagerly on the capture stream, epoch 2 replays its graphs
    replays = {k: v // TRAIN_EPOCHS * (TRAIN_EPOCHS - 1) for k, v in expected.items()}
    replays["decode_threshold_pack"] = 0
    check_launches("training path, from CUDA graph replays", results["replayed"],
                   replays)
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

    def updated(grads, apply_leaves):
        p = {k: v.detach().clone() for k, v in params.items()}
        opt = AdamState(state.opt.count.clone(),
                        {k: v.clone() for k, v in state.opt.mu.items()},
                        {k: v.clone() for k, v in state.opt.nu.items()})
        clip_adam_step(p, grads, opt, lr, config.max_norm, apply_leaves)
        return p

    p_kernel = updated(grads_k, KR.clip_adam_apply_leaves)
    p_plain_update = updated(grads_k, KR.clip_adam_apply_leaves_reference)
    p_plain = updated(grads_p, KR.clip_adam_apply_leaves_reference)
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
    state under torch.profiler, as the training program's replays: device
    time by kernel and busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    trainer._epoch.fill_(epoch)
    trainer._lr.fill_(trainer.config.learning_rate)
    n = train_x.shape[0]
    trainer.graphed_epoch(state, train_x, n, train=True)  # the capture
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.graphed_epoch(state, train_x, n, train=True)
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
                 "clip_adam_kernel", "weight_grad_kernel")


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
    steps = math.ceil(n_train / TRAIN_BATCH)
    for name, epochs in (("straight", ELASTIC_EPOCHS), ("crashed", ELASTIC_EPOCHS + 1)):
        want = {"decode_threshold_pack": 1, "gather_row_blocks": epochs,
                "output_layer_bwd": epochs * steps,
                "clip_adam_apply_leaves": epochs * steps * adam_launches(),
                "weight_grad_bf16": epochs * steps * WGRAD_A_STEP}
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


GRAPH_ROUNDS = 5  # eager and graphed epochs timed in turns, e g g e a round


def pool_bytes(pool) -> int:
    """Bytes of the segments the caching allocator holds for a CUDA graph
    memory pool: the pool's peak, since a private pool keeps every segment
    while a graph uses it."""
    import torch

    want = tuple(pool)
    total = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                if tuple(seg.get("segment_pool_id", ())) == want)
    if not total:
        raise AssertionError(f"no segment of graph pool {want} in the memory "
                             "snapshot")
    return total


def run_graph_check(data, root: Path, card: str) -> dict:
    """The training epoch as CUDA graphs at full v0 width, bf16 and float32:
    the trainer's epoch programs are built from a state (each one's first
    epoch eagerly on the capture stream, then the captures) and the state
    is put back; then 2 epochs from that state as replays against 2 epochs
    of the eager ``run_epoch`` from an equal one. Every state tensor
    (parameters, BatchNorm statistics, moments, count, counter, key) and
    every loss sum must be bit-equal, and each graphed epoch's launches
    must equal the eager epoch's, all of them from replays. Then the two
    ways' epoch wall times in turns (each epoch: training, validation and
    the one host read of the sums), a traced epoch of each way with the
    device's busy share, and the graph pool's size."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from genome_minimizer_2_torch.ops import kernels as KR
    from genome_minimizer_2_torch.train import trainer as T

    matrix, splits = data
    out = {}
    for name, dtype in (("bfloat16", "auto"), ("float32", "float32")):
        runner = experiment_runner(["--compute-dtype", dtype, "--experiment-name",
                                    f"v0_graph_{name}"], data)
        trainer, cfg = runner.trainer, runner.config
        sets = [(trainer.prepare_data(matrix.data[idx]), len(idx), train)
                for idx, train in ((splits.train_idx, True),
                                   (splits.val_idx, False))]
        eager, graphed = trainer.init_state(), trainer.init_state()

        def epoch(state, e, graphs):
            trainer._epoch.fill_(e)
            trainer._lr.fill_(T.step_lr(cfg.learning_rate, cfg.scheduler_step_size,
                                        cfg.scheduler_gamma, e))
            if graphs:  # each program's sums, until its next replay
                return [trainer.graphed_epoch(state, x, n, train)
                        for x, n, train in sets]
            return [trainer.run_epoch(state, x, n, e, trainer._lr, train)
                    for x, n, train in sets]

        # the snapshot holds no autograd graph: a clone of a parameter
        # would keep its gradient accumulator, made on this stream, alive
        # into the capture on the other
        with torch.no_grad():
            start = {k: v.clone() for k, v in graphed.leaves().items()}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        epoch(graphed, 0, True)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        with torch.no_grad():
            for k, v in graphed.leaves().items():
                v.copy_(start[k])
        del start
        pool = pool_bytes(trainer._pool)
        gaps, counts, losses = {}, [], []
        for e in range(2):
            KR.reset_launch_counts()
            want = epoch(eager, e, False)
            torch.cuda.synchronize()
            eager_counts = launch_counts()
            KR.reset_launch_counts()
            got = epoch(graphed, e, True)
            torch.cuda.synchronize()
            check_launches(f"graphs ({name}), epoch {e + 1}", launch_counts(),
                           eager_counts)
            replayed = {fn.__name__: fn.replayed for fn in KR.KERNELS}
            check_launches(f"graphs ({name}), epoch {e + 1}, from replays",
                           replayed, eager_counts)
            counts.append(eager_counts)
            for which, w, g in zip(("train", "validation"), want, got):
                for k in w:
                    if not torch.equal(w[k], g[k]):
                        gaps[f"epoch {e + 1} {which} {k}"] = abs(float(w[k]) - float(g[k]))
            losses.append([float(w["total"]) for w in want])
        le, lg = eager.leaves(), graphed.leaves()
        for k in le:
            if not torch.equal(le[k], lg[k]):
                gaps[k] = float((le[k].double() - lg[k].double()).abs().max())
        if gaps:
            log(f"graphs ({name}): NOT bit-equal to the eager epochs, max |diff| "
                f"by leaf: {gaps}")
            raise AssertionError(f"graphed epochs differ from eager ones ({name}): "
                                 f"{sorted(gaps)}")
        log(f"graphs ({name}): 2 epochs of {sets[0][1]} + {sets[1][1]} rows from "
            f"one state, replays against eager: all {len(le)} state tensors and "
            f"every loss sum bit-equal (total train, validation {losses}); "
            f"launches an epoch {counts[0]}, all from replays; programs built in "
            f"{build_s:.3f}s; graph pool {pool / 2**20:.1f} MiB; peak allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")

        # Every timed and traced epoch is epoch 2 again from the state after
        # the two checked epochs, put back before it outside the timing:
        # epoch 2 repeated on its own result drives v0's global norm to a
        # non-finite value within a few rounds, and every division of clip
        # + Adam then takes its slow path. Each timed epoch must give the
        # same sums, either way.
        with torch.no_grad():
            after = {"eager": {k: v.clone() for k, v in eager.leaves().items()},
                     "graphed": {k: v.clone() for k, v in graphed.leaves().items()}}
        sums = set()

        def put_back(way):
            state = graphed if way == "graphed" else eager
            with torch.no_grad():
                for k, v in state.leaves().items():
                    v.copy_(after[way][k])
            torch.cuda.synchronize()
            return state

        def timed(way):
            state = put_back(way)
            t0 = time.perf_counter()
            tr, vl = epoch(state, 1, way == "graphed")
            sums.add(tuple(torch.stack(list(tr.values()) + list(vl.values())).tolist()))
            return time.perf_counter() - t0

        times = {"eager": [], "graphed": []}
        for _ in range(GRAPH_ROUNDS):
            for way in ("eager", "graphed", "graphed", "eager"):
                times[way].append(timed(way))
        # the same epoch repeated on its own result, as the timing ran it
        # before it put the state back: the train loss of each
        drift = []
        for _ in range(GRAPH_ROUNDS * 2):
            tr, _ = epoch(graphed, 1, True)
            drift.append(float(tr["total"]))
        log(f"graphs ({name}): epoch 2 repeated on its own result "
            f"{len(drift)} times, train loss {drift}")
        med = {w: statistics.median(ts) for w, ts in times.items()}
        traced = {}
        for way in ("graphed", "eager"):
            state = put_back(way)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                tr, vl = epoch(state, 1, way == "graphed")
                sums.add(tuple(torch.stack(list(tr.values())
                                           + list(vl.values())).tolist()))
                wall = time.perf_counter() - t0
            path = root / f"graph_check_{name}_{way}.json"
            prof.export_chrome_trace(str(path))
            if len(sums) != 1 or not all(map(math.isfinite, next(iter(sums)))):
                raise AssertionError(f"graphs ({name}): the timed epochs' sums "
                                     f"differ or are not finite: {sorted(sums)}")
            busy, by_name = device_busy(str(path))
            top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
            traced[way] = {"wall_s": wall, "device_busy_s": busy,
                           "device_busy_share": busy / wall,
                           "top": [(nm[:90], tot / 1e3, cnt)
                                   for nm, (tot, cnt) in top]}
            path.unlink()
        n_train = sets[0][1]
        log(f"graphs ({name}): epoch wall time in turns ({GRAPH_ROUNDS} rounds "
            f"e g g e): eager median {med['eager'] * 1e3:.3f} ms "
            f"({n_train / med['eager']:.0f} examples/s, range "
            f"{min(times['eager']) * 1e3:.3f}-{max(times['eager']) * 1e3:.3f}), "
            f"graphed median {med['graphed'] * 1e3:.3f} ms "
            f"({n_train / med['graphed']:.0f} examples/s, range "
            f"{min(times['graphed']) * 1e3:.3f}-{max(times['graphed']) * 1e3:.3f}); "
            f"traced epoch: graphed device busy "
            f"{traced['graphed']['device_busy_s'] * 1e3:.3f} of "
            f"{traced['graphed']['wall_s'] * 1e3:.3f} ms "
            f"({100 * traced['graphed']['device_busy_share']:.2f}%), eager "
            f"{traced['eager']['device_busy_s'] * 1e3:.3f} of "
            f"{traced['eager']['wall_s'] * 1e3:.3f} ms "
            f"({100 * traced['eager']['device_busy_share']:.2f}%) on {card}; "
            "device time of the traced graphed epoch by kernel:")
        for nm, ms, cnt in traced["graphed"]["top"]:
            log(f"  {ms:10.3f} ms  x{cnt:<5d} {nm}")
        out[name] = {"launches_per_epoch": counts[0], "losses": losses,
                     "build_s": build_s, "pool_bytes": pool,
                     "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
                     "epoch_s": times, "median_s": med,
                     "examples_per_s": {w: n_train / m for w, m in med.items()},
                     "traced": traced, "repeated_epoch_train_loss": drift}
        trainer.drop_epoch_programs()
        del runner, trainer, sets, eager, graphed, le, lg
        torch.cuda.empty_cache()
    return out


def trace_window_busy(events) -> tuple[float, float]:
    """(device busy s, window s) over the last traced epoch: from its
    shuffle range to the end of validation, device spans (kernels, copies,
    fills) united."""
    ranges = [e for e in events if e.get("name") in TRACE_RANGES
              and e.get("ph") == "X"]
    lo = max(e["ts"] for e in ranges if e["name"] == "gm2/shuffle")
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
    """Two epochs through the runner with GM2_PROFILE_DIR set (the first
    eager and the captures, the second the graphs' replays): the trace file
    must hold the trainer's ranges and the training kernels; the device's
    busy share is read over the replayed epoch."""
    import torch

    from genome_minimizer_2_torch.ops import kernels as KR

    runner = experiment_runner(["--n-epochs", "2", "--checkpoint-every", "1",
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
    want = {"decode_threshold_pack": 0, "gather_row_blocks": 2,
            "output_layer_bwd": 2 * steps,
            "clip_adam_apply_leaves": 2 * steps * adam_launches(),
            "weight_grad_bf16": 2 * steps * WGRAD_A_STEP}
    check_launches("trace", launches, want)
    log(f"trace: {files[0].name} ({files[0].stat().st_size / 1e6:.1f} MB), "
        f"ranges {list(TRACE_RANGES)} and kernels {list(TRACE_KERNELS)} "
        f"present; traced epoch 2 (replays): device busy {busy:.4f}s of {window:.4f}s "
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

    n, B, axis = train_x.shape[0], trainer.config.batch_size, trainer.grid.everyone
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
    grid, trainer.grid = trainer.grid, None  # the one-process code, whole batch
    try:
        batch = trainer.prepare_data(train_x).index_select(0, order[:B])
        comps1, grads1, _ = trainer.loss_and_grads(trainer.init_state(), batch,
                                                   1, key)
    finally:
        trainer.grid = grid
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
            "clip_adam_apply_leaves": TRAIN_EPOCHS * steps * adam_launches(),
            "decode_threshold_pack": 1}
    want_sample = {"gather_row_blocks": 0, "output_layer_bwd": 0,
                   "clip_adam_apply_leaves": 0, "weight_grad_bf16": 0,
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
                           o[name]["launches"],
                           {**want, "weight_grad_bf16": (name == "bfloat16")
                            * TRAIN_EPOCHS * steps * WGRAD_A_STEP})
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


# ---------------------------------------------------------------------------
# phase 7: gene-axis tensor parallelism
# ---------------------------------------------------------------------------

TP_EXPERIMENT = "v0_tp"


def one_process_trainer(trainer):
    """A trainer of ``trainer``'s configuration on one process, made inside
    a group (as if it were alone): its reference for a step."""
    import dataclasses

    from genome_minimizer_2_torch.parallel import mesh
    from genome_minimizer_2_torch.train import trainer as T

    config = dataclasses.replace(trainer.config, data_parallel=1,
                                 model_parallel=1)
    place = mesh.rank_and_world
    mesh.rank_and_world = lambda: (0, 1)
    try:
        return T.create_trainer("v0", config, trainer.model_cfg.input_dim,
                                device=trainer.device)
    finally:
        mesh.rank_and_world = place


def tp_step_gaps(trainer, train_x) -> dict:
    """A train step from the initial state on epoch 1's first batch on the
    grid (each rank its rows and gene slice; the slices' gradients summed
    over the data axis, the other leaves' over the grid) and, on rank 0,
    on one process (the whole global batch, with no collective): the
    loss's and every leaf's relative gap in norm, the gene-sliced leaves
    gathered whole. Epoch 2's schedule (beta 0.5), as dp_step_gaps. The
    same step with the KL term counted on every model rank (a wrong model
    axis) gives the margin of the bounds. Other ranks return {}."""
    import dataclasses

    import torch

    from genome_minimizer_2_torch.core import prng
    from genome_minimizer_2_torch.parallel.mesh import gather_genes

    n, B, grid = train_x.shape[0], trainer.config.batch_size, trainer.grid
    state = trainer.init_state()
    axis = state.model.gene_axis
    rng, perm_key = prng.split(state.rng)
    order = prng.permutation(perm_key, n)
    _, key = prng.split(rng)
    rows, batches = trainer._shard_rows(trainer.prepare_data(train_x), n, order)
    lo, hi, share = batches[0]

    def step(share):
        comps, grads, _ = trainer.loss_and_grads(state, rows[lo:hi], 1, key, share)
        grads = gather_genes(trainer._sum_over_ranks(grads), axis)
        total = grid.everyone.all_reduce_(comps["total"].detach().clone())
        return float(total), grads

    total, grads = step(share)
    _, trap = step(dataclasses.replace(share, model=None))
    del rows
    if grid.everyone.rank != 0:
        return {}
    one = one_process_trainer(trainer)
    batch = one.prepare_data(train_x).index_select(0, order[:B])
    comps1, grads1, _ = one.loss_and_grads(one.init_state(), batch, 1, key)
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
            "trap_gaps": traps, "prebn_max": max(prebn.values()),
            "held": {k: list(v.shape) for k, v in state.model.flat_params().items()
                     if grid.holds_slice(k)}}


def tp_cli_run(rank: int) -> dict:
    """``--mode experiment --model-parallel 2`` through the CLI in this
    rank's group (2 epochs, a train-state file at epoch 2): launches and
    the shapes the kernels took; then the saved files against the ranks'
    gathered state, and the test-set bits against a one-process decode of
    the gathered parameters (rank 0)."""
    import numpy as np
    import torch

    from genome_minimizer_2_torch import cli
    from genome_minimizer_2_torch import experiments as E
    from genome_minimizer_2_torch.core import prng
    from genome_minimizer_2_torch.eval import metrics as ME
    from genome_minimizer_2_torch.models import vae
    from genome_minimizer_2_torch.ops import kernels as KR
    from genome_minimizer_2_torch.ops import output_layer as OL
    from genome_minimizer_2_torch.parallel.mesh import gather_genes
    from genome_minimizer_2_torch.utils import checkpoint as ckpt

    made, shapes = [], {"output_layer_bwd": set(), "decode_threshold_pack": set()}
    setup = E.IntegratedExperimentRunner.setup_model_and_training

    def recording_setup(self):
        setup(self)
        made.append(self)

    class Recording:
        """The kernels module as the loss and the metrics call it, noting
        the shape of each launch (the wrappers count their own)."""

        def __getattr__(self, name):
            return getattr(KR, name)

        def output_layer_bwd(self, logits, y, mask, h, w, *args):
            shapes["output_layer_bwd"].add((logits.shape[0], h.shape[1], w.shape[1]))
            return KR.output_layer_bwd(logits, y, mask, h, w, *args)

        def decode_threshold_pack(self, h, w, b, **kw):
            shapes["decode_threshold_pack"].add((h.shape[0], w.shape[0], w.shape[1]))
            return KR.decode_threshold_pack(h, w, b, **kw)

    E.IntegratedExperimentRunner.setup_model_and_training = recording_setup
    OL.K = ME.K = Recording()
    try:
        KR.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli.main(training_argv(["--model-parallel", str(TP_MODEL),
                                     "--data-parallel", "0", "--checkpoint-every",
                                     str(TRAIN_EPOCHS), "--experiment-name",
                                     TP_EXPERIMENT]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
    finally:
        E.IntegratedExperimentRunner.setup_model_and_training = setup
        OL.K = ME.K = KR
    runner = made[-1]
    st = runner.trainer.final_state
    axis = st.model.gene_axis
    out = {"rc": rc, "wall_s": wall, "launches": launches,
           "shapes": {k: sorted(v) for k, v in shapes.items()},
           "n_train": runner.results["n_train"],
           "n_test": len(runner._splits.test_idx),
           "held": {k: list(v.shape) for k, v in st.params.items()},
           "f1": runner.results["f1_overall"]}
    full = {"params/" + k: v for k, v in gather_genes(st.params, axis).items()}
    for name, moments in ((".mu/", st.opt.mu), (".nu/", st.opt.nu)):
        full.update({"opt_state/1/" + name + k: v
                     for k, v in gather_genes(moments, axis).items()})
    test_x = runner._matrix.data[runner._splits.test_idx]
    key = prng.key(runner.config.seed + 1, DEVICE)
    bits = ME.reconstruct_binary(st.model, test_x, key, runner.config.batch_size)
    out["f1_recomputed"] = ME.binary_f1(bits, np.asarray(test_x).astype(np.uint8))
    if rank != 0:
        return out
    model_dir = Path(runner.model_dir)
    unequal = []
    with np.load(model_dir / f"train_state_{TRAIN_EPOCHS}.npz") as z:
        for k, v in full.items():
            if not np.array_equal(z[k], v.detach().float().cpu().numpy()):
                unequal.append(k)
    params, stats, _, _ = ckpt.load_checkpoint(model_dir / "saved_VAE_v0.npz")
    unequal += [f"saved_VAE_v0/{k}" for k, v in params.items()
                if not np.array_equal(v, full["params/" + k].detach().float().cpu().numpy())]
    out["checkpoint"] = {"unequal": unequal, "leaves": len(full),
                         "shapes": {k: list(params[k].shape) for k in
                                    ("encoder/0/w", "decoder/3/w", "decoder/3/b")}}
    del full
    model = vae.params_from_flat(params, stats, st.model.cfg, DEVICE)
    one = ME.reconstruct_binary(model, test_x, key, runner.config.batch_size)
    diff = bits != one
    excused = 0
    if diff.any():
        B = runner.config.batch_size
        with torch.no_grad():
            logits = torch.cat([model.forward(
                model.gene_columns(torch.from_numpy(np.asarray(
                    test_x[lo: lo + B], np.float32)).to(DEVICE)),
                prng.fold_in(key, i), False)[0][:, :V0_INPUT_DIM].float().cpu()
                for i, lo in enumerate(range(0, len(test_x), B))]).numpy()
        near = np.abs(logits) < NEAR_ZERO
        excused = int((diff & near).sum())
        if excused != int(diff.sum()):
            raise AssertionError("a test-set bit differs from the one-process "
                                 "decode at a logit beyond 1e-3 of 0")
    out["bits"] = {"differing": int(diff.sum()), "bits": int(diff.size),
                   "records_differing": int(diff.any(axis=1).sum()),
                   "records": int(diff.shape[0]), "excused": excused}
    return out


def tp_worker(rank: int, world: int, port: int) -> int:
    """One rank of phase 7 (a subprocess): a gloo group of ``world`` ranks
    on the one card, a grid of data ``world / 2`` x model 2. The step
    check at float32 (and at bf16 on two ranks), then on two ranks the
    CLI's experiment mode; prints one JSON line."""
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    out, data = {"rank": rank}, None
    dtypes = (("float32", "float32"), ("bfloat16", "auto"))
    for name, dtype in dtypes if world == TP_MODEL else dtypes[:1]:
        t0 = time.perf_counter()
        runner = experiment_runner(["--compute-dtype", dtype, "--data-parallel",
                                    "0", "--model-parallel", str(TP_MODEL),
                                    "--experiment-name", f"v0_tp_{name}"], data)
        data = runner._matrix, runner._splits
        out[name] = tp_step_gaps(runner.trainer, data[0].data[data[1].train_idx])
        out[name + "_s"] = time.perf_counter() - t0
        log(f"tensor parallel {world} ranks, {name} step: {json.dumps(out[name])}")
        del runner
        torch.cuda.empty_cache()
    del data
    if world == TP_MODEL:
        out["cli"] = tp_cli_run(rank)
    dist.barrier()
    dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


def spawn_tp(world: int, root: Path) -> tuple[list, float]:
    """Phase 7's ranks on a fresh gloo group; their JSON and the wall time."""
    port = free_port()
    logs = [root / f"tp{world}_rank{r}.log" for r in range(world)]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    t0 = time.perf_counter()
    procs = []
    for r in range(world):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--tp-worker",
                 str(r), str(world), str(port)], stdout=f,
                stderr=subprocess.STDOUT, env=env, cwd=str(REPO)))
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
            raise AssertionError(f"tensor-parallel rank {r} of {world} exited {rc}")
        outs.append(json.loads([line for line in text.splitlines()
                                if line.startswith('{"rank"')][-1]))
    return outs, wall


def check_tp_step(label: str, step: dict, bound: float) -> dict:
    """Hold a grid step to one process's: the loss and the output layer's
    dW (and at float32 db) to ``bound``, at float32 every other leaf to
    UPSTREAM_RTOL in norm (pre-BatchNorm biases reported), and there the
    KL trap must move some held leaf past its limit."""
    f32 = bound == TP_STEP_RTOL
    held = {k: (bound if k.startswith("decoder/3/") else UPSTREAM_RTOL)
            for k in step["grad_gaps"]
            if f32 or k == "decoder/3/w"}
    ratio = {k: step["grad_gaps"][k] / held[k] for k in held}
    trap = {k: step["trap_gaps"][k] / held[k] for k in held}
    worst, caught = max(ratio, key=ratio.get), max(trap, key=trap.get)
    upstream = {k: g for k, g in step["grad_gaps"].items()
                if not k.startswith("decoder/3/")}
    loose = max(upstream, key=upstream.get)
    log(f"tensor parallel {label}: first step on the grid vs one process: loss "
        f"{step['loss_gap']:.3g} (bound {bound}), output layer dW "
        f"{step['grad_gaps']['decoder/3/w']:.3g} and db "
        f"{step['grad_gaps']['decoder/3/b']:.3g} in norm (bound {bound}"
        f"{'' if f32 else ' on dW; db printed'}), worst upstream leaf {loose} "
        f"{upstream[loose]:.3g} in norm "
        f"({'held to ' + str(UPSTREAM_RTOL) if f32 else 'printed'}); worst held "
        f"leaf {worst} at {ratio[worst]:.3g}x its limit; with the KL term counted "
        f"on every model rank {trap[caught]:.3g}x ({caught}); pre-BatchNorm bias "
        f"gradients (rounding noise) up to {step['prebn_max']:.3g}; gene slices "
        f"held {step['held']}")
    if step["loss_gap"] > bound or ratio[worst] > 1.0:
        raise AssertionError(f"tensor parallel {label}: the grid's step differs "
                             "from one process beyond its limits")
    if f32 and trap[caught] <= 1.0:
        raise AssertionError(f"tensor parallel {label}: the limits would pass the "
                             "KL term counted on every model rank")
    return {"step_loss": step["loss_gap"],
            "step_held_worst_vs_limit": {worst: ratio[worst]},
            "step_output_layer": {k: step["grad_gaps"][k]
                                  for k in ("decoder/3/w", "decoder/3/b")},
            "step_upstream_worst": {loose: upstream[loose]},
            "step_kl_trap_vs_limit": {caught: trap[caught]},
            "step_prebn_max": step["prebn_max"]}


def run_tensor_parallel(root: Path, card: str) -> dict:
    """Phase 7: data 1 x model 2 (two gloo ranks on the one card): the step
    at float32 and bf16 and ``--mode experiment --model-parallel 2``; then
    data 2 x model 2 (four ranks): the float32 step."""
    outs, wall = spawn_tp(TP_MODEL, root)
    held = {"encoder/0/w": [TP_SLICE, V0_HIDDEN],
            "decoder/3/w": [V0_HIDDEN, TP_SLICE], "decoder/3/b": [TP_SLICE]}
    res = {"wall_s": wall}
    for name, bound in (("float32", TP_STEP_RTOL), ("bfloat16", BF16_DP_RTOL)):
        if outs[0][name]["held"] != held:
            raise AssertionError(f"a rank held {outs[0][name]['held']}")
        res[f"1x2 {name}"] = check_tp_step(f"1 x 2 {name}", outs[0][name], bound)
    cli = [o["cli"] for o in outs]
    batches = lambda n: [min(TRAIN_BATCH, n - lo)  # noqa: E731
                         for lo in range(0, n, TRAIN_BATCH)]
    train_b, test_b = batches(cli[0]["n_train"]), batches(cli[0]["n_test"])
    want = {"gather_row_blocks": 0,
            "output_layer_bwd": TRAIN_EPOCHS * len(train_b),
            "clip_adam_apply_leaves": TRAIN_EPOCHS * len(train_b) * adam_launches(),
            "weight_grad_bf16": TRAIN_EPOCHS * len(train_b) * WGRAD_A_STEP,
            "decode_threshold_pack": len(test_b)}  # the test set's batches
    # each at the gene slice of TP_SLICE
    shapes = {"output_layer_bwd": sorted({(b, V0_HIDDEN, TP_SLICE) for b in train_b}),
              "decode_threshold_pack": sorted({(b, V0_HIDDEN, TP_SLICE)
                                               for b in test_b})}
    for r, c in enumerate(cli):
        log(f"tensor parallel CLI rank {r}: rc {c['rc']}, {c['wall_s']:.1f}s, "
            f"launches {c['launches']}, kernel shapes {c['shapes']}, held "
            f"{ {k: c['held'][k] for k in held} }, test F1 {c['f1']:.6f} "
            f"(recomputed {c['f1_recomputed']:.6f})")
        if c["rc"] != 0:
            raise AssertionError(f"--model-parallel 2 rank {r} exited {c['rc']}")
        check_launches(f"--model-parallel 2 rank {r}", c["launches"], want)
        got = {k: sorted(tuple(x) for x in v) for k, v in c["shapes"].items()}
        if got != shapes:
            raise AssertionError(f"rank {r}: kernel shapes {got}, expected {shapes}")
        if {k: c["held"][k] for k in held} != held:
            raise AssertionError(f"rank {r} held {c['held']}")
        if c["f1"] != c["f1_recomputed"] or c["f1"] != cli[0]["f1"]:
            raise AssertionError("the ranks' test-set F1 differ")
    ck, bits = cli[0]["checkpoint"], cli[0]["bits"]
    log(f"tensor parallel CLI: rank 0's train_state_{TRAIN_EPOCHS}.npz and "
        f"saved_VAE_v0.npz against the ranks' gathered state: "
        f"{len(ck['unequal'])} unequal of {ck['leaves']} leaves, full shapes "
        f"{ck['shapes']}; test-set bits against a one-process decode of the "
        f"gathered parameters: {bits['differing']} of {bits['bits']} differ "
        f"({bits['excused']} at |logit| < {NEAR_ZERO}), "
        f"{bits['records_differing']} of {bits['records']} records")
    if ck["unequal"] or ck["shapes"] != {"encoder/0/w": [V0_PADDED, V0_HIDDEN],
                                         "decoder/3/w": [V0_HIDDEN, V0_PADDED],
                                         "decoder/3/b": [V0_PADDED]}:
        raise AssertionError(f"the checkpoint is not the gathered state: {ck}")
    if bits["records_differing"] > MAX_EXCUSED_FRACTION * bits["records"]:
        raise AssertionError("more than 1% of the test records differ from "
                             "the one-process decode")
    res["cli"] = {k: v for k, v in cli[0].items() if k != "held"}
    res["cli_launches"] = [c["launches"] for c in cli]
    outs4, wall4 = spawn_tp(2 * TP_MODEL, root)
    if outs4[0]["float32"]["held"] != held:
        raise AssertionError(f"a rank of 2 x 2 held {outs4[0]['float32']['held']}")
    res["2x2 float32"] = check_tp_step("2 x 2 float32", outs4[0]["float32"],
                                       TP_STEP_RTOL)
    res["wall_4_s"] = wall4
    log(f"tensor parallel: 1 x 2 in {wall:.1f}s (float32 step "
        f"{outs[0]['float32_s']:.1f}s, bf16 step {outs[0]['bfloat16_s']:.1f}s, "
        f"CLI {cli[0]['wall_s']:.1f}s on rank 0), 2 x 2 in {wall4:.1f}s on {card}")
    return res


# ---------------------------------------------------------------------------
# phase 8: the reference, the JAX package's answers at float32
# ---------------------------------------------------------------------------

GOLDEN = REPO / "tests" / "golden" / "torch_port_jax_v0.json"
# the Linear biases ahead of a BatchNorm: zero gradient in exact arithmetic
PRE_BN = tuple(f"params/{t}/{i}/b" for t in ("encoder", "decoder") for i in range(3))
LOSS_TOL = {"train": (1e-4, 1e-6), "val": (1e-4, 5e-3)}  # rtol, atol
F1_TOL = 1e-3
GRAD_RTOL = 1e-4  # the first gradient's, of its norm
PROJ_SIGMAS = 5.0  # its projection's limit, in deviations of the difference
# a quantity is held to its stated tolerance or to this many times the
# farthest that the reference's reordered runs move it, whichever is wider:
# each of those runs, held so by the other eight, needs at most 2.07
SPREAD_FACTOR = 3.0


def load_golden(path: Path = GOLDEN) -> dict:
    """The JAX package's answers (tests/_torch_jax_golden.py writes them),
    read as JSON."""
    return json.loads(Path(path).read_text())


def digest(data: bytes, golden: dict) -> str:
    import hashlib

    return hashlib.sha256(data).hexdigest()[: golden["recipe"]["digest_hex"]]


def leaves_digest(flat: dict) -> str:
    """SHA-256 of the leaves' float32 bytes in the order of their sorted
    names (the reference hashes its leaves so)."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for k in sorted(flat):
        h.update(k.encode())
        h.update(np.ascontiguousarray(flat[k].detach().cpu().numpy(),
                                      np.float32).tobytes())
    return h.hexdigest()


def model_leaves(model) -> dict:
    return {**{"params/" + k: v for k, v in model.flat_params().items()},
            **{"batch_stats/" + k: v for k, v in model.flat_stats().items()}}


def reference_config(golden: dict, compute_dtype: str):
    from genome_minimizer_2_torch.utils.config import get_preset_config

    r = golden["recipe"]
    cfg = get_preset_config("v0")
    cfg.hidden_dim, cfg.latent_dim, cfg.batch_size = r["hidden"], r["latent"], r["batch"]
    cfg.compute_dtype, cfg.seed, cfg.n_epochs = compute_dtype, r["seed"], r["epochs"]
    return cfg


def reference_inputs(root: Path, golden: dict, device: str) -> dict:
    """The reference's inputs rebuilt from its recipe by the port's own
    generators (the gene vocabulary, essentials, GenBank, matrix) and
    ``init_from_key`` (the checkpoint), each held to the reference's digest
    before anything runs; then the data tree the CLI reads under ``root``
    and the checkpoint at float32 and at bf16."""
    import hashlib
    import pickle

    import numpy as np
    import pandas as pd

    from genome_minimizer_2_torch.core import prng
    from genome_minimizer_2_torch.data import synthetic
    from genome_minimizer_2_torch.models import vae
    from genome_minimizer_2_torch.utils import checkpoint as ckpt
    from genome_minimizer_2_torch.utils import directories

    r, seed = golden["recipe"], golden["recipe"]["seed"]
    data = root / "data"
    data.mkdir(parents=True)
    genes = synthetic.make_gene_names(r["genes"], np.random.RandomState(seed))
    ess_csv = data / "essential_genes.csv"
    essentials = synthetic.write_essential_genes_csv(ess_csv, genes,
                                                     r["essentials"], seed)
    gb = data / "wild_type_sequence.gb"
    synthetic.write_genbank(gb, genes, r["genome_length"], seed)
    matrix = synthetic.presence_absence_matrix(r["genomes"], r["genes"], seed)
    cfg = vae.VAEConfig(input_dim=r["genes"], hidden_dim=r["hidden"],
                        latent_dim=r["latent"])
    model = vae.init_from_key(cfg, prng.key(seed, device))
    got = {"genes": hashlib.sha256("\n".join(genes).encode()).hexdigest(),
           "essentials": hashlib.sha256(ess_csv.read_bytes()).hexdigest(),
           "genbank": hashlib.sha256(gb.read_bytes()).hexdigest(),
           "matrix": hashlib.sha256(matrix.tobytes()).hexdigest(),
           "checkpoint": leaves_digest(model_leaves(model))}
    differ = [k for k, v in got.items() if v != golden["sha256"][k]]
    if differ:
        raise AssertionError(f"inputs differ from the reference's: {differ} "
                             "(another numpy stream or generator; not a "
                             "fault of the port)")
    # the CLI's data tree: the vocabulary in a CSV of a few genomes (sample
    # mode encodes their test split), phylogroups, the positions pickle
    few = [f"sample_{i:04d}" for i in range(32)]
    pd.DataFrame(matrix[: len(few)].T, index=genes, columns=few).to_csv(
        data / "F4_complete_presence_absence.csv")
    synthetic.write_phylogroups_csv(data / "accessionID_phylogroup_BD.csv",
                                    few, seed)
    col = {g: i for i, g in enumerate(genes)}
    pos_path = Path(directories.essential_genes_positions())
    pos_path.parent.mkdir(parents=True, exist_ok=True)
    with open(pos_path, "wb") as f:
        pickle.dump({g: [col[g]] for g in essentials if g in col}, f)
    models = {}
    for dtype in ("float32", "bfloat16"):
        models[dtype] = str(root / "models" / f"v0_reference_{dtype}.npz")
        ckpt.save_checkpoint(models[dtype], model.flat_params(), model.flat_stats(),
                             reference_config(golden, dtype),
                             extra={"input_dim": r["genes"]})
    return {"genes": genes, "genbank": str(gb), "matrix": matrix,
            "models": models, "sha256": got}


def fasta_digests(path: str, golden: dict, header: bool = True) -> list:
    """The digest of each record (its two lines) of a FASTA the pipeline
    wrote, after its three '#' lines when ``header``: the records are found
    in a map of the file and hashed on every core (one thread reading a
    6 GB file line by line takes half a minute)."""
    import hashlib
    import mmap
    from concurrent.futures import ThreadPoolExecutor

    n_hex = golden["recipe"]["digest_hex"]
    if os.path.getsize(path) == 0:
        return []
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as m:
        pos, spans = 0, []
        for _ in range(3 if header else 0):
            if m[pos:pos + 2] != b"# ":
                raise AssertionError(f"bad header line in {path}")
            pos = m.find(b"\n", pos) + 1
        while pos < len(m):
            end = m.find(b"\n", m.find(b"\n", pos) + 1)
            if end < 0:
                raise AssertionError(f"{path}: a record is cut short")
            spans.append((pos, end + 1))
            pos = end + 1
        view = memoryview(m)
        try:
            with ThreadPoolExecutor() as pool:
                return list(pool.map(
                    lambda s: hashlib.sha256(view[s[0]:s[1]]).hexdigest()[:n_hex],
                    spans))
        finally:
            view.release()


def put_bits(row, signed_genes: list):
    """The packed row with the reference's bits at its near-zero genes
    (``g + 1`` for a 1, ``-(g + 1)`` for a 0)."""
    row = row.copy()
    for e in signed_genes:
        g = abs(e) - 1
        if e > 0:
            row[g // 8] |= 1 << (g % 8)
        else:
            row[g // 8] &= ~(1 << (g % 8)) & 0xFF
    return row


def hold_rows(label: str, got: list, want: list, fixed, near, tau: float) -> dict:
    """Hold rows (FASTA records or packed rows) to the reference's digests.
    A row that differs is proven to differ only at the reference's
    near-zero bits (|logit| < tau there) when ``fixed(i)``, its digest with
    the reference's bits there, equals the reference's; otherwise it is
    excused when ``near(i)`` (a bit of it has a plain float32 logit within
    NEAR_ZERO of 0 here), at most MAX_EXCUSED_FRACTION of the rows;
    otherwise it fails."""
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} rows, the reference has "
                             f"{len(want)}")
    differ = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    proven = [i for i in differ if fixed(i) == want[i]]
    rest = sorted(set(differ) - set(proven))
    bad = [i for i in rest if not near(i)]
    if bad:
        raise AssertionError(f"{label}: rows {bad[:10]} differ from the "
                             f"reference outside its near-zero bits and hold "
                             f"no bit with |logit| < {NEAR_ZERO}")
    check_excused(label, len(rest), len(want))
    log(f"{label}: {len(want) - len(differ)} of {len(want)} byte-equal to the "
        f"JAX package's; {len(proven)} differ, each equal to it with the "
        f"reference's bits at its |logit| < {tau:g}; {len(rest)} excused (a "
        f"bit with |logit| < {NEAR_ZERO} here; cap "
        f"{int(MAX_EXCUSED_FRACTION * len(want))})")
    return {"rows": len(want), "equal": len(want) - len(differ),
            "differ": len(differ), "near_zero_proven": len(proven),
            "excused": len(rest)}


def plain_near(sampler, z, cols=None):
    """Per row of z: does a bit (of ``cols``, or any) have a plain float32
    logit within NEAR_ZERO of 0."""
    logits, _ = plain_decode(sampler, z)
    if cols is not None:
        logits = logits[:, cols]
    return (logits.abs() < NEAR_ZERO).any(dim=1).cpu().numpy()


def hold_pipeline(label: str, got: list, golden: dict, mode: str,
                  lookup: tuple, records: int | None = None) -> dict:
    """The pipeline's records against the reference's first ``records``
    (all of its records by default; a run of fewer genomes holds a
    prefix): there must be as many, and a record that differs is rebuilt
    from the kernel's decode of its chunk (which must give the pipeline's
    record again) with the reference's near-zero bits. ``lookup`` is
    ``plain_lookup``'s of the run's checkpoint and GenBank."""
    import torch

    ref, chunk = golden["pipeline"][mode], golden["recipe"]["chunk"]
    if ref["records"] != len(ref["digests"]):
        raise AssertionError(f"{label}: the reference's record count "
                             f"{ref['records']} is not its digests'")
    want = ref["digests"][: ref["records"] if records is None else records]
    sampler, engine, col_idx, ess, relevant = lookup
    r = golden["recipe"]
    latents = pipeline_latents(sampler, r["seed"], mode, r["n_probes"],
                               r["noise_level"])
    rows, near = {}, {}
    for lo in sorted({i // chunk * chunk for i, (a, b) in enumerate(
            zip(got, want)) if a != b}):
        z = latents(lo, lo + chunk)
        with torch.no_grad():
            packed = sampler._decode_packed(z).cpu().numpy()
        flags = plain_near(sampler, z, relevant)
        for j in range(chunk):
            rows[lo + j], near[lo + j] = packed[j], bool(flags[j])

    def record(i, row) -> str:
        fd, path = tempfile.mkstemp(suffix=".fasta")
        os.close(fd)
        try:
            engine.minimize_packed_to_fasta(row[None], col_idx, ess, path,
                                            start_index=i)
            (d,) = fasta_digests(path, golden, header=False)
        finally:
            os.remove(path)
        return d

    def fixed(i):
        if record(i, rows[i]) != got[i]:
            raise AssertionError(f"{label}: record {i} of the kernel's decode "
                                 "again differs from the pipeline's")
        return record(i, put_bits(rows[i], ref["near_zero"][i]))

    return hold_rows(label, got, want, fixed, near.__getitem__,
                     golden["recipe"]["near_zero"])


def hold_sample(packed, golden: dict, lookup: tuple) -> dict:
    """The sample file's packed rows against the reference's (the default
    latents, so the pipeline's default near-zero bits)."""
    ref = golden["pipeline"]["default"]["near_zero"]
    got = [digest(row.tobytes(), golden) for row in packed]
    sampler = lookup[0]
    latents = pipeline_latents(sampler, golden["recipe"]["seed"], "default")
    chunk, near = golden["recipe"]["chunk"], {}

    def near_zero(i):
        lo = i // chunk * chunk
        if lo not in near:
            near[lo] = plain_near(sampler, latents(lo, lo + chunk))
        return bool(near[lo][i - lo])

    return hold_rows("sample rows", got, golden["sample"]["digests"],
                     lambda i: digest(put_bits(packed[i], ref[i]).tobytes(), golden),
                     near_zero, golden["recipe"]["near_zero"])


def reference_trainer(golden: dict, matrix, device: str, epochs: int):
    """The v0 trainer of the reference's run and its float32 rows (train,
    validation, test) from the matrix's 70/20/10 split."""
    import numpy as np

    from genome_minimizer_2_torch.data.split import three_way_split
    from genome_minimizer_2_torch.train.trainer import create_trainer

    cfg = reference_config(golden, "float32")
    sp = three_way_split(matrix.shape[0], cfg.test_size, cfg.val_ratio,
                         cfg.random_state)
    rows = [matrix[idx].astype(np.float32) for idx in sp]
    # the loss schedule is the recipe's (it takes n_epochs at creation);
    # train() then stops after ``epochs``
    trainer = create_trainer("v0", cfg, matrix.shape[1], device=device)
    cfg.n_epochs = epochs
    return trainer, rows


def state_leaves(state) -> dict:
    """Parameters, BatchNorm statistics and Adam moments by their names in a
    train-state file."""
    return {k: v for k, v in state.leaves().items()
            if k.startswith(("params/", "batch_stats/", "opt_state/1/.mu/",
                             "opt_state/1/.nu/"))}


def leaf_stats(leaves: dict, init: dict) -> dict:
    """Per leaf, in float64 where it lies: n, sum, sum of squares, largest
    magnitude; for a leaf of ``init`` the sum and sum of squares of its
    change from it (the reference's statistics, tests/_torch_jax_golden.py)."""
    out = {}
    for k, t in leaves.items():
        a = t.detach().double()
        s = {"n": a.numel(), "sum": float(a.sum()), "sumsq": float(a.square().sum()),
             "max_abs": float(a.abs().max())}
        if k in init:
            u = a - init[k].detach().to(a.device, a.dtype)
            s.update(upd_sum=float(u.sum()), upd_sumsq=float(u.square().sum()))
        out[k] = s
    return out


def worst_share(pairs) -> float:
    """The largest |x - y| / limit over (x, y, limit) triples."""
    return max(abs(x - y) / lim if lim > 0 else (0.0 if x == y else math.inf)
               for x, y, lim in pairs)


def leaf_ratio(k: str, got: dict, want: dict, atol: float, tol: float):
    """How far leaf k's statistics ``got`` lie from the reference's
    ``want``, as a share of the limit ``_assert_same_run``
    (tests/test_torch_train_trainer.py) implies for them; None for the
    moments of a Linear bias ahead of a BatchNorm (rounding noise).

    There a leaf p is held to the reference's p_ref by |p - p_ref| <= tol
    |u_ref| in norm (u the change from the shared p_0, tol 5e-2 without an
    L1 term, else 1e-3), which implies through the triangle and
    Cauchy-Schwarz inequalities | |p| - |p_ref| | and | |u| - |u_ref| | <=
    tol |u_ref| and |sum p - sum p_ref| and |sum u - sum u_ref| <= tol
    sqrt(n) |u_ref|; a moment is a change from 0. The BatchNorm statistics
    follow assert_allclose(rtol tol, atol), so | |s| - |s_ref| | <= sqrt(n)
    atol + tol |s_ref| and |sum s - sum s_ref| <= n atol + tol sqrt(n)
    |s_ref|. A Linear bias ahead of a BatchNorm has a zero gradient in exact
    arithmetic and is held to |p| <= atol on both sides (atol = 3 lr x
    steps)."""
    n, norm = want["n"], math.sqrt
    base = k.split("/", 3)[-1] if k.startswith("opt_state/") else None
    if k in PRE_BN:
        return max(got["max_abs"], want["max_abs"]) / atol
    if base is not None and f"params/{base}" in PRE_BN:
        return None
    if k.startswith("batch_stats/"):
        return worst_share([
            (norm(got["sumsq"]), norm(want["sumsq"]),
             norm(n) * atol + tol * norm(want["sumsq"])),
            (got["sum"], want["sum"], n * atol + tol * norm(n * want["sumsq"]))])
    upd = "upd_sumsq" in want
    ref = tol * norm(want["upd_sumsq"] if upd else want["sumsq"])
    pairs = [(norm(got["sumsq"]), norm(want["sumsq"]), ref),
             (got["sum"], want["sum"], norm(n) * ref)]
    if upd:
        pairs += [(norm(got["upd_sumsq"]), norm(want["upd_sumsq"]), ref),
                  (got["upd_sum"], want["upd_sum"], norm(n) * ref)]
    return worst_share(pairs)


def grad_ratio(k: str, got: dict, want: dict):
    """How far the statistics of leaf k's first gradient lie from the
    reference's, as a share of their limits at GRAD_RTOL of its norm: the
    norm, the sum (sqrt(n) times), and the projection on a fixed normal
    vector (``grad_stats``; PROJ_SIGMAS times: for a difference d it is
    normal with a deviation of about |d|); None for a Linear bias ahead of
    a BatchNorm, whose gradient is 0 in exact arithmetic."""
    if k in PRE_BN:
        return None
    ref = GRAD_RTOL * math.sqrt(want["sumsq"])
    return worst_share([(math.sqrt(got["sumsq"]), math.sqrt(want["sumsq"]), ref),
                        (got["sum"], want["sum"], math.sqrt(want["n"]) * ref),
                        (got["projection"], want["projection"], PROJ_SIGMAS * ref)])


def fold(a, length: int):
    """A flat vector folded onto ``length`` places (place i sums the
    entries i, i + length, ...), or as it is if it is no longer."""
    import torch

    if a.numel() <= length:
        return a
    a = torch.nn.functional.pad(a, (0, -a.numel() % length))
    return a.view(-1, length).sum(dim=0)


def grad_stats(golden: dict, *grads: dict) -> list:
    """Per gradient, per leaf ``params/...``: n, sum, sum of squares and the
    projection of the leaf, folded onto the recipe's ``projection_len``
    places, on the normal vector ``prng.normal(key(0), (projection_len,))``
    (JAX's draw), in float64 where the gradient lies, as the reference
    computes them (tests/_torch_jax_golden.py ``projection``)."""
    from genome_minimizer_2_torch.core import prng

    length = golden["recipe"]["projection_len"]
    device = next(iter(grads[0].values())).device
    r = prng.normal(prng.key(0, device), (length,)).double()
    out = [{} for _ in grads]
    for name in sorted(grads[0]):
        for o, g in zip(out, grads):
            a = g[name].detach().double().reshape(-1)
            f = fold(a, length)
            o[name] = {"n": a.numel(), "sum": float(a.sum()),
                       "sumsq": float(a.square().sum()),
                       "projection": float((f * r[: f.numel()]).sum())}
    return out


@contextlib.contextmanager
def relu_decided(signed: list):
    """The port's hidden blocks (``models/vae.py::Block``, train mode, one
    process) with each layer's ReLU taking the side ``signed[layer]`` gives
    at those activations (``i + 1`` above 0, ``-(i + 1)`` not, i the flat
    index), the reference's side at its near-zero ReLU inputs; yields the
    number of those on the other side here, per layer. The block is
    restated for it, so ``first_gradient`` first holds it, with nothing
    decided, to the real block bit for bit."""
    import torch

    from genome_minimizer_2_torch.models import vae as V

    original, other = V.Block.forward, []

    def forward(self, x, policy, train=False, share=None):
        if not train or share is not None:
            raise AssertionError("relu_decided covers the one-process train forward")
        h = V.Linear.forward(self, x, policy)
        mean = h.mean(dim=0)
        var = (h - mean).square().mean(dim=0)
        n = h.shape[0]
        stats = ((1 - V.BN_MOMENTUM) * self.bn_mean + V.BN_MOMENTUM * mean.detach(),
                 (1 - V.BN_MOMENTUM) * self.bn_var
                 + V.BN_MOMENTUM * (var * (n / max(n - 1, 1))).detach())
        h = (h - mean) * torch.rsqrt(var + V.BN_EPS) * self.bn_scale + self.bn_bias
        keep = (h > 0).view(-1)
        e = torch.tensor(signed[len(other)], dtype=torch.int64, device=h.device)
        side = e > 0
        other.append(int((keep[e.abs() - 1] != side).sum()))
        keep[e.abs() - 1] = side
        return torch.where(keep.view_as(h), h, torch.zeros((), device=h.device)), stats

    V.Block.forward = forward
    try:
        yield other
    finally:
        V.Block.forward = original


def first_gradient(trainer, state, train_x, golden: dict, device: str) -> dict:
    """The reference's ``training.first_grad`` here: the loss's gradient at
    the initial ``state`` on the first batch of training rows with the eps
    of key(seed + grad_key) at epoch 0, through
    ``VAETrainer.loss_and_grads``, which leaves the state as it was and
    whose graph is gone when it returns. Returns the statistics of that
    gradient and of the same with each ReLU decided as the reference
    decided it at its near-zero inputs (``relu_decided``; with nothing
    decided it must give the first gradient bit for bit), and how many of
    those decisions fell the other way here, per layer."""
    import torch

    from genome_minimizer_2_torch.core import prng

    r = golden["recipe"]
    batch = trainer.prepare_data(train_x[: r["batch"]])

    def gradient():
        key = prng.key(r["seed"] + r["grad_key"], device)
        _, grads, _ = trainer.loss_and_grads(state, batch, 0, key)
        return {f"params/{k}": g for k, g in grads.items()}

    plain = gradient()
    near = golden["training"]["relu_near_zero"]
    with relu_decided([[] for _ in near]):
        restated = gradient()
    differ = [k for k in plain if not torch.equal(plain[k], restated[k])]
    if differ:
        raise AssertionError(f"relu_decided's block differs from the port's: {differ}")
    del restated
    with relu_decided(near) as other:
        decided = gradient()
    stats, decided_stats = grad_stats(golden, plain, decided)
    return {"plain": stats, "decided": decided_stats, "relu_other_side": other}


def hold_first_gradient(first: dict, golden: dict) -> dict:
    """The first gradient with the reference's ReLU decisions at its
    near-zero inputs, each leaf within GRAD_RTOL of its norm (its norm, sum
    and projection; ``grad_ratio``). A ReLU decision that differs at an
    input farther from 0 would move a leaf by about 1e-3 of its norm and
    fail here. The gradient as it is (what training takes) is printed: it
    differs only by those decisions."""
    ref = golden["training"]["first_grad"]

    def ratios(stats):
        out = {k: grad_ratio(k, stats[k], want) for k, want in ref.items()}
        return {k: v for k, v in out.items() if v is not None}

    decided, plain = ratios(first["decided"]), ratios(first["plain"])
    bad = [f"{k} at {v:.3g}" for k, v in decided.items() if v > 1.0]
    if bad:
        raise AssertionError(f"the first gradient, the reference's ReLU decisions "
                             f"taken, against the JAX package's (rtol "
                             f"{GRAD_RTOL}): {bad}")
    worst = max(decided, key=decided.get)
    worst_plain = max(plain, key=plain.get)
    near = golden["training"]["relu_near_zero"]
    log(f"first gradient: {sum(first['relu_other_side'])} of the JAX package's "
        f"{sum(map(len, near))} ReLU inputs within "
        f"{golden['recipe']['relu_near_zero']:g} of 0 fall on the other side "
        f"here (per layer {first['relu_other_side']}); with its decisions "
        f"there, {len(decided)} leaves within rtol {GRAD_RTOL:g} of the JAX "
        f"package's, worst {worst} at {decided[worst]:.3g} of the limit; as "
        f"it is, worst {worst_plain} at {plain[worst_plain]:.3g} (not held)")
    return {"relu_other_side": first["relu_other_side"],
            "relu_near_zero": [len(x) for x in near],
            "worst_decided": {"leaf": worst, "share": decided[worst]},
            "worst_plain": {"leaf": worst_plain, "share": plain[worst_plain]}}


def training_record(trainer, init: dict, epochs: int) -> dict:
    """The port's run in the reference's layout (tests/_torch_jax_golden.py):
    each epoch's losses, and the last epoch's counter, rng, early stopping
    and leaf statistics."""
    state, es = trainer.final_state, trainer.early_stopping
    rec = [{"train_losses": {k: v[e] for k, v in trainer.train_losses.items()},
            "val_losses": {k: v[e] for k, v in trainer.val_losses.items()}}
           for e in range(epochs)]
    rec[-1].update(counter=int(state.counter), rng=state.rng.cpu().tolist(),
                   early_stopping={"best_loss": float(es.best_loss),
                                   "epochs_no_improve": int(es.epochs_no_improve)},
                   leaves=leaf_stats(state_leaves(state), init))
    return {"epochs": rec}


def run_ratios(run: dict, golden: dict, epochs: int) -> tuple[list, dict]:
    """``run`` (the reference's layout) against the reference's first
    ``epochs`` epochs: the exact checks' failures (counter, rng key,
    early-stopping count, the leaves' names) and, per quantity, its
    distance from the reference as a share of its stated tolerance: each
    epoch's losses (train rtol 1e-4 / atol 1e-6, validation rtol 1e-4 /
    atol 5e-3, the early-stopping best loss as a validation loss) and each
    leaf of the last epoch (``leaf_ratio``)."""
    ref = golden["training"]
    fails, out = [], {}
    for e in range(epochs):
        for part in ("train", "val"):
            rtol, atol = LOSS_TOL[part]
            for k, want in ref["epochs"][e][f"{part}_losses"].items():
                got = run["epochs"][e][f"{part}_losses"][k]
                out[f"epoch {e + 1} {part} {k}"] = abs(got - want) / (atol + rtol * abs(want))
    last, mine = ref["epochs"][epochs - 1], run["epochs"][epochs - 1]
    for k in ("counter", "rng"):
        if mine[k] != last[k]:
            fails.append(f"{k} {mine[k]} against {last[k]}")
    es, want_es = mine["early_stopping"], last["early_stopping"]
    if es["epochs_no_improve"] != want_es["epochs_no_improve"]:
        fails.append(f"early-stopping count {es['epochs_no_improve']} against "
                     f"{want_es['epochs_no_improve']}")
    rtol, atol = LOSS_TOL["val"]
    out["early-stopping best loss"] = (abs(es["best_loss"] - want_es["best_loss"])
                                       / (atol + rtol * abs(want_es["best_loss"])))
    if set(mine["leaves"]) != set(last["leaves"]):
        fails.append(f"leaves {sorted(set(mine['leaves']) ^ set(last['leaves']))[:6]}")
        return fails, out
    steps = epochs * math.ceil(ref["rows"]["train"] / golden["recipe"]["batch"])
    atol = 3 * ref["learning_rate"] * steps
    tol = 5e-2 if ref["lambda_l1"] == 0.0 else 1e-3
    for k, want in last["leaves"].items():
        ratio = leaf_ratio(k, mine["leaves"][k], want, atol, tol)
        if ratio is not None:
            out[k] = ratio
    return fails, out


def training_gaps(run: dict, golden: dict, epochs: int,
                  reorders: list | None = None) -> dict:
    """``run`` against the reference's first ``epochs`` epochs. The exact
    checks must hold, and each quantity of ``run_ratios`` within its
    limit: its stated tolerance, or SPREAD_FACTOR times the farthest that
    the reference's reordered runs (``reorders``, by default the golden
    file's ``training.reorders``) move it, whichever is wider (the
    reference's own distance from itself under rounding alone). Returns
    the failures, each quantity's share of its stated tolerance, the
    reorders' largest share and the limit."""
    reorders = golden["training"]["reorders"] if reorders is None else reorders
    fails, mine = run_ratios(run, golden, epochs)
    spread = {}
    for other in reorders:
        for q, ratio in run_ratios(other, golden, epochs)[1].items():
            spread[q] = max(spread.get(q, 0.0), ratio)
    limit = {q: max(1.0, SPREAD_FACTOR * spread[q]) for q in mine}
    fails += [f"{q} at {mine[q]:.3g} of its stated tolerance, limit "
              f"{limit[q]:.3g} (reordered reference {spread[q]:.3g})"
              for q in mine if mine[q] > limit[q]]
    return {"fails": fails, "ratios": mine, "spread": spread, "limit": limit}


def hold_training(trainer, init: dict, golden: dict, epochs: int) -> dict:
    """The port's run of ``epochs`` epochs and its first gradient against
    the reference's (``training_gaps``); prints, per class of quantity,
    the worst share of its limit, and the losses held at the spread beside
    the reference's and its reorders'."""
    run = training_record(trainer, init, epochs)
    gaps = training_gaps(run, golden, epochs)
    if gaps["fails"]:
        raise AssertionError(f"training against the JAX package's: {gaps['fails']}")
    ratios, limit, spread = gaps["ratios"], gaps["limit"], gaps["spread"]
    n_orders = len(golden["training"]["reorders"])

    def kind(q):
        return ("moments" if q.startswith("opt_state/") else "leaves" if "/" in q
                else "losses")

    worst = {}
    for q in ratios:
        cls = (kind(q), "stated" if limit[q] == 1.0 else "spread")
        if cls not in worst or ratios[q] / limit[q] > worst[cls][1]:
            worst[cls] = (q, ratios[q] / limit[q])
    log(f"training: {epochs} epoch(s) against the JAX package's: counter, rng "
        f"and early-stopping count equal; {len(ratios)} quantities, "
        f"{sum(v == 1.0 for v in limit.values())} at their stated tolerance "
        f"and {sum(v != 1.0 for v in limit.values())} at {SPREAD_FACTOR:g} x "
        f"the farthest of the {n_orders} reordered reference runs, which "
        f"is wider; worst share of the limit: " + "; ".join(
            f"{c} at {how} {q} {r:.3g}" for (c, how), (q, r) in sorted(worst.items())))
    ref, orders = golden["training"], golden["training"]["reorders"]

    def loss(run, q):
        if q == "early-stopping best loss":
            return run["epochs"][epochs - 1]["early_stopping"]["best_loss"]
        _, e, part, k = q.split(" ", 3)
        return run["epochs"][int(e) - 1][f"{part}_losses"][k]

    loose = [q for q in ratios if kind(q) == "losses" and limit[q] != 1.0]
    log("training losses held at the spread: here / JAX / reordered JAX: " + "; ".join(
        f"{q} {loss(run, q):.6g} / {loss(ref, q):.6g} / "
        f"{min(loss(o, q) for o in orders):.6g}-{max(loss(o, q) for o in orders):.6g}"
        for q in loose))
    return {"epochs": epochs, "worst": {f"{c} ({how})": {"quantity": q, "share": r}
                                        for (c, how), (q, r) in worst.items()},
            "held_at_spread": {q: {"share_of_stated": ratios[q], "limit": limit[q],
                                   "reordered": spread[q]}
                               for q in ratios if limit[q] != 1.0},
            "train_total": trainer.train_losses["total"],
            "reference_train_total": [x["train_losses"]["total"]
                                      for x in ref["epochs"][:epochs]]}


def reference_pipeline(inputs: dict, golden: dict, root: Path, mode: str,
                       dtype: str, device: str = DEVICE,
                       num_samples: int | None = None) -> tuple[list, float]:
    """``--mode pipeline`` through the CLI on the reference's inputs (its
    first ``num_samples`` genomes, all by default); returns its records'
    digests (the FASTA is removed) and its wall time, digests included."""
    from genome_minimizer_2_torch import cli

    r = golden["recipe"]
    n = num_samples or r["num_samples"]
    out = str(root / f"reference_{mode}_{dtype}.fasta")
    t0 = time.perf_counter()
    with logged_stdout(root / f"reference_{mode}_{dtype}.log"):
        stats = cli.run_pipeline(cli.parse_arguments([
            "--mode", "pipeline", "--device", device,
            "--model-path", inputs["models"][dtype], "--genome-path",
            inputs["genbank"], "--output-file", out, "--num-samples",
            str(n), "--chunk-size", str(r["chunk"]), "--seed",
            str(r["seed"]), "--sampling-mode", mode, "--noise-level",
            str(r["noise_level"]), "--model-name", "v0_reference"]))
    if stats is None or stats.genomes != n:
        raise AssertionError(f"reference {mode} {dtype}: the pipeline did not run")
    digests = fasta_digests(out, golden)
    os.remove(out)
    return digests, time.perf_counter() - t0


def reference_sample(inputs: dict, golden: dict, root: Path, device: str = DEVICE):
    """``--mode sample --save-dtype packed`` through the CLI (default mode):
    its packed rows."""
    import numpy as np

    from genome_minimizer_2_torch import cli

    r = golden["recipe"]
    with logged_stdout(root / "reference_sample.log"):
        out = cli.run_sampling(cli.parse_arguments([
            "--mode", "sample", "--device", device, "--model-path",
            inputs["models"]["float32"], "--num-samples", str(r["num_samples"]),
            "--save-dtype", "packed", "--no-csv", "--no-generate-plots",
            "--seed", str(r["seed"])]))
    if out is None:
        raise AssertionError("reference sample: the mode did not run")
    with np.load(out["samples_path"]) as z:
        return z["packed"]


def run_reference(card: str, smi: str, device: str = DEVICE) -> dict:
    """Phase 8: the port at float32 with TF32 off, through its entry points,
    against the JAX package's answers (module docstring)."""
    import torch

    from genome_minimizer_2_torch.core import prng
    from genome_minimizer_2_torch.eval import metrics as ME
    from genome_minimizer_2_torch.ops import kernels as KR

    t0 = time.perf_counter()
    golden = load_golden()
    r = golden["recipe"]
    with gm2_root("gm2_reference_") as root:
        inputs = reference_inputs(root, golden, device)
        walls = {"inputs": time.perf_counter() - t0}
        log(f"reference inputs rebuilt and equal to the reference's digests in "
            f"{walls['inputs']:.1f}s")
        f32 = inputs["models"]["float32"]
        KR.reset_launch_counts()
        got = {}
        for mode in ("default", "focused"):
            got[mode], walls[mode] = reference_pipeline(inputs, golden, root,
                                                        mode, "float32", device)
        t1 = time.perf_counter()
        packed = reference_sample(inputs, golden, root, device)
        walls["sample"] = time.perf_counter() - t1
        trainer, (train_x, val_x, test_x) = reference_trainer(
            golden, inputs["matrix"], device, r["epochs"])
        if not trainer._use_block_shuffle(len(train_x)):
            raise AssertionError("reference training off the block shuffle")
        state = trainer.init_state()
        init = {k: v.detach().clone() for k, v in model_leaves(state.model).items()}
        if leaves_digest(init) != golden["sha256"]["train_init"]:
            raise AssertionError("inputs differ from the reference's: the "
                                 "trainer's initial state")
        t1 = time.perf_counter()
        first = first_gradient(trainer, state, train_x, golden, device)
        walls["gradient"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        trainer.train(train_x, val_x, state=state)
        f1, acc, _, _ = ME.calculate_reconstruction_metrics(
            trainer.final_state.model, test_x, prng.key(r["seed"] + 1, device),
            batch_size=r["batch"])
        if device != "cpu":
            torch.cuda.synchronize()
        walls["training"] = time.perf_counter() - t1
        launches = KR.launch_counts()
        replayed = {fn.__name__: fn.replayed for fn in KR.KERNELS}
        t1 = time.perf_counter()
        # each kernel's route follows its operands' dtype; the sampler is
        # the one the CLI loads from the checkpoint
        lookup = plain_lookup(f32, inputs["genbank"], device)
        sampler_dtype = lookup[0].cfg.policy.compute_dtype
        state = trainer.final_state
        routes = {
            "decode_threshold_pack": str(sampler_dtype),
            "gather_row_blocks": str(trainer.prepare_data(train_x[:8]).dtype),
            "output_layer_bwd": str(trainer.model_cfg.policy.compute_dtype),
            "clip_adam_apply_leaves": str({v.dtype for v in state.opt.mu.values()}
                                          | {v.dtype for v in state.opt.nu.values()})}
        steps = r["epochs"] * math.ceil(len(train_x) / r["batch"])
        want = {"decode_threshold_pack":
                    2 * math.ceil(r["num_samples"] / r["chunk"])
                    + math.ceil(r["n_probes"] / SAMPLER_CHUNK)
                    + math.ceil(r["num_samples"] / SAMPLER_CHUNK)
                    + math.ceil(len(test_x) / r["batch"]),
                "gather_row_blocks": r["epochs"],
                "output_layer_bwd": steps + 3,  # and first_gradient's
                "clip_adam_apply_leaves": steps * adam_launches(),
                "weight_grad_bf16": 0}  # float32
        log(f"reference path: launches {launches} (of them from CUDA graph "
            f"replays {replayed}), expected {want}; operand dtypes {routes}")
        check_launches("reference", launches, want)
        if any("float32" not in v or "bfloat16" in v for v in routes.values()):
            raise AssertionError(f"reference path off its float32 routes: {routes}")

        held = {m: hold_pipeline(f"reference {m} records (float32)", got[m],
                                 golden, m, lookup)
                for m in got}
        held["sample"] = hold_sample(packed, golden, lookup)
        del lookup
        held["gradient"] = hold_first_gradient(first, golden)
        held["training"] = hold_training(trainer, init, golden, r["epochs"])
        ref_test = golden["training"]["test"]
        if abs(f1 - ref_test["f1"]) > F1_TOL or abs(acc - ref_test["accuracy"]) > F1_TOL:
            raise AssertionError(f"test set F1 {f1!r}, accuracy {acc!r} against "
                                 f"the reference's {ref_test} (within {F1_TOL})")
        held["test"] = {"f1": f1, "accuracy": acc, "reference": ref_test}
        walls["checks"] = time.perf_counter() - t1
        log(f"reference test set: F1 {f1:.6f} (JAX {ref_test['f1']:.6f}), "
            f"accuracy {acc:.6f} (JAX {ref_test['accuracy']:.6f})")
        del trainer, state, init

        # bf16 is printed, not held: JAX's bf16 on the CPU is not what its
        # TPU computes, so it is no reference; one chunk of the default
        # pipeline shows it runs
        digests, walls["default bf16"] = reference_pipeline(
            inputs, golden, root, "default", "bfloat16", device,
            num_samples=r["chunk"])
        bf16 = sum(a != b for a, b in zip(digests,
                                          golden["pipeline"]["default"]["digests"]))
        log(f"reference bf16 (not held): {bf16} of the default pipeline's "
            f"first {r['chunk']} records differ from the JAX package's "
            f"float32 ones")
    wall = time.perf_counter() - t0
    log(f"{smi}: phase 8 {wall:.1f}s (" + ", ".join(
        f"{k} {v:.1f}s" for k, v in walls.items()) + ")")
    return {"wall_s": wall, "walls": walls, "launches": launches,
            "replayed": replayed, "routes": routes, "held": held,
            "bf16_records_differing": bf16, "inputs_sha256": inputs["sha256"]}


# ---------------------------------------------------------------------------
# --step-phases: the eager step's device time by range, beside a replay
# ---------------------------------------------------------------------------

PHASE_CELLS = ("v0-train-b32", "v2-train-b32")
PHASE_STEPS = 8
PHASE_GAP = 0.15  # the phases' device sum against a replayed step's


def _per_call_s(fn, n: int) -> float:
    t = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t) / n


def range_costs() -> dict:
    """Host seconds of one ``span`` range (enter and exit) with the profiler
    off and on, and of a bare ``record_function`` with it off."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from genome_minimizer_2_torch.utils.profiling import span

    def ranged():
        with span("gm2/step/forward"):
            pass

    def bare():
        with record_function("gm2/step/forward"):
            pass

    out = {"off_s": _per_call_s(ranged, 200_000),
           "record_function_off_s": _per_call_s(bare, 50_000)}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out["on_s"] = _per_call_s(ranged, 20_000)
        torch.cuda.synchronize()
    return out


def _ranges_in(fn, prefix: str) -> int:
    from torch.profiler import ProfilerActivity, profile

    from genome_minimizer_2_torch.utils.profiling import profiler_events

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(1 for e in profiler_events(prof) if e.get("cat") == "user_annotation"
               and e["name"].startswith(prefix))


def step_phases_card(seed: int = 20261018) -> dict:
    """``--step-phases``: for each training cell of the benchmark, at its
    inputs (``portbench/drivers/train.py::setup``, the warm epoch and the
    capture included), the eager step's device time by ``gm2/step/*``
    range (``utils/profiling.py::step_phases``) beside one replayed
    epoch's device time by range, divided by its steps; then the host cost
    of the ranges a step and a sampler chunk, with the profiler off and
    on."""
    import gc

    import torch
    from torch.profiler import ProfilerActivity, profile

    from genome_minimizer_2_torch.utils import profiling as P
    from portbench import harness

    costs = range_costs()
    log(f"a range: {1e6 * costs['off_s']:.3f} us with the profiler off "
        f"({1e6 * costs['record_function_off_s']:.3f} us a bare record_function), "
        f"{1e6 * costs['on_s']:.3f} us with it on")
    dev = torch.device("cuda", 0)
    out = {"range_costs": costs, "cells": {}}
    driver = harness.load_module(harness.HERE / "drivers" / "train.py")
    for name in PHASE_CELLS:
        cell = harness.Cell(name)
        s = driver.setup(cell, seed, dev, {})
        # the benchmark's taps wrap the trainer's step; time the program's own
        s.pop("taps").close()
        trainer, state, x = s["trainer"], s["state"], s["train_x"]
        batch = x[: trainer.config.batch_size]
        table = P.step_phases(trainer, state, batch, steps=PHASE_STEPS)
        log(f"{name}: the eager step's device ms by range, a step of "
            f"{PHASE_STEPS}:\n" + P.format_table(table, top=4))
        stray = [k for k in table if not k.startswith("gm2/step/")]
        if stray:
            raise AssertionError(f"{name}: device time outside gm2/step/*: {stray}")
        phases_s = sum(r["forward_s"] + r["backward_s"] for r in table.values())

        n = x.shape[0]
        steps = -(-n // trainer.config.batch_size)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trainer.graphed_epoch(state, x, n, train=True)
            torch.cuda.synchronize()
        events = P.profiler_events(prof)
        replay = P.device_by_range(events)
        log(f"{name}: one replayed training epoch's device ms by range:\n"
            + P.format_table(replay, top=4))
        step_s = replay.get("gm2/train_step", {"forward_s": 0.0})["forward_s"] / steps
        gap = abs(phases_s - step_s) / step_s if step_s else float("inf")
        log(f"{name}: phases {1e3 * phases_s:.4f} ms a step, replayed step "
            f"{1e3 * step_s:.4f} ms ({steps} steps an epoch), gap {100 * gap:.2f} %")

        clone = state.clone()
        step = lambda: trainer.train_step(clone, batch)  # noqa: E731
        step()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(20):
            step()
        torch.cuda.synchronize()
        eager_s = (time.perf_counter() - t) / 20
        ranges = _ranges_in(step, "gm2/step/")
        out["cells"][name] = {
            "phases": table, "phases_s": phases_s, "replayed_step_s": step_s,
            "replayed_epoch": replay, "steps": steps, "gap": gap,
            "eager_step_s": eager_s, "ranges_a_step": ranges,
            "ranges_off_share": ranges * costs["off_s"] / eager_s,
            "ranges_on_share": ranges * costs["on_s"] / eager_s}
        log(f"{name}: eager step {1e3 * eager_s:.3f} ms host, {ranges} ranges: "
            f"{100 * ranges * costs['off_s'] / eager_s:.4f} % off, "
            f"{100 * ranges * costs['on_s'] / eager_s:.4f} % on")
        del clone, s, state, x, batch
        trainer.drop_epoch_programs()
        gc.collect()
        torch.cuda.empty_cache()
        if gap > PHASE_GAP:
            raise AssertionError(f"{name}: the phases' sum is {100 * gap:.1f} % "
                                 f"from a replayed step")

    sdriver = harness.load_module(harness.HERE / "drivers" / "sample.py")
    cell = harness.Cell("v0-sample-packed")
    s = sdriver.setup(cell, seed, dev, {})
    smp, counter, SMP = s["sampler"], s["counter"], s["smp"]
    genomes = cell.traffic["genomes_per_call"]
    chunks = genomes // cell.traffic["chunk_size"]
    key = torch.tensor([0, seed], dtype=torch.int64, device=dev)

    def call():
        smp.sample_packed(key, genomes, on_chunk=lambda lo, hi, arr: (
            SMP.popcount_rows(arr), counter(arr)))

    chunk_s = _per_call_s(call, 3) / chunks
    ranges = _ranges_in(call, "gm2/sample/") / chunks
    out["sample"] = {"chunk_s": chunk_s, "ranges_a_chunk": ranges,
                     "ranges_off_share": ranges * costs["off_s"] / chunk_s,
                     "ranges_on_share": ranges * costs["on_s"] / chunk_s}
    log(f"v0-sample-packed: a chunk {1e3 * chunk_s:.3f} ms host, {ranges:.4f} "
        f"ranges: {100 * ranges * costs['off_s'] / chunk_s:.5f} % off, "
        f"{100 * ranges * costs['on_s'] / chunk_s:.5f} % on")
    return out


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="also profile one pipeline run and one training "
                             "epoch; traces into DIR")
    parser.add_argument("--bf16-times", action="store_true",
                        help="only build and time the bf16 decode and backward "
                             "(phase 3's timings of them); prints their JSON")
    parser.add_argument("--reference", action="store_true",
                        help="only build and run phase 8, the port against "
                             "the JAX package's answers")
    parser.add_argument("--step-phases", action="store_true",
                        help="only build and measure the eager train step's "
                             "device time by range beside a replayed step, "
                             "and the ranges' host cost; prints their JSON")
    parser.add_argument("--package-root", metavar="DIR", default=str(REPO),
                        help="import the port from DIR (a checkout of another "
                             "commit, to time two in turns); default: beside "
                             "this script")
    parser.add_argument("--dp-worker", nargs=5, help=argparse.SUPPRESS,
                        metavar=("RANK", "WORLD", "PORT", "MODEL", "GENBANK"))
    parser.add_argument("--tp-worker", nargs=3, type=int, help=argparse.SUPPRESS,
                        metavar=("RANK", "WORLD", "PORT"))
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
    root = Path(opts.package_root).resolve()
    if not (root / "genome_minimizer_2_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not in {root}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))

    # the runner logs each stage; timestamps show where the path's time goes
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="%(asctime)s %(name)s: %(message)s")
    if opts.dp_worker:  # one rank of phase 6's data-parallel check
        rank, world, port, model, genbank = opts.dp_worker
        return dp_worker(int(rank), int(world), int(port), model, genbank)
    if opts.tp_worker:  # one rank of phase 7's tensor-parallel check
        return tp_worker(*opts.tp_worker)
    smi = nvidia_smi_line()
    card = torch.cuda.get_device_name(0)
    log(f"device: {card} ({smi}), torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    # IEEE float32 products for the float32 checks; set once, here
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build = build_all()
    if opts.bf16_times:
        log(json.dumps({"bf16_times": bf16_times(), "package_root": str(root),
                        "device": smi}))
        return 0
    if opts.reference:
        log(json.dumps({"reference": run_reference(card, smi), "device": smi}))
        return 0
    if opts.step_phases:
        log(json.dumps({"step_phases": step_phases_card(), "device": smi}))
        return 0
    kernel = check_kernel()
    gather = check_gather()
    bwd = check_output_layer_bwd()
    wgrad = check_weight_grad()
    adam = check_clip_adam()
    adam["sass"] = clip_adam_sass(adam["values"])
    tp_slices = check_tp_slices()

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
        t_graphs = time.perf_counter()
        graphs = run_graph_check(data, root, card)
        graphs_s = time.perf_counter() - t_graphs
        traced = run_trace(data, root, card)
        nccl = run_nccl_bringup(results, train_checks["expected_launches"],
                                root, card)
        dp = run_data_parallel(results, staged, data, root, card)
        del data
        phase6_s = time.perf_counter() - t6
        log(f"{smi}: phase 6 {phase6_s:.1f}s (elastic "
            + ", ".join(f"{k} {v['wall_s']:.1f}s" for k, v in elastic.items())
            + f"; graphs {graphs_s:.1f}s; trace {traced['wall_s']:.1f}s; NCCL bring-up "
            f"{nccl['wall_s']:.1f}s; data parallel {dp['wall_s']:.1f}s + W = 1 "
            f"references {dp['reference_wall_s']:.1f}s)")
        t7 = time.perf_counter()
        tp = run_tensor_parallel(root, card)
        phase7_s = time.perf_counter() - t7
        log(f"{smi}: phase 7 {phase7_s:.1f}s")
    reference = run_reference(card, smi)

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
           for o in dp["ranks"] for m in ("float32", "bfloat16", "sample")},
        **{f"tensor parallel 1x2 --mode experiment rank {r}": c
           for r, c in enumerate(tp["cli_launches"])}}
    by_path = lambda name: {p: c[name] for p, c in slice_paths.items()}  # noqa: E731
    # the float32 route of the decode and the backward: phase 6's float32
    # training on each rank (phase 7's float32 steps are not counted)
    f32_paths = {f"data parallel rank {o['rank']} float32": o["float32"]["launches"]
                 for o in dp["ranks"]}

    def f32_route(name, source, replaces, res, **extra):
        by = {p: c[name] for p, c in f32_paths.items()}
        return record(name, source, replaces, sum(by.values()), res,
                      dtype="float32", core="genome_minimizer_2_torch/csrc/"
                      "sgemm_sm90.cuh", launches_by_path=by, **extra)

    records = [
        record("decode_threshold_pack", "decode_threshold_pack.cu",
               "genome_minimizer_2_tpu/ops/pallas_kernels.py:110",
               sum(decode_by_path.values()), kernel,
               shape=[CHUNK, 1024, 55_040], dtype="bfloat16",
               bits_differing=kernel["bits_differing"],
               **{k: kernel[k] for k in ("ms_range", "library_ms_range", "cluster",
                                         "clusters")},
               float32=f32_route("decode_threshold_pack", "decode_threshold_pack.cu",
                                 "genome_minimizer_2_tpu/ops/pallas_kernels.py:110",
                                 kernel["float32"], shape=[CHUNK, 1024, 55_040],
                                 bits_differing=kernel["float32"]["bits_differing"]),
               launches_by_path={**decode_by_path,
                                 **by_path("decode_threshold_pack")},
               tp_slice=tp_slices["decode_threshold_pack"]),
        record("gather_row_blocks", "gather_row_blocks.cu",
               "genome_minimizer_2_tpu/ops/pallas_kernels.py:190",
               train_launches["gather_row_blocks"], gather,
               shape=[4_608, 55_040], block=8, dtype="bfloat16",
               launches_from_replays=results["replayed"]["gather_row_blocks"],
               launches_by_path=by_path("gather_row_blocks"),
               **{k: gather[k] for k in ("ms_range", "library_ms_range",
                                         "bound_share", "float32", "block_1")}),
        record("output_layer_bwd", "output_layer_bwd.cu",
               "tools/bol_probe.py:22 (make_bwd) and :156 (make_bwd_fullk)",
               train_launches["output_layer_bwd"], bwd,
               shape=[TRAIN_BATCH, V0_HIDDEN, 55_040], dtype="bfloat16",
               launches_from_replays=results["replayed"]["output_layer_bwd"],
               launches_by_path=by_path("output_layer_bwd"),
               max_rel_err=bwd["max_rel_err"], dh_splits=bwd["dh_splits"],
               elements_1ulp=bwd["elements_1ulp"],
               **{k: bwd[k] for k in ("ms_range", "library_ms_range", "parts_ms",
                                      "parts_bound_ms", "dl_library_ms",
                                      "library_with_dl_ms")},
               float32=f32_route("output_layer_bwd", "output_layer_bwd.cu",
                                 "tools/bol_probe.py:22 (make_bwd) and :156 "
                                 "(make_bwd_fullk)", bwd["float32"],
                                 shape=[TRAIN_BATCH, V0_HIDDEN, 55_040],
                                 max_rel_err=bwd["float32"]["max_rel_err"],
                                 dh_splits=bwd["float32"]["dh_splits"]),
               tp_slice=tp_slices["output_layer_bwd"]),
        record("weight_grad_bf16", "weight_grad_bf16.cu",
               "none: XLA's transpose of the bf16 product "
               "(genome_minimizer_2_tpu/models/vae.py::_matmul)",
               train_launches["weight_grad_bf16"], wgrad["v0 encoder/0"],
               shape=WGRAD_TIMED["v0 encoder/0"], dtype="bfloat16",
               launches_from_replays=results["replayed"]["weight_grad_bf16"],
               launches_by_path=by_path("weight_grad_bf16"),
               **{k: wgrad["v0 encoder/0"][k] for k in ("ms_range", "library_ms_range")},
               v2=wgrad["v2 encoder/0"]),
        record("clip_adam_apply_leaves", "clip_adam.cu",
               "tools/opt_microbench3.py:61 (adam_pallas_loop)",
               train_launches["clip_adam_apply_leaves"],
               {**adam["bfloat16"], "max_abs_err": adam["max_abs_err"]},
               values=adam["values"], leaves=adam["leaves"],
               moments="bfloat16", max_ulp=adam["max_ulp"],
               launches_from_replays=results["replayed"]["clip_adam_apply_leaves"],
               launches_by_path=by_path("clip_adam_apply_leaves"),
               float32_moments=adam["float32"],
               ms_scope="one no-clip optimizer step: every leaf, one launch",
               launches_a_step=adam_launches(),
               sass_per_value=adam["sass"],
               library_refusal=adam["bfloat16"]["library_refusal"],
               **{k: adam["bfloat16"][k] for k in ("ms_range", "bound_share")},
               tp_slice=tp_slices["clip_adam_apply_leaves"]),
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
                    "elastic": elastic, "graphs": graphs, "trace": traced,
                    "nccl": nccl,
                    "data_parallel": dp, "phase6_s": phase6_s,
                    "tensor_parallel": tp, "phase7_s": phase7_s,
                    "reference": reference,
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

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
     blocks, bf16 and float32, bit-equal;
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
   record whose FASTA-relevant bits include a logit within 1e-3 of 0.
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
   checkpoint loads through load_sampler and decodes a chunk.
6. Prints the per-kernel JSON line, the nvidia-smi line, and last
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


def check_gather() -> dict:
    """The epoch shuffle at the training path's shape, bf16 and float32."""
    import torch

    from genome_minimizer_2_torch.core import prng
    from genome_minimizer_2_torch.ops import kernels as KR

    n, d, blk = 4_608, 55_040, KR.GATHER_BLOCK
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    bperm = prng.permutation(prng.key(3, DEVICE), n // blk)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.rand(n, d, generator=gen, device=DEVICE) < 0.5).to(dtype)
        x[:, -1] = torch.arange(n, device=DEVICE).to(dtype)  # row identity
        out = KR.gather_row_blocks(x, bperm)
        torch.cuda.synchronize()
        ref = KR.gather_row_blocks_reference(x, bperm)
        same = torch.equal(out, ref)
        err = float((out.float() - ref.float()).abs().max())
        name = str(dtype).replace("torch.", "")
        log(f"gather_row_blocks {name} ({n}, {d}) block {blk}: "
            f"{'bit-equal' if same else 'DIFFERS'}, max |err| {err}")
        if not same:
            raise AssertionError(f"gather_row_blocks {name} differs")
        del out, ref
        rows = (bperm[:, None] * blk + torch.arange(blk, device=DEVICE)).reshape(-1)
        nbytes = 2 * x.numel() * x.element_size() + bperm.numel() * 8
        b_ms, b_by = bound(0.0, nbytes, PEAK_BF16_FLOPS)
        r = {"max_abs_err": err,
             "ms": time_ms(lambda: KR.gather_row_blocks(x, bperm)),
             "plain_ms": time_ms(lambda: KR.gather_row_blocks_reference(x, bperm)),
             "library_ms": time_ms(lambda: x.index_select(0, rows)),
             "bound_ms": b_ms, "bound_by": b_by}
        log(f"  time {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
            f"ms, index_select {r['library_ms']:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}; {nbytes / 1e6:.1f} MB)")
        res[name] = r
    return res


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
    f32.update({"ms": time_ms(lambda: KR.output_layer_bwd(logits, y, mask, h, w, g),
                              iters=3, warmup=1),
                "plain_ms": time_ms(lambda: KR.output_layer_bwd_reference(
                    logits, y, mask, h, w, g), iters=3, warmup=1),
                "bound_ms": b_ms, "bound_by": b_by})
    log(f"  time float32: kernel {f32['ms']:.4f} ms, plain {f32['plain_ms']:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
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

    # GenBank: 4,641,652 bp, ~4,000 gene features of 300-1,500 bp whose names
    # come from the vocabulary, so sampled masks decide what is kept
    seq = np.frombuffer(b"acgt", np.uint8)[rng.randint(0, 4, GENOME_LENGTH)]
    seq = seq.tobytes().decode()
    starts = np.sort(rng.choice(GENOME_LENGTH - 2000, N_FEATURES, replace=False))
    lengths = rng.randint(300, 1500, N_FEATURES)
    names = genes[rng.choice(V0_INPUT_DIM, N_FEATURES, replace=False)]
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
    gb = data / "wild_type_sequence.gb"
    gb.write_text("\n".join(lines) + "\n")

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

def iter_records(path: str, skip_header: bool):
    """Yield (header_line, seq_line) byte pairs of a FASTA written by the
    pipeline (after its three '#' lines when ``skip_header``)."""
    with open(path, "rb") as f:
        if skip_header:
            for _ in range(3):
                line = f.readline()
                if not line.startswith(b"# "):
                    raise AssertionError(f"bad header line {line[:80]!r}")
        while True:
            head = f.readline()
            if not head:
                return
            yield head, f.readline()


def check_first_chunk(inputs: dict, out: str, mode: str, seed: int) -> dict:
    """Recompute chunk 0 with the plain decode on the card and the numpy
    minimize, and compare its records with the pipeline's FASTA."""
    import numpy as np
    import torch

    from genome_minimizer_2_torch.core import prng
    from genome_minimizer_2_torch.data.dataset import load_gene_vocab
    from genome_minimizer_2_torch.genome.converter import (
        dedupe_columns, load_essential_set)
    from genome_minimizer_2_torch.genome.minimizer import MinimizerEngine
    from genome_minimizer_2_torch.ops import kernels as KR
    from genome_minimizer_2_torch.sample.sampler import load_sampler
    from genome_minimizer_2_torch.utils import directories

    cols = load_gene_vocab()
    essential = load_essential_set(directories.paper_essential_genes())
    sampler, _ = load_sampler(inputs["model"], input_dim=len(cols), device=DEVICE)
    engine = MinimizerEngine.from_genbank(inputs["genbank"])
    cols_arr, keep = dedupe_columns(np.asarray(cols))
    col_idx, ess = engine.feature_lookup_packed(cols_arr, keep, essential)

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
    h = sampler.model.decode_hidden(z)
    cd = sampler.cfg.policy.compute_dtype
    out_w, out_b = sampler.model.output.w, sampler.model.output.b
    logits = KR.decode_logits_reference(h, out_w, out_b, cd)
    packed = KR.decode_threshold_pack_reference(h, out_w, out_b, cd)
    D = sampler.cfg.input_dim
    packed = packed[:, : (D + 7) // 8].cpu().numpy()
    # bits that decide a record: columns of non-essential named features
    relevant = np.unique(col_idx[(col_idx >= 0) & ~ess])
    near = (logits[:, torch.as_tensor(relevant, device=DEVICE)].abs()
            < NEAR_ZERO).any(dim=1).cpu().numpy()

    expected = out + ".plain_chunk0"
    engine.minimize_packed_to_fasta(packed, col_idx, ess, expected,
                                    use_native=False)
    same = excused = 0
    got = iter_records(out, skip_header=True)
    for i, (want_h, want_s) in enumerate(iter_records(expected, False)):
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
    log(f"{mode}: chunk 0 vs plain recompute: {same} of {CHUNK} records "
        f"byte-equal, {excused} differ and hold a relevant bit with |logit| < "
        f"{NEAR_ZERO} (not held to equality); {int(near.sum())} of {CHUNK} "
        f"records hold such a bit")
    return {"equal": same, "near_zero_mismatch": excused,
            "near_zero_records": int(near.sum())}


def check_fasta(out: str, n: int) -> int:
    count, total = 0, 0
    for i, (head, seq) in enumerate(iter_records(out, skip_header=True)):
        want = f">Minimized_E_coli_K12_MG1655_{i + 1}\n".encode()
        if head != want or not seq.endswith(b"\n"):
            raise AssertionError(f"record {i}: header {head[:60]!r}")
        count += 1
        total += len(seq) - 1
    if count != n:
        raise AssertionError(f"{count} records, expected {n}")
    return total // max(count, 1)


def run_main_path(inputs: dict, root: Path, card: str) -> dict:
    from genome_minimizer_2_torch import cli
    from genome_minimizer_2_torch.ops import kernels as KR

    out = str(root / "smoke.fasta")
    runs = {}
    seed = 0
    for mode in ("default", "focused"):
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
    return runs


# ---------------------------------------------------------------------------
# phase 5: the training path
# ---------------------------------------------------------------------------

def write_training_inputs(root: Path, seed: int = 0) -> None:
    from genome_minimizer_2_torch.data import synthetic

    data = root / "data"
    data.mkdir(parents=True)
    genes, samples = synthetic.write_presence_absence_fast(
        data / "F4_complete_presence_absence.csv", TRAIN_GENOMES, V0_INPUT_DIM,
        seed)
    synthetic.write_phylogroups_csv(data / "accessionID_phylogroup_BD.csv",
                                    samples, seed)
    synthetic.write_essential_genes_csv(data / "essential_genes.csv", genes,
                                        N_ESSENTIAL, seed)


def training_args(extra=()):
    from genome_minimizer_2_torch import cli

    return cli.parse_arguments([
        "--mode", "experiment", "--device", DEVICE, "--trainer-version", "v0",
        "--hidden-dim", str(V0_HIDDEN), "--latent-dim", str(V0_LATENT),
        "--batch-size", str(TRAIN_BATCH), "--n-epochs", str(TRAIN_EPOCHS),
        "--experiment-name", "v0_smoke", "--no-generate-plots", *extra])


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
    import numpy as np
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


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="also profile one pipeline run and one training "
                             "epoch; traces into DIR")
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
        write_training_inputs(root)
        log(f"training inputs written in {time.perf_counter() - t0:.1f}s")
        results, train_launches = run_training_path(card)
        train_checks, loaded = check_training(results, train_launches, root)
        if opts.profile:
            profiled_train = profile_training(*loaded, opts.profile)

    def record(name, source, replaces, launches, res, **extra):
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
        return {"name": name, "route": "cuda",
                "source": f"genome_minimizer_2_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                **{k: res[k] for k in keys}, **extra}

    pipe_launches = sum(r["launches"] for r in runs.values())
    records = [
        record("decode_threshold_pack", "decode_threshold_pack.cu",
               "genome_minimizer_2_tpu/ops/pallas_kernels.py:110",
               pipe_launches + train_launches["decode_threshold_pack"], kernel,
               shape=[CHUNK, 1024, 55_040], dtype="bfloat16",
               bits_differing=kernel["bits_differing"], float32=kernel["float32"],
               launches_by_path={**{f"pipeline {m}": r["launches"]
                                    for m, r in runs.items()},
                                 "training": train_launches["decode_threshold_pack"]}),
        record("gather_row_blocks", "gather_row_blocks.cu",
               "genome_minimizer_2_tpu/ops/pallas_kernels.py:190",
               train_launches["gather_row_blocks"], gather["bfloat16"],
               shape=[4_608, 55_040], block=8, dtype="bfloat16",
               float32=gather["float32"]),
        record("output_layer_bwd", "output_layer_bwd.cu",
               "tools/bol_probe.py:22 (make_bwd) and :156 (make_bwd_fullk)",
               train_launches["output_layer_bwd"], bwd,
               shape=[TRAIN_BATCH, V0_HIDDEN, 55_040], dtype="bfloat16",
               max_rel_err=bwd["max_rel_err"], dh_splits=bwd["dh_splits"],
               elements_1ulp=bwd["elements_1ulp"], float32=bwd["float32"]),
        record("clip_adam_apply", "clip_adam.cu",
               "tools/opt_microbench3.py:61 (adam_pallas_loop)",
               train_launches["clip_adam_apply"],
               {**adam["bfloat16"], "max_abs_err": adam["max_abs_err"]},
               values=adam["values"], leaves=adam["leaves"],
               moments="bfloat16", max_ulp=adam["max_ulp"],
               float32_moments=adam["float32"],
               ms_scope="one optimizer step: every leaf, one launch each"),
    ]
    train_summary = {k: results[k] for k in (
        "train_loss_vals", "val_loss_vals", "epoch_seconds", "examples_per_s",
        "n_train", "f1_overall", "accuracy_overall", "wall_s")}
    log(json.dumps({"pipeline": runs, "training": train_summary,
                    "training_checks": train_checks, "build_s": build,
                    "profile": profiled,
                    "profile_training": profiled_train if opts.profile else None,
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

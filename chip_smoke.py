#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (genome_minimizer_2_torch) on one
NVIDIA GPU (written for an H100, sm_90a).

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. Device: a CUDA device must be present; prints nvidia-smi's name and
   power limit.
2. Build: nvcc builds the CUDA kernels from genome_minimizer_2_torch/csrc/
   and g++ builds native/gm2min.cpp, both at once, into
   genome_minimizer_2_torch/build/.
3. Kernel against its plain version on the card: decode_threshold_pack at
   the pipeline's shape (512, 1024, 55,040) in float32 and bfloat16 and at
   ragged shapes (M = 300, N = 1000 / 1003). A bit may differ only where
   the plain logit is within 1e-3 of 0, and at most 1e-5 of all bits may
   differ. Times the kernel, the plain version and torch.matmul alone.
4. Main path at full v0 width (55,039 genes, hidden 1024, latent 64): in a
   temporary GM2_ROOT it writes a gene vocabulary, essentials, phylogroups,
   a 4,641,652 bp GenBank file with ~4,000 genes and a random v0 checkpoint
   (seeded), then runs the port's CLI ``--mode pipeline`` on cuda for 4,096
   genomes in chunks of 512, in default and in focused sampling mode.
5. Checks: kernel launches per run equal the run's decode chunks; the FASTA
   has every record with the expected header; the first chunk's records are
   byte-equal to a plain recompute (plain decode on the card + the numpy
   minimize), where a mismatch is allowed only for a record whose
   FASTA-relevant bits include a logit within 1e-3 of 0 (such records are
   counted and printed).
6. Prints a JSON line of per-kernel numbers, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

``--profile DIR`` adds one more default-mode pipeline run (half the
genomes, over the same output file) under
torch.profiler after the checks: it prints the device time by kernel and the
device's busy share of that run's wall time, and writes a Chrome trace into
DIR. The main-path runs above are never profiled.
"""

from __future__ import annotations

import json
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
GENOME_LENGTH = 4_641_652
N_FEATURES = 4_000
N_ESSENTIAL = 300
NUM_SAMPLES = 4_096
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
        # each input read once as it is passed (h float32, W in the compute
        # dtype, b float32), the packed output written once
        flops = 2.0 * M * K * N
        nbytes = (h.numel() * h.element_size() + wc.numel() * wc.element_size()
                  + N * 4 + M * width)
        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
        t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
        res["ms"] = time_ms(lambda: KR.decode_threshold_pack(h, wc, b, dtype))
        res["plain_ms"] = time_ms(
            lambda: KR.decode_threshold_pack_reference(h, wc, b, dtype))
        hc = h.to(dtype)
        res["library_ms"] = time_ms(lambda: torch.matmul(hc, wc))
        res["bound_ms"] = max(t_ops, t_bytes)
        res["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        log(f"  time {name}: kernel {res['ms']:.4f} ms, plain "
            f"{res['plain_ms']:.4f} ms, torch.matmul {res['library_ms']:.4f} "
            f"ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}; "
            f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)")
    return res


def check_kernel() -> dict:
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(1234)
    main_bf16 = None
    worst = 0.0
    for M, K, N in ((CHUNK, 1024, 55_040), (300, 1024, 1000), (300, 1024, 1003)):
        for dtype in (torch.float32, torch.bfloat16):
            timed = M == CHUNK
            res = check_kernel_case(M, K, N, dtype, gen, timed)
            worst = max(worst, res["max_abs_err"])
            if timed and dtype == torch.bfloat16:
                main_bf16 = res
    main_bf16["max_abs_err"] = worst
    return main_bf16


# ---------------------------------------------------------------------------
# phase 4: inputs for the main path
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


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="also profile one pipeline run; trace into DIR")
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

    smi = nvidia_smi_line()
    card = torch.cuda.get_device_name(0)
    log(f"device: {card} ({smi}), torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    build = build_all()
    kernel = check_kernel()

    root = Path(tempfile.mkdtemp(prefix="gm2_smoke_"))
    old_root = os.environ.get("GM2_ROOT")
    os.environ["GM2_ROOT"] = str(root)
    try:
        t0 = time.perf_counter()
        inputs = write_inputs(root)
        log(f"inputs written in {time.perf_counter() - t0:.1f}s under GM2_ROOT")
        runs = run_main_path(inputs, root, card)
        profiled = (profile_main_path(inputs, root, opts.profile)
                    if opts.profile else None)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if old_root is None:
            os.environ.pop("GM2_ROOT", None)
        else:
            os.environ["GM2_ROOT"] = old_root

    record = {
        "name": "decode_threshold_pack",
        "route": "cuda",
        "source": "genome_minimizer_2_torch/csrc/decode_threshold_pack.cu",
        "replaces": "genome_minimizer_2_tpu/ops/pallas_kernels.py:110",
        "launches": sum(r["launches"] for r in runs.values()),
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"],
        "bound_ms": kernel["bound_ms"],
        "bound_by": kernel["bound_by"],
        "library_ms": kernel["library_ms"],
        "shape": [CHUNK, 1024, 55_040],
        "dtype": "bfloat16",
        "bits_differing": kernel["bits_differing"],
        "launches_by_mode": {m: r["launches"] for m, r in runs.items()},
    }
    log(json.dumps({"pipeline": runs, "build_s": build, "profile": profiled,
                    "wall_s": time.perf_counter() - t_all}))
    print(json.dumps({"kernels": [record]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

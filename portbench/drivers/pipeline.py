"""Pipeline cells: the program's ``sample_and_minimize`` (``--mode
pipeline``) over the window: every genome decoded, thresholded, packed,
copied to the host, converted, minimized and written as a FASTA record.

Set-up makes a trained-like model's weights from the seed on the card, as
the sampling cells do, and from the seed the matrix's column names, the
wild-type genome and the essential genes (``portbench/genbank.py``); it
writes the genome as GenBank under ``TMPDIR``, has the program parse it
(``MinimizerEngine.from_genbank``) and warms one call. The output file is
an anonymous file in memory (``os.memfd_create``) named by its
``/proc/self/fd`` path: the program writes it as it writes a file on disk,
in place from offset 0 each call, and nothing of the FASTA reaches a disk.
It holds one call's records, some 11 GB at K-12's size.

The window calls ``sample_and_minimize(key_c, genomes)`` with ``key_c =
fold_in(root, c)`` for c = 0, 1, ... until a call ends past ``--seconds``.
The program is handed its own engine behind a wrapper that forwards
every call and only watches: it marks the range
``portbench/pipeline/minimize`` in the minimize worker, counts the bases
written and, for chunks drawn from the seed, keeps the packed rows and the
record lengths the writer returned; each call runs inside
``portbench/pipeline_call``. After the call the records of a few genomes
of each kept chunk, drawn from the seed, are read back from the file. Once the window has closed and the
program is freed, the reference decodes the kept chunks' latents in float32
(``bit_gap``) and builds the kept genomes' records from the program's rows
(``record_mismatch``, exact; the header's first two lines count as one).
"""

from __future__ import annotations

import functools
import gc
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import record_function

from portbench import genbank, harness, inputs, trace
from portbench.reference import pipeline as RPL
from portbench.reference import prng as RP
from portbench.reference import sample as RS
from portbench.reference import vae as RV

CHECKED = ("bit_gap", "record_mismatch")
FAULTS = ("altered_bit", "no_essential_union", "interval_off_by_one")


def _sample_driver():
    return harness.load_module(harness.HERE / "drivers" / "sample.py")


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), stream])


def given(cell, seed: int) -> tuple[list, genbank.Genome, set]:
    """The column names, the wild-type genome and the essential genes."""
    p = cell.traffic["genome"]
    cols = genbank.column_names(seed, cell.config["input_dim"], p["duplicate_share"])
    g = genbank.genome(seed, cols, p)
    return cols, g, genbank.essential_set(seed, g, cell.traffic["essential_genes"])


class Engine:
    """The program's engine, forwarding every call. Its packed writer runs
    inside the range ``portbench/pipeline/minimize``, adds the bases it
    wrote to ``bases`` and, for the chunk
    that starts at ``keep_lo``, leaves the chunk's rows, the lengths it
    returned and the byte offset it wrote at in ``kept``."""

    def __init__(self, engine):
        self._engine, self.keep_lo, self.kept, self.bases = engine, None, None, 0

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def minimize_packed_to_fasta(self, packed, *args, start_index=0, **kw):
        with record_function("portbench/pipeline/minimize"):
            lens = self._engine.minimize_packed_to_fasta(packed, *args,
                                                         start_index=start_index, **kw)
        self.bases += int(np.sum(lens))
        if start_index == self.keep_lo:
            self.kept = {"rows": np.array(packed), "lens": np.array(lens),
                         "base": int(kw["write_base"])}
        return lens


class Slice(trace.Slice):
    """``trace.Slice`` that also records the ranges of threads other than
    the one that starts it: the minimize worker's."""

    def __init__(self):
        super().__init__()
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            experimental_config=_ExperimentalConfig(profile_all_threads=True))


def setup(cell, seed: int, device, parts: dict) -> dict:
    from genome_minimizer_2_torch import pipeline as PL
    from genome_minimizer_2_torch.core.dtypes import resolve_policy
    from genome_minimizer_2_torch.genome import native
    from genome_minimizer_2_torch.genome.minimizer import MinimizerEngine
    from genome_minimizer_2_torch.models import vae
    from genome_minimizer_2_torch.ops import kernels as K
    from genome_minimizer_2_torch.sample import sampler as SMP

    cfg, e, tr = cell.config, cell.config["experiment"], cell.traffic
    if tr["sampling_mode"] != "default" or tr["transfer"] != "packed":
        raise ValueError("the pipeline driver runs default sampling with the "
                         "packed transfer only")
    t = time.perf_counter()
    if device.type == "cuda":
        K.load_library()
    native.get_lib()
    parts["load"] = time.perf_counter() - t

    t = time.perf_counter()
    mcfg = vae.VAEConfig(input_dim=cfg["input_dim"], hidden_dim=e["hidden_dim"],
                         latent_dim=e["latent_dim"],
                         policy=resolve_policy(tr["compute_dtype"], device.type))
    params, stats = _sample_driver().make_weights(cell, seed, device)
    with torch.device(device):
        model = vae.VAE(mcfg)
    with torch.no_grad():
        for src, dst in ((params, model.flat_params()), (stats, model.flat_stats())):
            for k, p in dst.items():
                p.zero_()
                p[tuple(slice(0, n) for n in src[k].shape)] = src[k]
    del params, stats
    sampler = SMP.Sampler(model=model, chunk_size=tr["chunk_size"])
    parts["weights"] = time.perf_counter() - t

    t = time.perf_counter()
    cols, g, essential = given(cell, seed)
    with tempfile.TemporaryDirectory() as d:
        engine = Engine(MinimizerEngine.from_genbank(genbank.write(Path(d) / "genome.gb",
                                                                   g)))
    fd = os.memfd_create("portbench-fasta")
    parts["genome"] = time.perf_counter() - t

    t = time.perf_counter()
    call = functools.partial(
        PL.sample_and_minimize, sampler, engine, cols, essential,
        tr["genomes_per_call"], f"/proc/self/fd/{fd}", chunk_size=tr["chunk_size"],
        model_name=cfg["name"], prefetch=tr["prefetch"], transfer=tr["transfer"],
        native_threads=tr["native_threads"], overlap=tr["overlap"],
        sampling_mode=tr["sampling_mode"])
    warm_key = torch.tensor(RP.fold_in(RP.key_of(inputs.prng_key(seed, 4)), 0)
                            .astype(np.int64), device=device)
    call(key=warm_key)
    if device.type == "cuda":
        torch.cuda.synchronize()
    parts["warm"] = time.perf_counter() - t
    return {"call": call, "engine": engine, "fd": fd, "device": device}


def release(s: dict) -> None:
    """Close the output file (its memory goes with it) and free the model."""
    os.close(s["fd"])
    s.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def read_records(fd: int, lo: int, kept: dict, picks) -> list[bytes]:
    """The records of genomes ``lo + picks`` of a kept chunk, read from the
    output file at the offsets the writer's lengths give (empty where the
    writer returned no length for a genome)."""
    sizes = [len(RPL.record(lo + i, b"")) + int(n) for i, n in enumerate(kept["lens"])]
    offsets = kept["base"] + np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    return [os.pread(fd, sizes[i], int(offsets[i])) if i < len(sizes) else b""
            for i in picks]


def window(s: dict, cell, seed: int, seconds: float, traced: bool) -> dict:
    tr = cell.traffic
    engine, fd, device = s["engine"], s["fd"], s["device"]
    n, C = tr["genomes_per_call"], tr["chunk_size"]
    root = RP.key_of(inputs.prng_key(seed, 1))
    keeper = _sample_driver().Keeper(seed, n // C, **tr["keep"])
    picks = _rng(seed, 33)
    head = len(RPL.header_lines(cell.config["name"], n))
    times = []  # (seconds, the program's minimize seconds) a call

    def call(c: int, keep: bool) -> None:
        j = keeper.pick(c) if keep else None
        engine.keep_lo, engine.kept = (None if j is None else j * C), None
        key = torch.tensor(RP.fold_in(root, c).astype(np.int64), device=device)
        t = time.perf_counter()
        with record_function("portbench/pipeline_call"):
            stats = s["call"](key=key)
        times.append((time.perf_counter() - t, stats.minimize_s))
        if j is not None:
            idx = np.sort(picks.choice(C, tr["records_per_chunk"], replace=False))
            keeper.kept.append({"call": c, "lo": j * C, "hi": j * C + C,
                                "rows": engine.kept["rows"], "picks": idx,
                                "records": read_records(fd, j * C, engine.kept, idx),
                                "header": os.pread(fd, head, 0)})

    t0 = time.perf_counter()
    bases0 = engine.bases
    calls = 0
    while True:
        call(calls, True)
        calls += 1
        if time.perf_counter() - t0 >= seconds:
            break
    rec = {"window_s": time.perf_counter() - t0, "calls": calls, "call_s": times[:calls],
           "genomes": calls * n, "bases": engine.bases - bases0,
           "minimize_s": sum(m for _, m in times[:calls]), "kept": keeper.kept}
    if traced:
        sl = Slice()
        sl.start()
        for c in range(calls, calls + tr["trace_calls"]):
            call(c, False)
        sl.stop()
        rec["trace"] = dict(trace.summarize(sl.events()), seconds=sl.seconds,
                            calls=tr["trace_calls"])
    return rec


def readings(cell, seed: int, kept: list, device, precision: str | None = None,
             fault: str | None = None) -> dict:
    """The kept chunks judged against the reference: the widest gap of
    their rows from its float32 decode, and the records that differ from
    the records it builds from those rows.

    With ``precision`` the rows judged are the reference's own decode at
    that precision (the control) and the records the reference's own from
    them. ``fault`` plants one of ``FAULTS``: a bit of each kept row
    flipped after the program wrote the records; or the program's place
    taken by the reference with the essential genes left out, or with
    every feature's interval a base longer (a location's end read as
    inclusive), into the gap that follows it."""
    RV.set_ieee_float32()
    cfg, e = cell.config, cell.config["experiment"]
    genes = cfg["input_dim"]
    params, stats = _sample_driver().make_weights(cell, seed, device)
    cols, g, essential = given(cell, seed)
    fcols = RPL.feature_columns(cols, g.names)
    fess = np.array([n in essential for n in g.names])
    made_ess, made_ends = fess, g.ends
    rng = _rng(seed, 34)
    if fault == "no_essential_union":
        made_ess = np.zeros_like(fess)
    elif fault == "interval_off_by_one":
        made_ends = g.ends + 1
    program_records = precision is None and fault in (None, "altered_bit")
    header = RPL.header_lines(cfg["name"], cell.traffic["genomes_per_call"])
    root = inputs.prng_key(seed, 1)
    gap, differ, bits, mismatch, compared = 0.0, 0, 0, 0, 0
    with torch.no_grad():
        for k in kept:
            z = torch.from_numpy(RS.latents(root, k["call"], k["lo"], k["hi"],
                                            e["latent_dim"])).to(device)
            want = RS.logits(z, params, stats)
            if precision is None:
                rows = RV.unpack_rows(torch.from_numpy(k["rows"]).to(device), genes)
            else:
                rows = (RS.logits(z, params, stats, precision) > 0).to(torch.uint8)
            if fault == "altered_bit":
                col = torch.from_numpy(rng.integers(genes, size=rows.shape[0]))
                rows[torch.arange(rows.shape[0]), col.to(device)] ^= 1
            g_, n_ = RS.bit_gap(rows, want)
            gap, differ, bits = max(gap, g_), differ + n_, bits + rows.numel()
            picked = rows[torch.from_numpy(k["picks"]).to(device)].cpu().numpy()
            idx = k["lo"] + k["picks"]
            want_records = RPL.records(picked, idx, g.seq, g.starts, g.ends, fcols, fess)
            made = (k["records"] if program_records else
                    RPL.records(picked, idx, g.seq, g.starts, made_ends, fcols, made_ess))
            mismatch += sum(a != b for a, b in zip(made, want_records))
            if program_records:
                mismatch += int(k["header"] != header)
            compared += len(want_records)
    return {"bit_gap": gap, "record_mismatch": mismatch, "bits_differing": differ,
            "bits": bits, "records": compared}


def run(cell, args, device, clock: dict) -> tuple[dict, dict]:
    parts = {"import": clock["import"]}
    s = setup(cell, args.seed, device, parts)
    setup_s = clock["age"] + time.perf_counter() - clock["t0"]
    harness.log("setup parts (s): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
                + f"; process start to the window {setup_s:.3f}")
    rec = window(s, cell, args.seed, args.seconds, bool(args.trace))
    rec.update(setup_s=setup_s, driver="pipeline")
    harness.log(f"window: {rec['calls']} calls, {rec['genomes']} genomes in "
                f"{rec['window_s']:.4f} s; minimize {rec['minimize_s']:.4f} s; "
                f"{rec['bases'] / rec['genomes']:.1f} "
                f"bases a record, {rec['bases'] / rec['window_s'] / 1e9:.3f} GB/s; "
                f"{len(rec['kept'])} chunks kept; calls (s, minimize s): "
                + ", ".join(f"{a:.3f} {b:.3f}" for a, b in rec["call_s"]))
    if device.type == "cuda":
        rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    release(s)
    t = time.perf_counter()
    got = readings(cell, args.seed, rec.pop("kept"), device)
    harness.log(f"reference: {time.perf_counter() - t:.3f} s; {got['bits_differing']} "
                f"of {got['bits']} bits and {got['record_mismatch']} of "
                f"{got['records']} records differ")
    checks = {k: {"value": got[k], "limit": cell.limits[k]} for k in CHECKED}
    return rec, checks

"""Sampling cells: the program's ``Sampler.sample_packed`` over the window,
with the per-genome counts that ``--mode sample`` takes as each chunk
drains (``popcount_rows`` and ``make_essential_counter_packed``), and no
file written.

Set-up makes a trained-like model's weights from the seed on the card and
warms one call. The window calls ``sample_packed(key_c, genomes)`` with
``key_c = fold_in(root, c)`` for c = 0, 1, ... until a call ends past
``--seconds``; the benchmark's span around each ``on_chunk`` call times the
host's counts. Chunks drawn from the seed are kept with their counts; once
the window has closed and the program is freed, the reference decodes
their latents in float32 and the rows and counts are held to it.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import harness, inputs, trace
from portbench.reference import prng as RP
from portbench.reference import sample as RS
from portbench.reference import vae as RV

CHECKED = ("bit_gap", "count_mismatch")


def _sub_seed(seed: int) -> int:
    return int(inputs.prng_key(seed, 21).view("uint64")[0])


def make_weights(cell, seed: int, device) -> tuple[dict, dict]:
    cfg = cell.config
    gen = inputs.generator(_sub_seed(seed), device)
    return inputs.vae_weights(gen, cfg["input_dim"], cfg["experiment"]["hidden_dim"],
                              cfg["experiment"]["latent_dim"], trained=True)


def essential(cell, seed: int) -> dict:
    t = cell.traffic
    return inputs.essential_genes(seed, cell.config["input_dim"],
                                  t["essential_genes"], t["essential_columns_max"])


class Keeper:
    """Which chunks are kept for the check: each call's chunk drawn from
    the seed, for every call up to ``first`` and then with probability
    ``share``, at most ``most`` of them."""

    def __init__(self, seed: int, chunks: int, first: int, share: float, most: int):
        self.rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 3])
        self.chunks, self.first, self.share, self.most = chunks, first, share, most
        self.kept: list = []

    def pick(self, call: int):
        j = int(self.rng.integers(self.chunks))
        keep = call < self.first or self.rng.random() < self.share
        return j if keep and len(self.kept) < self.most else None


def setup(cell, seed: int, device, parts: dict) -> dict:
    from genome_minimizer_2_torch.core.dtypes import resolve_policy
    from genome_minimizer_2_torch.models import vae
    from genome_minimizer_2_torch.ops import kernels as K
    from genome_minimizer_2_torch.sample import sampler as SMP

    t = time.perf_counter()
    if device.type == "cuda":
        K.load_library()
    parts["load"] = time.perf_counter() - t

    t = time.perf_counter()
    cfg, e, tr = cell.config, cell.config["experiment"], cell.traffic
    mcfg = vae.VAEConfig(input_dim=cfg["input_dim"], hidden_dim=e["hidden_dim"],
                         latent_dim=e["latent_dim"],
                         policy=resolve_policy(tr["compute_dtype"], device.type))
    params, stats = make_weights(cell, seed, device)
    with torch.device(device):
        model = vae.VAE(mcfg)
    with torch.no_grad():
        for src, dst in ((params, model.flat_params()), (stats, model.flat_stats())):
            for k, p in dst.items():
                p.zero_()
                p[tuple(slice(0, n) for n in src[k].shape)] = src[k]
    del params, stats
    sampler = SMP.Sampler(model=model, chunk_size=tr["chunk_size"])
    counter = SMP.make_essential_counter_packed(essential(cell, seed), cfg["input_dim"])
    parts["weights"] = time.perf_counter() - t

    t = time.perf_counter()
    warm_key = torch.tensor(RP.fold_in(RP.key_of(inputs.prng_key(seed, 4)), 0)
                            .astype(np.int64), device=device)
    sampler.sample_packed(warm_key, tr["genomes_per_call"],
                          on_chunk=lambda lo, hi, arr: (SMP.popcount_rows(arr),
                                                        counter(arr)))
    if device.type == "cuda":
        torch.cuda.synchronize()
    parts["warm"] = time.perf_counter() - t
    return {"sampler": sampler, "counter": counter, "smp": SMP, "kernels": K}


def window(s: dict, cell, seed: int, seconds: float, traced: bool) -> dict:
    tr = cell.traffic
    sampler, counter, SMP, K = s["sampler"], s["counter"], s["smp"], s["kernels"]
    device = sampler.device
    root = RP.key_of(inputs.prng_key(seed, 1))
    chunks = tr["genomes_per_call"] // tr["chunk_size"]
    keeper = Keeper(seed, chunks, **tr["keep"])
    host = [0.0]
    state = {"call": 0, "pick": None}

    def on_chunk(lo, hi, arr):
        t = time.perf_counter()
        sizes = SMP.popcount_rows(arr)
        ess = counter(arr)
        host[0] += time.perf_counter() - t
        if state["pick"] is not None and lo == state["pick"] * tr["chunk_size"]:
            keeper.kept.append({"call": state["call"], "lo": lo, "hi": hi,
                                "rows": np.array(arr), "sizes": sizes, "ess": ess})

    def call(c: int, keep: bool) -> None:
        key = torch.tensor(RP.fold_in(root, c).astype(np.int64), device=device)
        state["call"] = c
        state["pick"] = keeper.pick(c) if keep else None
        with torch.profiler.record_function("portbench/sample_call"):
            sampler.sample_packed(key, tr["genomes_per_call"], on_chunk=on_chunk)

    t0 = time.perf_counter()
    calls = 0
    while True:
        call(calls, True)
        calls += 1
        if time.perf_counter() - t0 >= seconds:
            break
    rec = {"window_s": time.perf_counter() - t0, "calls": calls,
           "genomes": calls * tr["genomes_per_call"], "host_count_s": host[0],
           "kept": keeper.kept}
    if traced:
        sl = trace.Slice()
        before = K.launch_counts()
        sl.start()
        for c in range(calls, calls + tr["trace_calls"]):
            call(c, False)
        sl.stop()
        after = K.launch_counts()
        rec["trace"] = dict(trace.summarize(sl.events()), seconds=sl.seconds,
                            calls=tr["trace_calls"],
                            launches={k: after[k] - before[k] for k in after})
    return rec


def reference_gaps(cell, seed: int, kept: list, device, precision: str = "float32",
                   against: str = "program") -> dict:
    """The widest gap of the kept rows from the reference's decode and the
    genomes whose counts differ from a recount of their rows. With
    ``against`` "reference", the rows judged are the reference's own decode
    at ``precision`` (the control), judged against float32."""
    RV.set_ieee_float32()
    cfg, e = cell.config, cell.config["experiment"]
    params, stats = make_weights(cell, seed, device)
    root = inputs.prng_key(seed, 1)
    ess = essential(cell, seed)
    genes = cfg["input_dim"]
    gap, differ, mismatch, bits = 0.0, 0, 0, 0
    with torch.no_grad():
        for k in kept:
            z = torch.from_numpy(RS.latents(root, k["call"], k["lo"], k["hi"],
                                            e["latent_dim"])).to(device)
            want = RS.logits(z, params, stats)
            if against == "program":
                rows = RV.unpack_rows(torch.from_numpy(k["rows"]).to(device), genes)
                sizes, n_ess = RS.counts(rows, ess)
                mismatch += int(((sizes != k["sizes"]) | (n_ess != k["ess"])).sum())
            else:
                rows = (RS.logits(z, params, stats, precision) > 0).to(torch.uint8)
            g, n = RS.bit_gap(rows, want)
            gap, differ, bits = max(gap, g), differ + n, bits + rows.numel()
    return {"bit_gap": gap, "count_mismatch": mismatch, "bits_differing": differ,
            "bits": bits}


def run(cell, args, device, clock: dict) -> tuple[dict, dict]:
    parts = {"import": clock["import"]}
    s = setup(cell, args.seed, device, parts)
    setup_s = clock["age"] + time.perf_counter() - clock["t0"]
    harness.log("setup parts (s): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
                + f"; process start to the window {setup_s:.3f}")
    rec = window(s, cell, args.seed, args.seconds, bool(args.trace))
    rec.update(setup_s=setup_s, driver="sample", genes=cell.config["input_dim"],
               genes_padded=-(-cell.config["input_dim"] // 128) * 128,
               hidden=cell.config["experiment"]["hidden_dim"],
               latent=cell.config["experiment"]["latent_dim"],
               chunk_size=cell.traffic["chunk_size"],
               compute_dtype=cell.traffic["compute_dtype"])
    harness.log(f"window: {rec['calls']} calls, {rec['genomes']} genomes in "
                f"{rec['window_s']:.4f} s; host counts {rec['host_count_s']:.4f} s; "
                f"{len(rec['kept'])} chunks kept for the check")
    if device.type == "cuda":
        rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    s.clear()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    got = reference_gaps(cell, args.seed, rec.pop("kept"), device)
    harness.log(f"reference: {time.perf_counter() - t:.3f} s; {got['bits_differing']} "
                f"of {got['bits']} bits differ")
    checks = {k: {"value": got[k], "limit": cell.limits[k]} for k in CHECKED}
    return rec, checks

"""Streaming sample -> convert -> minimize pipeline (the port of the JAX
package's ``pipeline.py``).

Each chunk of latents is drawn on the device (threefry, keyed per global
sample index), decoded to packed bitmasks by the CUDA
``decode_threshold_pack`` kernel, copied to pinned host memory, and fed
straight to the native C++ minimize workers (converter fused in), which
write the chunk's FASTA records at an explicit byte offset. With
``transfer="feature-bits"`` the device gathers each GenBank feature's keep
bit from that packed output and only those bits cross to the host. Processes
partition the sample axis and rank 0 merges the shards in rank order
(byte-identical to single-process output).

Semantics match the JAX package's pipeline byte for byte at float32:
sampling thresholds strictly (> 0.5), dedupe keeps first-occurrence
columns, essentials are set-unioned, and records are
'>Minimized_E_coli_K12_MG1655_{i+1}\\n{seq}\\n'.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import shutil
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from .genome.converter import dedupe_columns
from .genome.minimizer import MinimizerEngine
from .ops import prng
from .parallel import barrier
from .parallel.distributed import rank_and_world
from .ops.kernels import unpack_bits
from .sample.sampler import Sampler

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class PipelineStats:
    """Per-phase wall time. ``sample_s`` is the host's wait on the decode's
    copies to the host (``HostTransfer.wait``), not the sampling, which
    runs on the device ahead of it. The converter is fused into the native
    minimize workers, so its time is part of minimize_s."""

    genomes: int = 0
    sample_s: float = 0.0
    minimize_s: float = 0.0
    total_s: float = 0.0

    def rate(self) -> float:
        return self.genomes / max(self.total_s, 1e-9)


def _header(model_name: str, num_samples: int) -> bytes:
    return (f"# Minimized genomes generated using model: {model_name}\n"
            f"# Total genomes: {num_samples}\n"
            f"# Generated on: {np.datetime64('now')}\n").encode()


def sample_and_minimize(
    sampler: Sampler,
    engine: MinimizerEngine,
    cols: Sequence[str],
    essential_set: set[str],
    num_samples: int,
    output_file: str,
    key: torch.Tensor | None = None,
    chunk_size: int = 512,
    model_name: str = "pipeline",
    process_index: int | None = None,
    process_count: int | None = None,
    merge: bool = True,
    write_header: bool = True,
    prefetch: int = 2,
    transfer: str = "auto",
    native_threads: int | None = None,
    overlap: bool = True,
    sampling_mode: str = "default",
    noise_level: float = 0.1,
    n_probes: int = 100,
) -> PipelineStats:
    """Stream ``num_samples`` synthetic genomes into ``output_file``.

    Multi-process: rank pi handles samples [pi*n/pc, (pi+1)*n/pc) into
    ``output_file.shard{pi}``; rank 0 merges. One process writes directly.

    ``sampling_mode="default"``: z_i = normal(fold_in(key, i)).
    ``"focused"``: the probe/anchor stage runs once under the first half of
    ``split(key)`` (``Sampler.focused_anchor``), then z_i = z* + noise_level
    * normal(fold_in(noise_key, i)) streams through the same packed path.

    ``transfer``: ``"packed"`` ships the packed gene bitmask of each chunk
    (ceil(D/8) bytes a genome; the converter runs in the native workers);
    ``"feature-bits"`` ships only the per-feature keep bits gathered on the
    device from the same packed mask (``Sampler.make_feature_decoder``,
    ceil(F/8) bytes a genome), byte-equal output. ``"auto"`` is
    ``"packed"``, as in the JAX package: the pipeline is bound by the
    native minimize, and the feature bits add a host unpack to it.

    ``overlap=True``: the device decodes up to ``prefetch`` chunks ahead
    while one worker thread runs the native convert+minimize; ``False``
    runs each chunk's decode, transfer and minimize in turn.
    ``native_threads``: minimize worker threads per chunk (0/None = all
    cores).
    """
    key = prng.key(0, sampler.device) if key is None else key.to(sampler.device)
    rank, world = rank_and_world()
    pi = rank if process_index is None else process_index
    pc = world if process_count is None else process_count

    if sampling_mode not in ("default", "focused"):
        raise ValueError(f"unknown sampling_mode {sampling_mode!r}")
    if transfer not in ("auto", "packed", "feature-bits"):
        raise ValueError(f"unknown transfer mode {transfer!r}")
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")

    anchor = None
    if sampling_mode == "focused":
        probe_key, key = prng.split(key)
        anchor = torch.as_tensor(sampler.focused_anchor(probe_key, n_probes),
                                 dtype=torch.float32, device=sampler.device)
    noise = torch.tensor(noise_level, dtype=torch.float32, device=sampler.device)

    cols_arr, keep_mask = dedupe_columns(np.asarray(cols))
    if keep_mask.size != sampler.cfg.input_dim:
        raise ValueError(
            f"column count {keep_mask.size} != model input dim "
            f"{sampler.cfg.input_dim}")
    # Converter fused into the native minimize workers: per-feature column
    # index (original column space) + essential flag, computed once.
    col_idx, ess_flags = engine.feature_lookup_packed(cols_arr, keep_mask,
                                                      essential_set)
    n_features = int(col_idx.size)
    feature_bits = transfer == "feature-bits"
    decode_features = (sampler.make_feature_decoder(col_idx, ess_flags)
                       if feature_bits else None)

    lo_all = pi * num_samples // pc
    hi_all = (pi + 1) * num_samples // pc

    sharded = pc > 1
    shard_path = barrier.shard_file(output_file, pi) if sharded else output_file
    os.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
    if sharded:
        # a new stream over a previous --no-merge output retracts its own
        # stale sentinel BEFORE the in-place rewrite begins, so no merger
        # reads this shard mid-rewrite as complete
        try:
            os.remove(shard_path + ".done")
        except FileNotFoundError:
            pass

    stats = PipelineStats()
    t_start = time.perf_counter()
    header = _header(model_name, num_samples) if write_header and not sharded else b""
    # In-place stream: the header is written without truncating and every
    # chunk lands at an explicit byte offset, so a previous output's pages
    # are rewritten rather than freed and re-allocated; one truncate at
    # stream end cuts any stale tail.
    if not os.path.exists(shard_path):
        open(shard_path, "wb").close()
    with open(shard_path, "r+b") as hf:
        hf.write(header)
    next_off = len(header)
    # grow-only invariant: after every chunk the file size must be exactly
    # max(initial size, computed end offset) — catches any drift between
    # engine.record_bytes and the native writer's layout at its first chunk
    size0 = max(os.path.getsize(shard_path), len(header))

    latent_dim = sampler.cfg.latent_dim
    spans = [(lo, min(lo + chunk_size, hi_all))
             for lo in range(lo_all, hi_all, chunk_size)]

    def submit(span):
        lo, hi = span
        # fixed chunk_size shapes (indices and decode); rows >= hi are
        # decoded and trimmed at drain
        idx = torch.arange(lo, lo + chunk_size, dtype=torch.int64,
                           device=sampler.device)
        z = prng.draw_latents(key, idx, latent_dim)
        if anchor is not None:  # focused: z* + noise_level * noise_i
            z = anchor + noise * z
        return lo, hi, (decode_features(z) if feature_bits
                        else sampler.decode_packed_device(z))

    if native_threads is None:
        native_threads = 0  # all cores

    def minimize_chunk(arr, lo, hi):
        nonlocal next_off
        t0 = time.perf_counter()
        if feature_bits:
            keep = unpack_bits(arr, n_features)
            lens = engine.minimize_drop_to_fasta(1 - keep, shard_path,
                                                 start_index=lo,
                                                 write_base=next_off,
                                                 n_threads=native_threads)
        else:
            lens = engine.minimize_packed_to_fasta(arr, col_idx, ess_flags,
                                                   shard_path, start_index=lo,
                                                   write_base=next_off,
                                                   n_threads=native_threads)
        next_off += engine.record_bytes(lens, start_index=lo)
        actual = os.path.getsize(shard_path)
        if actual != max(size0, next_off):
            raise RuntimeError(
                f"FASTA stream offset drift at chunk [{lo},{hi}): computed "
                f"end {next_off}, writer left size {actual} "
                f"(stream started at {size0})")
        stats.minimize_s += time.perf_counter() - t0
        stats.genomes += hi - lo

    def drain(transfer, lo, hi):
        t0 = time.perf_counter()
        packed = transfer.wait()[: hi - lo]
        stats.sample_s += time.perf_counter() - t0
        return packed

    try:
        if not overlap:
            for span in spans:
                lo, hi, dev = submit(span)
                minimize_chunk(drain(dev, lo, hi), lo, hi)
        else:
            it = iter(spans)
            pending: deque = deque()
            for _ in range(min(max(1, prefetch), len(spans))):
                pending.append(submit(next(it)))
            # The device decodes chunk k+P, the main thread drains chunk
            # k+1's copy, and ONE worker thread runs chunk k's native
            # minimize (the C++ call releases the GIL; one ordered worker
            # keeps the FASTA offsets sequential).
            with ThreadPoolExecutor(max_workers=1) as pool:
                futures = deque()
                while pending:
                    lo, hi, dev = pending.popleft()
                    nxt = next(it, None)
                    if nxt is not None:
                        pending.append(submit(nxt))
                    packed = drain(dev, lo, hi)
                    futures.append(pool.submit(minimize_chunk, packed, lo, hi))
                    while len(futures) > 2:  # bound buffered chunks
                        futures.popleft().result()
                for f in futures:
                    f.result()
    finally:
        # Stream-end truncate, also on failure: next_off only advances past
        # fully written chunks, so this leaves a valid prefix on error and
        # the exact output on success (no stale tail of a larger old file).
        with open(shard_path, "r+b") as tf:
            tf.truncate(next_off)

    if sharded:
        barrier.mark_shard_done(shard_path)
    stats.total_s = time.perf_counter() - t_start

    if sharded and merge and pi == 0:
        # sentinel barrier: every shard is complete before merging
        shard_paths = barrier.wait_for_shards(output_file, pc)
        with open(output_file, "wb") as out:
            if write_header:
                out.write(_header(model_name, num_samples))
            for sp in shard_paths:
                with open(sp, "rb") as f:
                    shutil.copyfileobj(f, out, length=16 << 20)
        barrier.clear_sentinels(output_file, pc)
    logger.info("pipeline: %d genomes in %.2fs (%.1f/s) — sample %.2fs, "
                "convert+minimize %.2fs", stats.genomes, stats.total_s,
                stats.rate(), stats.sample_s, stats.minimize_s)
    return stats

"""Cross-host barrier for shared-filesystem shard merges: the port's own
copy of the JAX package's ``parallel/barrier.py`` (same shard names and
sentinels, so shards written by either package merge alike).

Multi-host FASTA generation (genome/minimizer.py::process_sharded,
pipeline.py::sample_and_minimize) has each process write
``output_file.shard{K}`` and host 0 concatenate them in process order. The
merge only makes sense on a shared filesystem (host 0 must *read* the other
hosts' shards), so the barrier uses the same channel: each writer publishes a
``.done`` sentinel atomically after its shard is fully written and fsync'd,
and the merger polls for all sentinels before reading any shard. This works
identically for real multi-controller runs and for the simulated
process_index/process_count test paths, and never deadlocks a 1-process run.

Without it, a straggler host would leave a truncated merged FASTA.
"""

from __future__ import annotations

import os
import time

_DONE_SUFFIX = ".done"


def shard_file(output_file: str, k: int) -> str:
    """Canonical shard path for process k (shared by both writers)."""
    return f"{output_file}.shard{k:05d}"


def mark_shard_done(shard_path: str) -> None:
    """Atomically publish that ``shard_path`` is complete.

    The shard's bytes are forced to stable storage first, then the sentinel
    appears atomically (write-temp + rename), so a merger that sees the
    sentinel is guaranteed to read the full shard even across NFS-style
    close-to-open consistency.
    """
    fd = os.open(shard_path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    tmp = shard_path + _DONE_SUFFIX + ".tmp"
    with open(tmp, "w") as f:
        f.write("ok\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, shard_path + _DONE_SUFFIX)


def wait_for_shards(output_file: str, process_count: int,
                    timeout_s: float | None = None,
                    poll_s: float = 0.05) -> list[str]:
    """Block until every shard's sentinel exists; return the shard paths.

    Raises TimeoutError naming the missing shards if the barrier does not
    clear within ``timeout_s`` (env GM2_SHARD_BARRIER_TIMEOUT_S, default 600).
    """
    if timeout_s is None:
        timeout_s = float(os.environ.get("GM2_SHARD_BARRIER_TIMEOUT_S", "600"))
    paths = [shard_file(output_file, k) for k in range(process_count)]
    deadline = time.monotonic() + timeout_s
    while True:
        missing = [p for p in paths if not os.path.exists(p + _DONE_SUFFIX)]
        if not missing:
            return paths
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"shard barrier: {len(missing)}/{process_count} shards not "
                f"done after {timeout_s:.0f}s: {missing[:4]}")
        time.sleep(poll_s)


def clear_sentinels(output_file: str, process_count: int) -> None:
    """Remove the sentinels after a successful merge (host 0 only)."""
    for k in range(process_count):
        try:
            os.remove(shard_file(output_file, k) + _DONE_SUFFIX)
        except FileNotFoundError:
            pass

"""Time sample mode's two host counts on cold packed chunks.

A chunk is the sampling cell's: 1,024 rows of 6,880 bytes (55,039 genes),
300 essential genes of 1-3 positions. ``--chunks`` distinct chunks (448 MB
at 64) are counted in turn, so each count reads a chunk that is not in the
caches, as a chunk fresh from the card's copy is not. Times the package's
``popcount_rows`` and essential counter as ``--mode sample`` calls them
(``--package-root`` picks another checkout's package, such as a parent
commit's), then, where the package has ``sample/host_counts.py``, each
thread count of ``--threads``. Prints one JSON line: median and quartile
milliseconds a chunk for each, and ``count_stats()``.

    python tools/host_count_times.py [--package-root DIR] [--rounds 5]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROWS, WIDTH, GENES, INPUT_DIM = 1024, 6880, 300, 55_039


def chunks_and_genes(n: int, seed: int):
    rng = np.random.default_rng(seed)
    chunks = [rng.integers(0, 256, (ROWS, WIDTH), dtype=np.uint8) for _ in range(n)]
    for c in chunks:  # zero pad bits, as the decode leaves them
        c[:, -1] &= (1 << (INPUT_DIM - 8 * (WIDTH - 1))) - 1
    genes = {f"g{i}": rng.integers(0, INPUT_DIM, rng.integers(1, 4)).tolist()
             for i in range(GENES)}
    return chunks, genes


def per_chunk_ms(fn, chunks, rounds: int) -> dict:
    times = []
    for _ in range(rounds):
        for c in chunks:
            t = time.perf_counter()
            fn(c)
            times.append(1e3 * (time.perf_counter() - t))
    q1, med, q3 = statistics.quantiles(times, n=4)
    return {"median_ms": med, "q1_ms": q1, "q3_ms": q3}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package-root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--chunks", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--threads", type=int, nargs="*", default=[1, 2, 4, 8])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.package_root))
    from genome_minimizer_2_torch.sample import sampler as S

    chunks, genes = chunks_and_genes(args.chunks, args.seed)
    counter = S.make_essential_counter_packed(genes, INPUT_DIM)
    want = [(S.popcount_rows(c), counter(c)) for c in chunks[:2]]
    out = {"package_root": args.package_root, "cores": len(os.sched_getaffinity(0)),
           "as_called": per_chunk_ms(lambda c: (S.popcount_rows(c), counter(c)),
                                     chunks, args.rounds)}
    try:
        from genome_minimizer_2_torch.sample import host_counts as HC
    except ImportError:
        HC = None
    if HC is not None:
        out["count_stats"] = S.count_stats()
        out["threads_for_chunk"] = HC.threads_for(ROWS)
        table = HC.EssentialTable([sorted(p for p in ps if p < INPUT_DIM)
                                   for ps in genes.values()])
        for n in args.threads:
            got = [(HC.popcount_rows(c, n), table.count(c, n)) for c in chunks[:2]]
            for (a, b), (x, y) in zip(got, want):
                if not (np.array_equal(a, x) and np.array_equal(b, y)):
                    raise AssertionError(f"{n} threads count otherwise")
            out[f"threads_{n}"] = per_chunk_ms(
                lambda c, n=n: (HC.popcount_rows(c, n), table.count(c, n)),
                chunks, args.rounds)
            out[f"threads_{n}_sizes_only"] = per_chunk_ms(
                lambda c, n=n: HC.popcount_rows(c, n), chunks, args.rounds)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

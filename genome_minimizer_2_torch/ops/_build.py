"""Build-at-first-use for the port's native libraries.

Three shared libraries with plain C interfaces, loaded with ``ctypes``:

- the CUDA kernels, ``csrc/*.cu`` compiled by ``nvcc`` for ``sm_90a``,
  one ``nvcc -c`` per source, all started together, then linked against
  the CUDA runtime only (the TMA descriptors' encoder, a libcuda function,
  is looked up with ``cudaGetDriverEntryPointByVersion``: no ``-lcuda``);
- the minimize core, ``native/gm2min.cpp`` compiled by ``g++``;
- sample mode's host counts, ``csrc/host_counts.cpp`` compiled by ``g++``.

All three land in ``genome_minimizer_2_torch/build/`` (listed in .gitignore)
under a name that carries a hash of the sources, the headers they include
(``csrc/*.cuh``) and the command, so a stale
build is never loaded and a rebuilt source never collides with an old one.
A compile goes to a temporary file that is renamed into place, under a
per-library thread lock and file lock, so concurrent threads and processes
(pytest workers, shards) build each library once while different libraries
build at the same time. A failed build raises: there is no fallback.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
REPO_ROOT = PACKAGE_DIR.parent
BUILD_DIR = PACKAGE_DIR / "build"
CSRC_DIR = PACKAGE_DIR / "csrc"
NATIVE_SRC = REPO_ROOT / "native" / "gm2min.cpp"
HOST_COUNTS_SRC = CSRC_DIR / "host_counts.cpp"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread")

_locks = {"gm2_kernels": threading.Lock(), "gm2min": threading.Lock(),
          "gm2_host_counts": threading.Lock()}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels are built from csrc/ at first use")


def _build(name: str, sources: list[Path], compiler: str,
           flags: tuple[str, ...], headers: list[Path] = ()) -> tuple[Path, float]:
    """Compile ``sources`` into ``build/lib{name}-{hash}.so`` unless it is
    there already. Returns (path, seconds spent compiling; 0 if cached)."""
    h = hashlib.sha256()
    for src in [*sources, *headers]:
        h.update(src.read_bytes())
    h.update(" ".join((compiler,) + flags).encode())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    with _locks[name]:
        if out.exists():
            return out, 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / f".{name}.lock", "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                if out.exists():
                    return out, 0.0
                tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
                objs = [out.with_name(f"{out.stem}.{src.stem}.{os.getpid()}.o")
                        for src in sources]
                t0 = time.perf_counter()
                try:
                    # one compile per source, all at once, then one link
                    _run_all([[compiler, *flags, "-c", str(src), "-o", str(obj)]
                              for src, obj in zip(sources, objs)], name)
                    _run_all([[compiler, *flags, "-shared", *map(str, objs),
                               "-o", str(tmp)]], name)
                    os.replace(tmp, out)
                finally:
                    tmp.unlink(missing_ok=True)
                    for obj in objs:
                        obj.unlink(missing_ok=True)
                return out, time.perf_counter() - t0
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)


def _run_all(cmds: list[list[str]], name: str) -> None:
    """Run the commands concurrently; raise with the output of each that
    failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        output, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}:\n{output}")
    if failed:
        raise RuntimeError(f"building {name} failed:\n" + "\n".join(failed))


def build_cuda_kernels() -> tuple[Path, float]:
    """nvcc every ``csrc/*.cu`` into one library for sm_90a."""
    return _build("gm2_kernels", sorted(CSRC_DIR.glob("*.cu")), _nvcc(),
                  NVCC_FLAGS, sorted(CSRC_DIR.glob("*.cuh")))


def build_native() -> tuple[Path, float]:
    """g++ ``native/gm2min.cpp`` (shared with the JAX package's sources,
    built separately into the port's build directory)."""
    return _build("gm2min", [NATIVE_SRC], "g++", GXX_FLAGS)


def build_host_counts() -> tuple[Path, float]:
    """g++ ``csrc/host_counts.cpp``, sample mode's host counts (its
    ``popcnt`` is chosen by a function attribute, not by a flag)."""
    return _build("gm2_host_counts", [HOST_COUNTS_SRC], "g++", GXX_FLAGS)

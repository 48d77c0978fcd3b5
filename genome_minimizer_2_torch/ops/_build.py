"""Build-at-first-use for the port's native libraries.

Two shared libraries with plain C interfaces, loaded with ``ctypes``:

- the CUDA kernels, ``csrc/*.cu`` compiled by ``nvcc`` for ``sm_90a``;
- the minimize core, ``native/gm2min.cpp`` compiled by ``g++``.

Both land in ``genome_minimizer_2_torch/build/`` (listed in .gitignore)
under a name that carries a hash of the source and the command, so a stale
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

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

_locks = {"gm2_kernels": threading.Lock(), "gm2min": threading.Lock()}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels are built from csrc/ at first use")


def _build(name: str, sources: list[Path], compiler: str,
           flags: tuple[str, ...]) -> tuple[Path, float]:
    """Compile ``sources`` into ``build/lib{name}-{hash}.so`` unless it is
    there already. Returns (path, seconds spent compiling; 0 if cached)."""
    h = hashlib.sha256()
    for src in sources:
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
                cmd = [compiler, *flags, *map(str, sources), "-o", str(tmp)]
                t0 = time.perf_counter()
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=600)
                seconds = time.perf_counter() - t0
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(
                        f"building {name} failed ({' '.join(cmd)}):\n"
                        f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, out)
                return out, seconds
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)


def build_cuda_kernels() -> tuple[Path, float]:
    """nvcc every ``csrc/*.cu`` into one library for sm_90a."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    return _build("gm2_kernels", sources, _nvcc(), NVCC_FLAGS)


def build_native() -> tuple[Path, float]:
    """g++ ``native/gm2min.cpp`` (shared with the JAX package's sources,
    built separately into the port's build directory)."""
    return _build("gm2min", [NATIVE_SRC], "g++", GXX_FLAGS)

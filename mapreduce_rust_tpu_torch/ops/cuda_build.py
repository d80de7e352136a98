"""Build the port's CUDA C++ kernels with nvcc and load them with ctypes.

Each source under ``ops/csrc/`` compiles on its own into a shared library
with a plain C interface, at first use, into ``ops/_build/`` (listed in
``.gitignore``). The library's name carries a digest of its source and
flags, so an edited source rebuilds and a built one is reused by every
process that finds it. Nothing here runs at import time, and nothing falls
back: a missing toolkit or a failed compile raises.

Each library a process loads for the first time adds one record to
:data:`BUILD_LOG` (the native host library's g++ build adds its own):
``{"dur_s", "cache", "tool", "source", "t0", "t1"}``, where ``cache`` is
``"miss"`` for a fresh build (``dur_s`` the compiler's seconds) and
``"hit"`` for a library found in the build directory (``dur_s`` the
seconds of its load). The caller loads each library once per process, so
a later use adds nothing. ``run_job`` folds the records made during it
into ``JobStats.compile_*``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

CSRC_DIR = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
ARCH = "sm_90a"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class Build:
    source: str
    path: pathlib.Path
    seconds: float      # 0.0 when an existing build was reused
    log: str            # nvcc's and ptxas's report (registers, spills)


#: Every first load of a kernel library in this process, in order. Only
#: appended to, so a reader slices the records made since a mark.
BUILD_LOG: list[dict] = []
_log_lock = threading.Lock()


def record_build(tool: str, source: str, cache: str, t0: float, t1: float) -> None:
    """Append one record to :data:`BUILD_LOG`; ``t0``/``t1`` are
    ``time.perf_counter()`` readings around the build or the load."""
    with _log_lock:
        BUILD_LOG.append({"dur_s": t1 - t0, "cache": cache, "tool": tool,
                          "source": source, "t0": t0, "t1": t1})


def build_totals(records: list[dict]) -> dict:
    """Count, seconds and hit/miss split of some :data:`BUILD_LOG` records."""
    return {
        "count": len(records),
        "total_s": round(sum(r["dur_s"] for r in records), 6),
        "cache_hits": sum(r["cache"] == "hit" for r in records),
        "cache_misses": sum(r["cache"] == "miss" for r in records),
    }


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = os.path.join(home, "bin", "nvcc")
        path = candidate if os.path.exists(candidate) else None
    if path is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built on a machine with the "
            "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)"
        )
    return path


def library_path(source: str) -> pathlib.Path:
    src = CSRC_DIR / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build(source: str) -> Build:
    """Compile ``csrc/<source>`` unless its library already exists."""
    out = library_path(source)
    if out.exists():
        return Build(source, out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}) on {source}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent process sees all or nothing
    return Build(source, out, seconds, proc.stdout + proc.stderr)


def build_all(sources: list[str]) -> list[Build]:
    """One nvcc per source, all started together."""
    with ThreadPoolExecutor(max_workers=max(len(sources), 1),
                            thread_name_prefix="mr/nvcc") as pool:
        return list(pool.map(build, sources))


def load_library(source: str) -> ctypes.CDLL:
    """The library of ``csrc/<source>``, built first if needed, with one
    record of the build (a miss) or of the load (a hit). The caller loads
    it once per process."""
    t0 = time.perf_counter()
    b = build(source)
    t_built = time.perf_counter()
    lib = ctypes.CDLL(str(b.path))
    if b.seconds:  # a fresh build: the record is nvcc's run
        record_build("nvcc", source, "miss", t_built - b.seconds, t_built)
    else:
        record_build("nvcc", source, "hit", t0, time.perf_counter())
    return lib

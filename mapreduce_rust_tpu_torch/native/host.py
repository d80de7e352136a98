"""ctypes bridge to the native host scanner (native/loader.cpp).

The port's copy of ``mapreduce_rust_tpu/native/host.py``. The shared
object is built with ``g++ -O3 -march=native -shared -fPIC`` at first use
into ``native/_build/`` (listed in ``.gitignore``), under a name keyed by
a digest of the source, the flags and what ``-march=native`` resolves to
on this host, so a library built for another CPU is never loaded. The
build writes a temp file and renames it, so concurrent processes see all
of it or nothing.

Nothing falls back: without g++, or when the compile fails, every entry
raises. The pure-Python versions the tests hold these against live beside
their callers (core/normalize.normalize_python, runtime/driver
``_scan_payload_python``, ``_py_scan_count``, ``_coalesce_updates_py``)
and no production path calls them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import shutil
import subprocess
import threading
import time
import weakref

import numpy as np

from mapreduce_rust_tpu_torch.ops.cuda_build import record_build

_SRC = pathlib.Path(__file__).with_name("loader.cpp")
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_lib_path: pathlib.Path | None = None
build_seconds = 0.0  # wall time of this process's compile; 0.0 when reused


def _gxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError(
            "g++ not found: the native host scanner (native/loader.cpp) is "
            "built with g++ at first use; put g++ on PATH"
        )
    return path


def library_path() -> pathlib.Path:
    """Where this host's build of loader.cpp lives: keyed by the source,
    the flags and the target features ``-march=native`` turns on here."""
    gxx = _gxx()
    target = subprocess.run(
        [gxx, "-march=native", "-Q", "--help=target"],
        capture_output=True, text=True, timeout=60,
    )
    if target.returncode != 0:
        raise RuntimeError(f"g++ -march=native failed:\n{target.stderr[-2000:]}")
    digest = hashlib.sha256(
        _SRC.read_bytes() + " ".join(GXX_FLAGS).encode() + target.stdout.encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"mrnative-{platform.machine()}-{digest}.so"


def _build() -> tuple[pathlib.Path, float]:
    """(the library's path, g++'s seconds — 0.0 when a build was reused)."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [_gxx(), *GXX_FLAGS, "-o", str(tmp), str(_SRC)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed (exit {proc.returncode}) building the native host "
            f"scanner:\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    build_seconds = time.perf_counter() - t0
    os.replace(tmp, out)  # atomic: a concurrent process never sees half a file
    return out, build_seconds


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises without g++."""
    global _lib, _lib_path
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        path, seconds = _build()
        t_built = time.perf_counter()
        lib = ctypes.CDLL(str(path))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.mr_scan_unique.restype = ctypes.c_int64
        lib.mr_scan_unique.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, u8p, i64p, u32p, u32p, ctypes.c_int64,
        ]
        lib.mr_normalize.restype = ctypes.c_int64
        lib.mr_normalize.argtypes = [ctypes.c_char_p, ctypes.c_int64, u8p, u8p]
        lib.mr_scan_count.restype = ctypes.c_int64
        lib.mr_scan_count.argtypes = [
            u8p, ctypes.c_int64, u8p, u8p, i64p, u32p, u32p, u32p, ctypes.c_int64,
        ]
        lib.mr_scan_count_sharded.restype = ctypes.c_int64
        lib.mr_scan_count_sharded.argtypes = [
            u8p, ctypes.c_int64, u8p, ctypes.c_int64, u8p, i64p, u32p, u32p,
            u32p, i64p, i64p, ctypes.c_int64,
        ]
        lib.mr_coalesce_updates.restype = ctypes.c_int64
        lib.mr_coalesce_updates.argtypes = [
            u64p, i64p, ctypes.c_int64, u64p, i64p, ctypes.c_int64, u64p, i64p,
        ]
        lib.mr_merge_runs.restype = ctypes.c_int64
        lib.mr_merge_runs.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), i64p, ctypes.c_int64, i64p, u64p,
            ctypes.POINTER(ctypes.c_int32), i64p, ctypes.c_int64,
        ]
        _lib, _lib_path = lib, path
        # The first load in this process is a kernel-build record, as
        # ops/cuda_build's libraries are: g++'s run, or the reused load.
        if seconds:
            record_build("g++", _SRC.name, "miss", t_built - seconds, t_built)
        else:
            record_build("g++", _SRC.name, "hit", t0, time.perf_counter())
        return lib


def loaded_path() -> pathlib.Path:
    """The file the library was loaded from (loads it if needed)."""
    get_lib()
    return _lib_path


_cpclass_arr: np.ndarray | None = None


def _cpclass() -> np.ndarray:
    """uint8[0x110000] codepoint classes (0 delete / 1 word / 2 space),
    built ONCE from the rules core/normalize.normalize_python uses (re \\w
    + str.isspace) and cached in the build directory, keyed by the Unicode
    table version — the C normalizer is table-driven, so its semantics are
    those of the Python path by definition."""
    global _cpclass_arr
    if _cpclass_arr is not None:
        return _cpclass_arr
    import re
    import unicodedata

    cache = BUILD_DIR / f"cpclass-{unicodedata.unidata_version}.npy"
    if cache.exists():
        try:
            arr = np.load(cache)
            if arr.shape == (0x110000,) and arr.dtype == np.uint8:
                _cpclass_arr = arr
                return arr
        except (OSError, ValueError):
            pass  # a torn or foreign file: rebuild below
    cls = np.zeros(0x110000, dtype=np.uint8)
    everything = "".join(map(chr, range(0x80, 0x110000)))
    for ch in re.findall(r"\w", everything, re.UNICODE):
        cls[ord(ch)] = 1
    for i, ch in enumerate(everything):
        if cls[i + 0x80] == 0 and ch.isspace():
            cls[i + 0x80] = 2
    _cpclass_arr = cls
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = cache.with_name(f".{cache.stem}.{os.getpid()}.tmp.npy")
        np.save(tmp, cls)
        os.replace(tmp, cache)
    except OSError:
        pass  # the table is rebuilt next process; nothing else depends on it
    return _cpclass_arr


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def normalize_native(data: bytes) -> bytes:
    """One-pass C normalization of raw UTF-8 (byte-exact against
    core/normalize.normalize_python; tests/test_torch_native.py)."""
    lib = get_lib()
    out = np.empty(max(len(data), 1), dtype=np.uint8)
    n = lib.mr_normalize(data, len(data), _u8p(_cpclass()), _u8p(out))
    return out[: int(n)].tobytes()


_scratch = threading.local()

# Arena accounting: one scratch arena per scan thread, so the host-map
# engine's memory scales with its worker count, not with the corpus.
# Entries are keyed by the words buffer and removed by a weakref finalizer
# when the arena is collected (a dead thread frees its thread-locals), so
# the gauge tracks live arenas only.
_arena_lock = threading.Lock()
_arena_sizes: dict[int, int] = {}


def _arena_release(key: int) -> None:
    with _arena_lock:
        _arena_sizes.pop(key, None)


def arena_bytes() -> int:
    """Total bytes of live per-thread scan scratch arenas in this process."""
    with _arena_lock:
        return sum(_arena_sizes.values())


def arena_count() -> int:
    """How many threads currently hold a scan scratch arena."""
    with _arena_lock:
        return len(_arena_sizes)


_sanitize_cached: "bool | None" = None


def _sanitizing() -> bool:
    """MR_SANITIZE resolved once per process — _buffers is per-scan hot."""
    global _sanitize_cached
    if _sanitize_cached is None:
        from mapreduce_rust_tpu_torch.analysis.sanitize import sanitize_enabled

        _sanitize_cached = sanitize_enabled()
    return _sanitize_cached


def _buffers(n: int, max_words: int):
    """Per-thread reusable scratch (allocating ~10 MB of numpy buffers per
    call costs ~40% of the scan; results are copied out before the next
    call on the same thread can overwrite them)."""
    bufs = getattr(_scratch, "bufs", None)
    if bufs is not None and _sanitizing():
        # Thread-locals survive os.fork(): a child reusing the parent's
        # arena would read another process's scan state. The sanitizer
        # turns that silent aliasing into a raise.
        from mapreduce_rust_tpu_torch.analysis.sanitize import check_arena_owner

        check_arena_owner(*_scratch.owner)
    if bufs is None or bufs[0].size < n + 1 or bufs[1].size < max_words:
        words = max(max_words, 1 << 18)
        bufs = (
            np.empty(max(n + 1, 1 << 20), dtype=np.uint8),
            np.empty(words, dtype=np.int64),
            np.empty(words, dtype=np.uint32),
            np.empty(words, dtype=np.uint32),
            np.empty(words, dtype=np.uint32),
            # grouped → scan position map of the sharded scan
            np.empty(words, dtype=np.int64),
        )
        key = id(bufs[0])
        with _arena_lock:
            _arena_sizes[key] = sum(int(b.nbytes) for b in bufs)
        weakref.finalize(bufs[0], _arena_release, key)
        _scratch.bufs = bufs
        _scratch.owner = (os.getpid(), threading.get_ident())
    return bufs


def _as_u8(data: "bytes | np.ndarray") -> np.ndarray:
    buf = data if isinstance(data, np.ndarray) else np.frombuffer(data, dtype=np.uint8)
    return np.ascontiguousarray(buf, dtype=np.uint8)  # views stay zero-copy


def _check_count(count: int, fn: str) -> int:
    # max_words = n//2 + 2 bounds the uniques of n bytes; a negative count
    # would mean the C side disagrees with that bound.
    if count < 0:
        raise RuntimeError(f"{fn}: unique-word buffer overflow")
    return int(count)


def scan_count_raw(
    data: "bytes | np.ndarray",
) -> tuple[bytes, np.ndarray, np.ndarray, np.ndarray]:
    """(concatenated unique words, int64[n] end offsets, uint32[n,2] hash
    pairs, uint32[n] occurrence counts) over RAW un-normalized UTF-8 — the
    fused one-pass map of the host-map engine: normalize → scan_unique_raw
    plus per-word counting, byte for byte. Accepts bytes or a uint8 numpy
    view (a memory-mapped window), which is read in place."""
    empty = (
        b"",
        np.empty(0, dtype=np.int64),
        np.empty((0, 2), dtype=np.uint32),
        np.empty(0, dtype=np.uint32),
    )
    lib = get_lib()
    buf = _as_u8(data)
    n = int(buf.size)
    if n == 0:
        return empty
    max_words = n // 2 + 2
    words_buf, ends, k1, k2, counts, _pos = _buffers(n, max_words)
    count = _check_count(lib.mr_scan_count(
        _u8p(buf), n, _u8p(_cpclass()), _u8p(words_buf),
        ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        k1.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        k2.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        max_words,
    ), "mr_scan_count")
    if not count:
        return empty
    raw = words_buf[: int(ends[count - 1])].tobytes()
    return (
        raw,
        ends[:count].copy(),
        np.stack([k1[:count], k2[:count]], axis=1),
        counts[:count].copy(),
    )


def scan_count_sharded_raw(
    data: "bytes | np.ndarray", n_shards: int,
) -> tuple[bytes, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Sharded fused scan: like :func:`scan_count_raw`, but the unique-word
    outputs come back GROUPED by fold shard (runtime/dictionary
    .shard_of_packed, scan order kept within a shard), plus

    - ``pos``          int64[n] — original scan index of grouped word i
      (the dispatch plane scatters keys/counts back to exact scan order,
      keeping the device merge stream that of the unsharded scan);
    - ``shard_counts`` int64[n_shards] — uniques per shard, so shard s's
      rows are [cum[s], cum[s+1]) and its word bytes one contiguous span."""
    lib = get_lib()
    shard_counts = np.zeros(max(int(n_shards), 1), dtype=np.int64)
    empty = (
        b"",
        np.empty(0, dtype=np.int64),
        np.empty((0, 2), dtype=np.uint32),
        np.empty(0, dtype=np.uint32),
        np.empty(0, dtype=np.int64),
        shard_counts,
    )
    buf = _as_u8(data)
    n = int(buf.size)
    if n == 0:
        return empty
    max_words = n // 2 + 2
    words_buf, ends, k1, k2, counts, pos = _buffers(n, max_words)
    count = _check_count(lib.mr_scan_count_sharded(
        _u8p(buf), n, _u8p(_cpclass()), int(n_shards), _u8p(words_buf),
        ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        k1.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        k2.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        shard_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        max_words,
    ), "mr_scan_count_sharded")
    if not count:
        return empty
    raw = words_buf[: int(ends[count - 1])].tobytes()
    return (
        raw,
        ends[:count].copy(),
        np.stack([k1[:count], k2[:count]], axis=1),
        counts[:count].copy(),
        pos[:count].copy(),
        shard_counts,
    )


def coalesce_updates_into(a_keys, a_vals, m: int, b_keys, b_vals,
                          out_keys, out_vals) -> int:
    """Staging combine (loader.cpp ``mr_coalesce_updates``): merge the
    sorted unique-key column ``a[:m]`` with the sorted unique-key column
    ``b`` into caller-owned ``out_*`` (capacity >= m + len(b)), summing
    counts on duplicate keys. Arrays are contiguous uint64 keys / int64
    counts, and ``out_*`` must not alias an input (the dispatch plane
    ping-pongs two staging buffers). Returns the merged count."""
    for name, arr, dtype in (("a_keys", a_keys, np.uint64), ("a_vals", a_vals, np.int64),
                             ("b_keys", b_keys, np.uint64), ("b_vals", b_vals, np.int64),
                             ("out_keys", out_keys, np.uint64),
                             ("out_vals", out_vals, np.int64)):
        if arr.dtype != dtype or not arr.flags.c_contiguous:
            raise ValueError(f"coalesce_updates_into: {name} must be contiguous {dtype}")
    n = len(b_keys)
    if len(b_vals) != n or m > min(len(a_keys), len(a_vals)) \
            or min(len(out_keys), len(out_vals)) < m + n:
        raise ValueError("coalesce_updates_into: inconsistent lengths")
    lib = get_lib()
    return int(lib.mr_coalesce_updates(
        a_keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        a_vals.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        int(m),
        b_keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        b_vals.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        out_keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out_vals.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    ))


def merge_runs_stream(key_arrays, block: int = 1 << 16):
    """Generator of (keys uint64[b], src int32[b], idx int64[b]) blocks
    merged over K sorted key-disjoint uint64 columns — the native
    loser-tree merge (loader.cpp ``mr_merge_runs``) the spill tiers'
    egress streams through. O(block) memory however long the runs are
    (columns may be memory maps: they are read sequentially)."""
    lib = get_lib()
    arrays = [np.ascontiguousarray(a, dtype=np.uint64) for a in key_arrays]
    k = len(arrays)

    def gen():
        ptrs = (ctypes.c_void_p * k)(*[a.ctypes.data for a in arrays])
        lens = np.asarray([len(a) for a in arrays], dtype=np.int64)
        cursors = np.zeros(k, dtype=np.int64)
        out_keys = np.empty(block, dtype=np.uint64)
        out_src = np.empty(block, dtype=np.int32)
        out_idx = np.empty(block, dtype=np.int64)
        while True:
            n = int(lib.mr_merge_runs(
                ptrs,
                lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                k,
                cursors.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                out_keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                out_src.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                out_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                block,
            ))
            if n <= 0:
                return
            # Copies: the kernel reuses the out buffers next call, and the
            # consumer may hold a block across iterations.
            yield out_keys[:n].copy(), out_src[:n].copy(), out_idx[:n].copy()

    return gen()


def scan_unique_raw(data: bytes) -> tuple[bytes, np.ndarray, np.ndarray]:
    """(concatenated unique words, int64[n] exclusive end offsets,
    uint32[n,2] hash pairs) of NORMALIZED bytes. One C pass: tokenize,
    dedupe, hash. The caller slices individual words lazily
    (runtime/dictionary.py slices only keys it hasn't seen)."""
    lib = get_lib()
    if not data:
        return b"", np.empty(0, dtype=np.int64), np.empty((0, 2), dtype=np.uint32)
    n = len(data)
    max_words = n // 2 + 2
    words_buf, ends, k1, k2, _counts, _pos = _buffers(n, max_words)
    count = _check_count(lib.mr_scan_unique(
        data, n, _u8p(words_buf),
        ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        k1.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        k2.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        max_words,
    ), "mr_scan_unique")
    raw = words_buf[: int(ends[count - 1])].tobytes() if count else b""
    return raw, ends[:count].copy(), np.stack([k1[:count], k2[:count]], axis=1)

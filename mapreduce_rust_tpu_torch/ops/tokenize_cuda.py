"""The segmented token-hash scan: the CUDA kernel's wrappers and their plain
PyTorch versions.

Replaces the Pallas TPU kernel
``mapreduce_rust_tpu/ops/tokenize_pallas.py::hash_scan_pallas`` together
with the token-end epilogue that XLA fuses around it
(``mapreduce_rust_tpu/ops/tokenize.py::_tokenize``). ``csrc/hash_scan.cu``
has two entries, one kernel launch each (a single pass with decoupled
look-back, see the source's header):

- :func:`hash_scan`: for a uint8 chunk of N bytes, the inclusive segmented
  scan of the token-hash monoid at every byte, ``(h1 int32[N], h2
  int32[N], word_char_count int32[N])``, the hash lanes as uint32 bit
  patterns. Plain version: :func:`hash_scan_reference`, a Hillis–Steele
  scan in int32 torch ops over the same six lanes, whose multiplies wrap
  exactly like uint32.
- :func:`tokenize_hash`: the same scan with the epilogue fused in, ``(k1,
  k2, value, valid)`` as ``ops/tokenize.tokenize_and_hash`` returns them.
  Plain version: :func:`tokenize_hash_reference`, the epilogue in torch
  ops over :func:`hash_scan_reference`.

Each wrapper launches the kernel on a CUDA tensor and counts the launch in
its ``launches`` attribute (under a lock: several workers of one process
launch from their own threads); on a CPU tensor it returns its plain version.
A CUDA graph that holds the fused entry (runtime/step_graph.py) is built
under :func:`uncounted`, and each replay counts its launch with
:func:`count_launch`, so ``tokenize_hash.launches`` counts the chunks
scanned either way.
Any other input raises; nothing falls back. The CPU path and the tests use
the plain versions; on the card they are only the kernel's check.

Both entries are bound by device-memory bytes, 1 read and 12 (hash_scan)
or 13 (tokenize_hash) written per input byte.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading

import numpy as np
import torch

from mapreduce_rust_tpu_torch.core.hashing import H1_INIT, H1_MULT, H2_INIT, H2_MULT
from mapreduce_rust_tpu_torch.core.kv import SENTINEL_I32
from mapreduce_rust_tpu_torch.ops.cuda_build import load_library

SOURCE = "hash_scan.cu"
#: The TPU kernel this replaces (the function that reaches pl.pallas_call).
REPLACES = "mapreduce_rust_tpu/ops/tokenize_pallas.py:150"
#: Device-memory bytes per input byte: hash_scan, tokenize_hash.
BYTES_PER_INPUT_BYTE = 13
FUSED_BYTES_PER_INPUT_BYTE = 14
#: Bytes one block of the kernel scans (checked against the library).
TILE_BYTES = 4096


_count_lock = threading.Lock()
_muted = threading.local()  # .on: this thread's wrapper calls are not counted


@contextlib.contextmanager
def uncounted():
    """Wrapper calls on this thread inside the block count no launch: a
    graph's warm-up scans no chunk, and its capture launches nothing."""
    _muted.on = True
    try:
        yield
    finally:
        _muted.on = False


def count_launch() -> None:
    """Count one launch of the fused entry: the wrapper's own, or one a
    graph replay made."""
    with _count_lock:
        tokenize_hash.launches += 1


def _i32(x) -> int:
    """A uint32 constant as the int32 bit pattern torch lanes hold."""
    return int(np.uint32(x).view(np.int32))


_H1_MULT, _H1_INIT = _i32(H1_MULT), _i32(H1_INIT)
_H2_MULT, _H2_INIT = _i32(H2_MULT), _i32(H2_INIT)


def byte_classes(chunk: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(is_whitespace, is_word_char) bool masks of a uint8 chunk, computed
    arithmetically — exactly core/hashing.byte_class_tables' rules."""
    c = chunk.to(torch.int32)
    is_ws = (c == 32) | ((c >= 9) & (c <= 13))
    lower = c | 32
    is_wc = (
        ((lower >= ord("a")) & (lower <= ord("z")) & (c < 128))
        | ((c >= ord("0")) & (c <= ord("9")))
        | (c == ord("_"))
        | (c >= 128)
    )
    return is_ws, is_wc


def hash_scan_reference(chunk: torch.Tensor):
    """Plain PyTorch version of the scan: (h1, h2, cnt), all int32[N]."""
    if chunk.dtype != torch.uint8 or chunk.dim() != 1:
        raise ValueError(f"hash_scan wants a 1-D uint8 tensor, got {chunk.dtype}"
                         f"[{tuple(chunk.shape)}]")
    is_ws, is_wc = byte_classes(chunk)
    wc = is_wc.to(torch.int32)
    cp1 = chunk.to(torch.int32) + 1
    f = is_ws
    m1 = 1 + wc * (_H1_MULT - 1)
    m2 = 1 + wc * (_H2_MULT - 1)
    a1 = wc * cp1
    a2 = a1
    cnt = wc
    n = chunk.numel()
    d = 1
    while d < n:
        # Position i combines (i - d) then i; the first d positions keep
        # their value (combine with the identity).
        fy = f[d:]
        m1n = torch.where(fy, m1[d:], m1[:-d] * m1[d:])
        a1n = torch.where(fy, a1[d:], a1[:-d] * m1[d:] + a1[d:])
        m2n = torch.where(fy, m2[d:], m2[:-d] * m2[d:])
        a2n = torch.where(fy, a2[d:], a2[:-d] * m2[d:] + a2[d:])
        cn = torch.where(fy, cnt[d:], cnt[:-d] + cnt[d:])
        f = torch.cat([f[:d], f[:-d] | fy])
        m1 = torch.cat([m1[:d], m1n])
        a1 = torch.cat([a1[:d], a1n])
        m2 = torch.cat([m2[:d], m2n])
        a2 = torch.cat([a2[:d], a2n])
        cnt = torch.cat([cnt[:d], cn])
        d *= 2
    return _H1_INIT * m1 + a1, _H2_INIT * m2 + a2, cnt


def tokenize_hash_reference(chunk: torch.Tensor, last_is_boundary: bool = True):
    """Plain PyTorch version of the fused entry: (k1 int32, k2 int32, value
    int32, valid bool), all [N]. A token ends at a non-whitespace byte
    followed by whitespace (or by the chunk's end, when
    ``last_is_boundary``) after at least one word char; every other slot
    is SENTINEL padding with value 0."""
    h1, h2, cnt = hash_scan_reference(chunk)
    is_ws, _ = byte_classes(chunk)
    last = torch.full((1,), last_is_boundary, dtype=torch.bool, device=chunk.device)
    next_is_ws = torch.cat([is_ws[1:], last])
    valid = ~is_ws & next_is_ws & (cnt > 0)
    return (torch.where(valid, h1, SENTINEL_I32), torch.where(valid, h2, SENTINEL_I32),
            valid.to(torch.int32), valid)


_lib_lock = threading.Lock()


def _lib() -> ctypes.CDLL:
    """The kernel library, built and checked once per process (the lock
    keeps concurrent first launches from building it twice)."""
    with _lib_lock:
        return _load_lib()


@functools.lru_cache(maxsize=None)
def _load_lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    lib.mr_hash_scan.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_void_p]
    lib.mr_hash_scan.restype = ctypes.c_int
    lib.mr_tokenize_hash.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.mr_tokenize_hash.restype = ctypes.c_int
    lib.mr_hash_scan_scratch_bytes.argtypes = [ctypes.c_longlong]
    lib.mr_hash_scan_scratch_bytes.restype = ctypes.c_longlong
    lib.mr_hash_scan_tile_bytes.argtypes = []
    lib.mr_hash_scan_tile_bytes.restype = ctypes.c_longlong
    if lib.mr_hash_scan_tile_bytes() != TILE_BYTES:
        raise RuntimeError(f"{SOURCE} scans {lib.mr_hash_scan_tile_bytes()}-byte "
                           f"tiles, TILE_BYTES says {TILE_BYTES}")
    return lib


def _launch(name: str, chunk: torch.Tensor, dtypes, *args) -> tuple[torch.Tensor, ...]:
    """Checks a CUDA chunk, allocates one output of each dtype and the
    scratch, and launches entry ``mr_<name>`` on the current stream."""
    if chunk.dtype != torch.uint8 or chunk.dim() != 1 or chunk.numel() < 1:
        raise ValueError(f"{name} wants a non-empty 1-D uint8 tensor, got "
                         f"{chunk.dtype}[{tuple(chunk.shape)}]")
    if not chunk.is_contiguous() or chunk.data_ptr() % 16:
        raise ValueError(f"{name} wants a contiguous, 16-byte aligned chunk")
    lib = _lib()
    n, dev = chunk.numel(), chunk.device
    outs = tuple(torch.empty(n, dtype=dt, device=dev) for dt in dtypes)
    scratch = torch.empty(lib.mr_hash_scan_scratch_bytes(n), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"mr_{name}")(
            chunk.data_ptr(), *(o.data_ptr() for o in outs), scratch.data_ptr(), n,
            *args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return outs


def _on_card(name: str, chunk: torch.Tensor) -> bool:
    """False for a CPU chunk (the plain version runs), True for a CUDA
    chunk (the kernel runs); anything else raises."""
    if chunk.device.type == "cpu":
        return False
    if chunk.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {chunk.device}")
    return True


def hash_scan(chunk: torch.Tensor):
    """(h1, h2, cnt) int32[N] of a uint8[N] chunk: the CUDA kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    if not _on_card("hash_scan", chunk):
        return hash_scan_reference(chunk)
    outs = _launch("hash_scan", chunk, (torch.int32,) * 3)
    with _count_lock:
        hash_scan.launches += 1
    return outs


hash_scan.launches = 0  # wrapper calls that launched the kernel


def tokenize_hash(chunk: torch.Tensor, last_is_boundary: bool = True):
    """(k1, k2, value, valid) of a uint8[N] chunk, as tokenize_and_hash
    returns them: the CUDA kernel's fused entry on a CUDA tensor, the plain
    version on a CPU tensor."""
    if not _on_card("tokenize_hash", chunk):
        return tokenize_hash_reference(chunk, last_is_boundary)
    outs = _launch("tokenize_hash", chunk, (torch.int32,) * 3 + (torch.bool,),
                   int(bool(last_is_boundary)))
    if not getattr(_muted, "on", False):
        count_launch()
    return outs


tokenize_hash.launches = 0  # wrapper calls that launched the kernel

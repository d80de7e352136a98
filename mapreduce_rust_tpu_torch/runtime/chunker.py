"""Host-side ingest: files → fixed-shape, whitespace-aligned byte chunks.

The port's copy of ``mapreduce_rust_tpu/runtime/chunker.py``. Each file is normalized (core/normalize.py) and streamed as
uint8 chunks of exactly ``chunk_bytes``, space-padded, cut at whitespace
so no token straddles a chunk edge and per-chunk counts sum exactly to
whole-corpus counts. A token longer than ``chunk_bytes`` is force-split
and counted in ``Chunk.forced_cut``. Normalization and chunking run over a
bounded sliding window, so peak host memory is O(window), not O(file).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Sequence

import numpy as np

from mapreduce_rust_tpu_torch.core.hashing import WHITESPACE_BYTES
from mapreduce_rust_tpu_torch.core.normalize import normalize_unicode

_ASCII_WS = frozenset(WHITESPACE_BYTES)


@dataclasses.dataclass(frozen=True)
class Chunk:
    """One device-ready chunk: uint8[chunk_bytes], space padded."""

    doc_id: int  # input file index
    seq: int  # chunk index within the document
    data: np.ndarray  # uint8[chunk_bytes]
    nbytes: int  # real payload length before padding
    forced_cut: bool = False  # True: chunk END was cut mid-token


def _ws_cut(data: bytes, start: int, end: int) -> tuple[int, bool]:
    """Largest cut <= end with data[cut-1] whitespace; (end, True) if none."""
    cut = end
    while cut > start and data[cut - 1] not in _ASCII_WS:
        cut -= 1
    if cut == start:
        return end, True
    return cut, False


def utf8_safe_cut(data: bytes, cut: int) -> int:
    """Largest cut' <= cut that does not split a UTF-8 sequence: back off
    past trailing continuation bytes and their lead byte."""
    while cut > 1 and (data[cut - 1] & 0xC0) == 0x80:
        cut -= 1
    if cut > 1 and data[cut - 1] >= 0xC0:
        cut -= 1
    return cut


def split_points(data: bytes, chunk_bytes: int) -> list[tuple[int, int, bool]]:
    """(start, end, forced) payload spans, each <= chunk_bytes, cut after
    the last whitespace byte of each window; ``forced`` marks mid-token
    cuts (a token longer than chunk_bytes)."""
    spans = []
    n = len(data)
    start = 0
    while start < n:
        end = min(start + chunk_bytes, n)
        forced = False
        if end < n:
            end, forced = _ws_cut(data, start, end)
        spans.append((start, end, forced))
        start = end
    return spans


def _emit(data: bytes, start: int, end: int, forced: bool, doc_id: int, seq: int,
          chunk_bytes: int) -> Chunk:
    buf = np.full(chunk_bytes, 0x20, dtype=np.uint8)
    buf[: end - start] = np.frombuffer(data[start:end], dtype=np.uint8)
    return Chunk(doc_id=doc_id, seq=seq, data=buf, nbytes=end - start, forced_cut=forced)


def chunk_stream(
    f,
    doc_id: int,
    chunk_bytes: int,
    window_bytes: int | None = None,
) -> Iterator[Chunk]:
    """Stream one document from a binary file object, one window at a time.

    Each ~window_bytes read is cut at ASCII whitespace — safe before
    normalization because normalize_unicode never alters ASCII bytes. The
    raw tail past the cut and the trailing partial chunk carry into the
    next read, so emitted chunks are identical to whole-file processing.
    """
    window = window_bytes or max(chunk_bytes * 8, 1 << 24)
    seq = 0
    pending = b""    # normalized bytes whose chunk cut isn't final yet
    raw_carry = b""  # raw bytes past the window's whitespace cut
    while True:
        piece = f.read(window)
        at_eof = not piece
        buf = raw_carry + piece
        raw_carry = b""
        if not at_eof and buf:
            cut, forced_window = _ws_cut(buf, 0, len(buf))
            if forced_window:
                # No whitespace in the whole window: cut at a UTF-8 sequence
                # boundary so per-window normalization matches whole-file.
                cut = utf8_safe_cut(buf, cut)
            raw_carry = buf[cut:]
            buf = buf[:cut]
        data = pending + normalize_unicode(buf)
        pending = b""
        spans = split_points(data, chunk_bytes)
        if not at_eof and spans:
            # The last span's cut isn't final until the next bytes are known.
            *spans, last = spans
            pending = data[last[0]:]
        for start, end, forced in spans:
            yield _emit(data, start, end, forced, doc_id, seq, chunk_bytes)
            seq += 1
        if at_eof:
            return


def list_inputs(input_dir: str, pattern: str = "*.txt") -> list[str]:
    """Sorted input file list — the doc_id ordering contract."""
    import glob

    return sorted(glob.glob(os.path.join(input_dir, pattern)))


def parse_input_spec(values: Sequence[str]):
    """The CLI's ``--input`` forms → (input_dir, input_dirs) (reference
    ``chunker.py:201-236``):

    - ``--input DIR`` — the classic single corpus: (DIR, None). ONE value
      is always this form, '=' in the path included;
    - ``--input a=DIR b=DIR`` — N (>= 2) named corpora, sorted by name
      (``a=X b=Y`` and ``b=Y a=X`` are the same job): (first dir, sorted
      ((name, dir), ...)).

    Mixing the two forms, or repeating a name, is a usage error.
    """
    vals = list(values)
    if len(vals) == 1:
        return vals[0], None
    pairs = []
    for v in vals:
        name, sep, d = v.partition("=")
        if not sep or not name or not d:
            raise ValueError(
                f"multi-corpus --input wants name=DIR entries, got {v!r} "
                "(single-corpus form takes exactly one bare DIR)"
            )
        pairs.append((name, d))
    names = [n for n, _ in pairs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate corpus names in --input: {names}")
    pairs.sort()
    return pairs[0][1], tuple(pairs)


def resolve_corpora(cfg) -> tuple[list[str], tuple, tuple]:
    """Flatten the job's corpora (Config.corpora()) into the doc_id space:
    (inputs, corpus_bounds, names). ``inputs`` concatenates each corpus's
    sorted listing in corpus order, so doc ids are global over every
    corpus; ``corpus_bounds`` holds the cumulative doc counts of
    corpora[:-1], which splitter.prepare_app binds onto multi-corpus apps.
    A single corpus comes back with bounds == ()."""
    corpora = cfg.corpora()
    inputs: list[str] = []
    bounds: list[int] = []
    for _name, d in corpora:
        inputs.extend(list_inputs(d, cfg.input_pattern))
        bounds.append(len(inputs))
    names = tuple(n for n, _ in corpora)
    if len(corpora) == 1:
        return inputs, (), names
    return inputs, tuple(bounds[:-1]), names

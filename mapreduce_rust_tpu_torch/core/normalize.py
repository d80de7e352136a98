"""Host-side unicode normalization for ingest.

The port's copy of ``mapreduce_rust_tpu/core/normalize.py``.
``normalize_unicode`` runs the native one-pass C normalizer
(native/loader.cpp ``mr_normalize``, built with g++ at first use; it
raises without g++). ``normalize_python`` is the pure-Python pass that
defines the semantics and that tests/test_torch_native.py holds the native
one to, byte for byte; no production path calls it.

The reference word-count app strips ``[^\\w\\s]`` with a Unicode-aware Rust
regex and splits on Unicode whitespace (src/app/wc.rs:6-13). The device
kernel (ops/tokenize.py) classifies raw *bytes* and treats every byte
>= 0x80 as a word char, which is correct for UTF-8 letters but wrong for
non-ASCII punctuation ("don’t" must hash as "dont", an em dash must
vanish) and non-ASCII whitespace (U+00A0 must split words).

This pass runs once on the host before bytes reach the chunker: every
non-ASCII codepoint is classified with Python's unicode-aware ``re`` —

- word chars (``\\w``) are kept verbatim, so their UTF-8 bytes still read
  as word chars on the device;
- whitespace becomes an ASCII space (token boundary);
- everything else is deleted in place, which — exactly like the reference's
  regex strip — does NOT split the surrounding token.

ASCII bytes are never touched here.

Known divergence (accepted, shared with the reference package): Python's
``re`` word class excludes combining marks (``\\p{M}``) while Rust's regex
crate includes them. Invalid UTF-8 decodes to U+FFFD, which is non-word
and is deleted.
"""

from __future__ import annotations

import functools
import re

import numpy as np

_WORD_RE = re.compile(r"\w", re.UNICODE)


@functools.lru_cache(maxsize=4096)
def _classify(cp: int) -> int | None:
    """Translation entry for one non-ASCII codepoint.

    None   -> keep (word char)
    0x20   -> replace with space (whitespace)
    -1     -> delete (punctuation/symbol), encoded as '' for str.translate
    """
    ch = chr(cp)
    if _WORD_RE.match(ch):
        return None
    if ch.isspace():
        return 0x20
    return -1


def _normalize_text(text: str) -> bytes:
    """Classify-and-translate a decoded string (the full slow path)."""
    cps = np.unique(np.frombuffer(text.encode("utf-32-le"), dtype=np.uint32))
    table: dict[int, int | str | None] = {}
    for cp in cps[cps >= 0x80].tolist():
        cls = _classify(cp)
        if cls is not None:
            table[cp] = "" if cls == -1 else " "
    if not table:
        return text.encode("utf-8")
    return text.translate(table).encode("utf-8")


@functools.lru_cache(maxsize=65536)
def _normalize_run(run: bytes) -> bytes:
    """Normalize one short contiguous non-ASCII byte run. Real text repeats
    a handful of sequences (curly quotes, dashes, accented letters), so the
    cache turns per-run work into a dict hit."""
    return _normalize_text(run.decode("utf-8", errors="replace"))


_RUN_CACHE_MAX_LEN = 64


def normalize_unicode(data: bytes) -> bytes:
    """Normalize a UTF-8 byte string for the device tokenizer.

    Pure-ASCII input is returned unchanged; anything else goes through the
    native one-pass C normalizer, which is byte-exact against
    :func:`normalize_python`."""
    if data.isascii():
        return data
    from mapreduce_rust_tpu_torch.native.host import normalize_native

    return normalize_native(data)


def normalize_python(data: bytes) -> bytes:
    """The pure-Python normalization pass (the native pass's plain version).

    Only the contiguous non-ASCII byte runs are rewritten (UTF-8 lead AND
    continuation bytes are all >= 0x80, so a run always covers whole
    sequences); the ASCII spans between them are passed through by slicing.
    """
    if data.isascii():
        return data
    arr = np.frombuffer(data, dtype=np.uint8)
    idx = np.flatnonzero(arr >= 0x80)
    # Split the non-ASCII byte positions into contiguous runs.
    breaks = np.flatnonzero(np.diff(idx) > 1) + 1
    starts = np.concatenate([idx[:1], idx[breaks]])
    ends = np.concatenate([idx[breaks - 1] + 1, idx[-1:] + 1])
    parts: list[bytes] = []
    pos = 0
    for s, e in zip(starts.tolist(), ends.tolist()):
        parts.append(data[pos:s])
        run = data[s:e]
        if e - s <= _RUN_CACHE_MAX_LEN:
            parts.append(_normalize_run(run))
        else:
            parts.append(_normalize_text(run.decode("utf-8", errors="replace")))
        pos = e
    parts.append(data[pos:])
    return b"".join(parts)


def reference_word_counts(data: bytes):
    """The golden oracle: word -> count with the reference's exact semantics.

    Mirrors src/app/wc.rs:6-13 — delete ``[^\\w\\s]`` (unicode-aware, no
    token split), then split on unicode whitespace; case-sensitive. Used by
    end-to-end tests and chip_smoke.py; never by the production path.
    """
    from collections import Counter

    text = data.decode("utf-8", errors="replace")
    cleaned = re.sub(r"[^\w\s]", "", text, flags=re.UNICODE)
    return Counter(cleaned.split())

"""A frozen copy of the word key's first lane, which picks a word's output
partition: ``h <- h * 0x01000193 + (byte + 1)`` over the word's bytes from
``0x811C9DC5``, in uint32, and partition ``h % reduce_n``. The second lane
(``h * 1000003 + (byte + 1)`` from ``0x9E3779B9``) makes the 64-bit key that
tells words apart.

Copied here, not imported, so that a change of the program's hash is a
change the benchmark sees.
"""

from __future__ import annotations

import numpy as np

LANES = ((np.uint32(0x811C9DC5), np.uint32(0x01000193)),
         (np.uint32(0x9E3779B9), np.uint32(1000003)))


def word_matrix(words: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """(uint8[n, maxlen] zero-padded bytes, int64[n] lengths)."""
    lens = np.fromiter(map(len, words), dtype=np.int64, count=len(words))
    width = max(int(lens.max()) if len(words) else 1, 1)
    flat = np.frombuffer(b"".join(words), dtype=np.uint8)
    mat = np.zeros((len(words), width), dtype=np.uint8)
    rows = np.repeat(np.arange(len(words)), lens)
    cols = np.arange(len(flat)) - np.repeat(np.cumsum(lens) - lens, lens)
    mat[rows, cols] = flat
    return mat, lens


def lane(words: list[bytes], which: int = 0) -> np.ndarray:
    """Lane ``which`` (0 or 1) of every word's key, uint32[n]."""
    init, mult = LANES[which]
    mat, lens = word_matrix(words)
    h = np.full(len(words), init, dtype=np.uint32)
    with np.errstate(over="ignore"):
        for j in range(mat.shape[1]):
            live = lens > j
            h = np.where(live, h * mult + mat[:, j].astype(np.uint32) + np.uint32(1), h)
    return h


def partitions(words: list[bytes], reduce_n: int) -> np.ndarray:
    """Output partition of every word, int64[n]."""
    return lane(words, 0).astype(np.int64) % reduce_n

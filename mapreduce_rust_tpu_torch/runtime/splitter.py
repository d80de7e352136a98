"""Sampled-splitter subsystem: the cheap pre-pass that derives
deterministic range-partition splitters (the port of
``mapreduce_rust_tpu/runtime/splitter.py``).

A globally sorted output needs partition r's keys to all precede
partition r+1's, before anyone has read the corpus. The TeraSort answer
is sampling: a small, seeded sample of keys from each input, merged, and
R-1 quantiles taken as splitters.

- :func:`sample_file` — per input: a handful of evenly spaced blocks,
  normalized and tokenized with the corpus pipeline's own rules
  (core/normalize + runtime/dictionary.extract_words, so the sample space
  is the key space), edge tokens dropped, then a seeded ``random.Random``
  draw;
- :func:`derive_splitters` — the R-1 evenly spaced order statistics of
  the sorted packed-uint64 prefixes (ops/partition.pack_word_prefix):
  always real sampled keys, exact uint64;
- :func:`splitters_for_job` — the one entry point; a pure function of
  (sorted input listing, seed, split_samples), so the splitters are
  bit-identical to the reference's for the same inputs.

Skew shows in the per-partition output bytes (``JobStats.partition_bytes``);
``Config.split_samples`` is the knob.
"""

from __future__ import annotations

import dataclasses
import os
import random
import time
from typing import Sequence

import numpy as np

from mapreduce_rust_tpu_torch.ops.partition import pack_word_prefix

#: Fixed sampling seed: splitters are a pure function of the corpus and
#: the config.
SPLIT_SEED = 0x517
#: Block size and per-file block count of the sampling pre-pass.
SAMPLE_BLOCK_BYTES = 64 << 10
SAMPLE_MAX_BLOCKS = 8


def sample_file(path: str | os.PathLike, samples: int,
                seed: int = SPLIT_SEED,
                file_index: int = 0) -> list[bytes]:
    """Seeded token sample from one input file: up to SAMPLE_MAX_BLOCKS
    evenly spaced SAMPLE_BLOCK_BYTES reads, tokenized with the corpus
    pipeline's rules, first/last token of each interior block dropped
    (the block cut may clip them), then a ``random.Random((seed << 20) ^
    file_index)`` draw of ``samples`` tokens."""
    from mapreduce_rust_tpu_torch.core.normalize import normalize_unicode
    from mapreduce_rust_tpu_torch.runtime.dictionary import extract_words

    try:
        size = os.path.getsize(path)
    except OSError:
        return []
    if size <= 0:
        return []
    n_blocks = min(SAMPLE_MAX_BLOCKS,
                   max(1, size // SAMPLE_BLOCK_BYTES or 1))
    pool: list[bytes] = []
    with open(path, "rb") as f:
        for b in range(n_blocks):
            # Even spacing over the file, head and tail included.
            off = (size - SAMPLE_BLOCK_BYTES) * b // max(n_blocks - 1, 1) \
                if size > SAMPLE_BLOCK_BYTES else 0
            f.seek(max(off, 0))
            raw = f.read(SAMPLE_BLOCK_BYTES)
            if not raw:
                continue
            toks = extract_words(normalize_unicode(raw))
            if off > 0 and toks:
                toks = toks[1:]  # the head token may be a clipped fragment
            if off + len(raw) < size and toks:
                toks = toks[:-1]  # the tail token likewise
            pool.extend(toks)
    if not pool:
        return []
    # One int seed per (job seed, file), stable across interpreters.
    rng = random.Random((int(seed) << 20) ^ int(file_index))
    if len(pool) <= samples:
        return pool
    return rng.sample(pool, samples)


def corpus_samples(inputs: Sequence[str | os.PathLike],
                   samples_per_file: int,
                   seed: int = SPLIT_SEED) -> np.ndarray:
    """Merged sample over the whole sorted input listing: uint64[n] packed
    word prefixes. The file index (the doc_id order) keys each file's rng
    stream."""
    words: list[bytes] = []
    for i, path in enumerate(inputs):
        words.extend(sample_file(path, samples_per_file, seed=seed,
                                 file_index=i))
    return pack_word_prefix(words)


def derive_splitters(samples: np.ndarray, reduce_n: int) -> np.ndarray:
    """R-1 range splitters from merged packed-uint64 samples: the evenly
    spaced order statistics of the sorted sample. Returns uint64
    [reduce_n - 1]; an EMPTY sample yields all-max splitters (every key
    below the max routes to partition 0 — exact, maximally skewed)."""
    r = max(int(reduce_n), 1)
    if r == 1:
        return np.zeros(0, dtype=np.uint64)
    s = np.sort(np.asarray(samples, dtype=np.uint64))
    if not len(s):
        return np.full(r - 1, np.iinfo(np.uint64).max, dtype=np.uint64)
    idx = (np.arange(1, r, dtype=np.int64) * len(s)) // r
    return s[np.minimum(idx, len(s) - 1)]


def splitters_for_job(cfg, inputs: Sequence[str | os.PathLike]) -> np.ndarray:
    """The shared sampler entry: a seeded sample of every input, merged,
    reduced to cfg.reduce_n - 1 splitters."""
    samples = corpus_samples(inputs, cfg.split_samples)
    return derive_splitters(samples, cfg.reduce_n)


def prepare_app(app, cfg, inputs: Sequence[str | os.PathLike],
                corpus_bounds: Sequence[int] = (), stats=None):
    """Bind the job-derived partitioning state onto the app (a frozen
    dataclass, so a rebound COPY): corpus bounds for multi-corpus apps
    (join's side split) and sampled splitters for range apps (sort).
    Validates the app's corpus count here, before anything streams.
    ``stats`` (a JobStats) gets the pre-pass accounting when given."""
    bounds = tuple(int(b) for b in (corpus_bounds or ()))
    need = getattr(app, "requires_corpora", 0)
    if need and len(bounds) != need - 1:
        raise ValueError(
            f"app {app.name!r} needs exactly {need} input corpora "
            f"(got {len(bounds) + 1}); submit them as --input a=DIR b=DIR"
        )
    if getattr(app, "corpus_bounds", ()) != bounds:
        app = dataclasses.replace(app, corpus_bounds=bounds)
    if app.partition_mode == "range" \
            and len(app.splitters) != max(cfg.reduce_n - 1, 0):
        t0 = time.perf_counter()
        samples = corpus_samples(inputs, cfg.split_samples)
        spl = derive_splitters(samples, cfg.reduce_n)
        app = dataclasses.replace(
            app, splitters=tuple(int(x) for x in spl)
        )
        if stats is not None:
            stats.splitter_samples = int(len(samples))
            stats.splitter_s = time.perf_counter() - t0
    if stats is not None:
        stats.partition_mode = app.partition_mode
    return app

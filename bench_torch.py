#!/usr/bin/env python
"""End-to-end benchmark of the PyTorch/CUDA port: word-count GB/s on one
CUDA card against the CPU multi-process baseline (BASELINE.md configs 1-3).

The port's twin of ``bench.py``'s default run, with its structure and
names, so each function here has its counterpart there. It imports torch
and ``mapreduce_rust_tpu_torch`` only inside the legs, and nothing of JAX,
of ``mapreduce_rust_tpu`` or of ``bench.py``.

Prints ONE JSON line on stdout, ALWAYS (an "error" field appears on
partial failure):
    {"metric": ..., "value": N, "unit": "GB/s", "vs_baseline": N,
     "platform": "cuda", "probes": [...], ...}

Structure:
  1. corpus build (cheap, deterministic, cached in ``.bench_torch/``;
     byte-identical to ``bench.py``'s corpora at the same sizes);
  2. CPU multi-process baseline FIRST, the Rust original's architecture on
     a process pool, pure Python (median of three);
  3. the device leg in a SUBPROCESS with a hard timeout and a heartbeat
     deadline (median of three): the full ``run_job`` path on the card;
  4. the micro leg (host-to-device rate, map_combine and step ms per MB),
     the Zipf leg (exact against the generator's counts) and the metrics,
     profiler and lineage overhead legs, each its own subprocess;
  5. the doctor over the measured leg's run manifest, a bench manifest and
     one line of ``.bench_torch/history.jsonl``.

Where it differs from ``bench.py``:
- ``BENCH_MAP_ENGINE`` defaults to ``device``, the port's Config default
  and main path, which launches the CUDA scan kernel ``tokenize_hash``
  once per chunk (``bench.py`` defaults to ``host``); ``host`` stays
  available by name. Every leg runs the engine it names, on the card: the
  overhead and sort legs too, which ``bench.py`` runs on CPU-XLA.
- No fallback. When the device leg fails, the line still prints, with
  ``value`` null and ``error`` naming the failure, and the process exits
  1. A leg runs on the CPU only when the caller sets ``BENCH_DEVICE=cpu``
  (the tests do), which the line then reports as ``platform: "cpu"``.
- Each leg prints ``BENCH_DEVICE_READY cuda <card name>`` on stderr as
  soon as ``select_device`` has initialized the card.
- ``BENCH_DEVICE_RUNS`` (default 3: the median of three) and
  ``BENCH_OVERHEAD_RUNS`` (default 15 per side) set the depth of the
  device leg's median and of the overhead pairs; a smoke run lowers them.
- ``BENCH_DIR`` (default ``.bench_torch/`` beside this file) holds the
  corpora, outputs, manifests and history; ``.bench/`` stays the JAX
  package's. The corpus is the synthetic one: ``bench.py`` builds it from
  the Rust original's ``gut-*.txt`` where that data directory exists, and
  in this repo, which does not hold it, from the same synthetic seed.

Also: ``--sort-leg`` (global sort over the Zipf corpus, exact and ordered)
and ``--zipf-ii MB`` (inverted index over an 8-document Zipf corpus, exact
against the presence matrix), each printing its own JSON line.
``bench.py``'s other modes (the service leg, chaos, the sweeps, the
dispatch A/B, the model leg) are not ported yet.
"""

from __future__ import annotations

import collections
import json
import multiprocessing
import os
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
BENCH_DIR = pathlib.Path(os.environ.get("BENCH_DIR") or REPO / ".bench_torch")
TARGET_MB = int(os.environ.get("BENCH_TARGET_MB", "512"))  # big enough that
# one-time costs (state fetch, finalize, egress) amortize into the rate
BASELINE_MB = int(os.environ.get("BENCH_BASELINE_MB", "64"))
DEVICE_TIMEOUT_S = int(os.environ.get("BENCH_DEVICE_TIMEOUT_S", "300"))
# Deadline for the device leg's BENCH_DEVICE_READY heartbeat (torch import
# and CUDA init), NOT for the run — see _run_device_leg.
PROBE_TIMEOUT_S = int(os.environ.get("BENCH_PROBE_TIMEOUT_S", "90"))
#: Where every leg runs: the card, unless the caller asks for the CPU.
DEVICE = os.environ.get("BENCH_DEVICE", "cuda")
DEVICE_RUNS = int(os.environ.get("BENCH_DEVICE_RUNS", "3"))
OVERHEAD_RUNS = int(os.environ.get("BENCH_OVERHEAD_RUNS", "15"))

_WS = b" \t\n\r\x0b\x0c"


def _map_engine() -> str:
    return os.environ.get("BENCH_MAP_ENGINE", "device")


def _env_host_workers() -> "int | None":
    """BENCH_HOST_WORKERS (None = Config auto: usable cores minus the
    consumer's)."""
    v = os.environ.get("BENCH_HOST_WORKERS")
    return int(v) if v else None


def _env_fold_shards() -> "int | None":
    """BENCH_FOLD_SHARDS (None = Config auto: 1 below 4 usable cores, else
    min(4, cores//2))."""
    v = os.environ.get("BENCH_FOLD_SHARDS")
    return int(v) if v else None


def build_corpus(target_mb: int) -> pathlib.Path:
    """The synthetic corpus of ``target_mb`` MB or more, byte for byte
    ``bench.py``'s where the Rust original's data is absent, as in this
    repo: one seed of 2M words over a 100,000-word vocabulary, repeated."""
    out = BENCH_DIR / f"corpus-{target_mb}mb.txt"
    if out.exists() and out.stat().st_size >= target_mb << 20:
        return out
    BENCH_DIR.mkdir(parents=True, exist_ok=True)
    import random

    rng = random.Random(0)
    seed = (" ".join(f"w{rng.randrange(100000)}" for _ in range(2_000_000))).encode()
    try:
        with open(out, "wb") as f:
            written = 0
            while written < target_mb << 20:
                f.write(seed)
                f.write(b"\n")
                written += len(seed) + 1
    except BaseException:
        # Unlink the partial file: an interrupted loop that had already
        # crossed the target size would satisfy the >= check of a later
        # same-size run with a torn tail.
        try:
            out.unlink()
        except OSError:
            pass
        raise
    return out


ZIPF_VOCAB = 1 << 21   # 2M distinct tokens — BASELINE.json config 2 class
ZIPF_S = 1.05          # exponent: heavy head, massive distinct tail


def _atomic_np_save(path: pathlib.Path, arr) -> None:
    """Commit a ground-truth array atomically (tmp + rename), cleaning the
    tmp on failure — shared by both high-cardinality legs."""
    import numpy as np

    tmp = path.with_suffix(".npy.tmp")
    try:
        with open(tmp, "wb") as f:
            np.save(f, arr)
        os.replace(tmp, path)
    except BaseException:
        try:
            tmp.unlink()
        except OSError:
            pass
        raise


def _zipf_cfg(work: str, out: str, reduce_n: int):
    """THE budgets-engaged config both high-cardinality legs (and sort)
    run under — bench.py's field for field, on the engine BENCH_MAP_ENGINE
    names and on the card."""
    from mapreduce_rust_tpu_torch.config import Config

    budget = int(os.environ.get("BENCH_SPILL_BUDGET_WORDS") or (1 << 19))
    fill = float(os.environ.get("BENCH_DISPATCH_FILL") or 0.5)
    coalesce = os.environ.get("BENCH_DISPATCH_COALESCE", "1") != "0"
    return Config(
        dispatch_fill_frac=fill,
        dispatch_coalesce=coalesce,
        map_engine=_map_engine(),
        host_map_workers=_env_host_workers(),
        fold_shards=_env_fold_shards(),
        host_window_bytes=16 << 20,
        chunk_bytes=1 << 20,
        merge_capacity=1 << 18,        # << the Zipf vocab: constant eviction
        host_accum_budget_mb=256,      # spill-run tier engaged
        dictionary_budget_words=budget,  # dictionary tier engaged
        reduce_n=reduce_n,
        work_dir=str(BENCH_DIR / work),
        output_dir=str(BENCH_DIR / out),
        device=DEVICE,
        # A per-leg run manifest when the caller asks for one; a distinct
        # env var from the device leg's, so this leg never clobbers the
        # measured leg's manifest.
        manifest_path=os.environ.get("BENCH_ZIPF_RUN_MANIFEST") or None,
    )


def _zipf_sampler(vocab: int, s: float):
    """(cdf, token_table) — THE shared inverse-CDF Zipf sampler both
    high-cardinality legs draw from. Token rank r is the fixed 8-byte
    b'w%06x '."""
    import numpy as np

    weights = 1.0 / np.arange(1, vocab + 1, dtype=np.float64) ** s
    cdf = np.cumsum(weights)
    cdf /= cdf[-1]
    table = np.frombuffer(
        b"".join(b"w%06x " % r for r in range(vocab)), dtype=np.uint8
    ).reshape(vocab, 8)
    return cdf, table


def _write_zipf_tokens(f, rng, cdf, table, n_tokens: int, on_block) -> None:
    """Stream n_tokens sampled tokens into f in 4M-token blocks;
    on_block(ranks) records the generator-side ground truth."""
    import numpy as np

    left = n_tokens
    while left > 0:
        block = min(left, 4 << 20)
        ranks = np.searchsorted(cdf, rng.random(block))
        on_block(ranks)
        f.write(table[ranks].tobytes())
        left -= block
    f.write(b"\n")


def build_zipf_corpus(target_mb: int, vocab: int = ZIPF_VOCAB,
                      s: float = ZIPF_S) -> tuple[pathlib.Path, pathlib.Path]:
    """Deterministic high-cardinality corpus: tokens 'wXXXXXX ' (fixed 8
    bytes) drawn Zipf(s) over a ``vocab``-rank support by inverse-CDF
    sampling. Returns (corpus_path, counts_path): the true per-rank counts
    come from the GENERATOR (np.bincount of the drawn ranks), so exactness
    at 10^6+ vocabulary is checked against ground truth, not a second
    tokenizer. It exercises merge eviction, spill runs and dictionary
    growth."""
    import numpy as np

    out = BENCH_DIR / f"zipf-{target_mb}mb-v{vocab}-s{s}.txt"
    counts_p = out.with_suffix(".counts.npy")
    if out.exists() and counts_p.exists() and out.stat().st_size >= target_mb << 20:
        return out, counts_p
    BENCH_DIR.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(20260730)
    cdf, table = _zipf_sampler(vocab, s)
    counts = np.zeros(vocab, dtype=np.int64)
    try:
        with open(out, "wb") as f:
            _write_zipf_tokens(
                f, rng, cdf, table, (target_mb << 20) // 8 + 1,
                lambda ranks: counts.__iadd__(np.bincount(ranks, minlength=vocab)),
            )
        _atomic_np_save(counts_p, counts)
    except BaseException:
        for p in (out, counts_p):
            try:
                p.unlink()
            except OSError:
                pass
        raise
    return out, counts_p


def _leg_device() -> tuple[str, str]:
    """Initialize this leg's device with the driver's own ``select_device``
    (which raises without a card unless BENCH_DEVICE=cpu), then print the
    heartbeat the parent waits on: ``BENCH_DEVICE_READY <platform>
    <device name>``. Returns (platform, device name)."""
    from mapreduce_rust_tpu_torch.runtime.driver import select_device

    dev = select_device(DEVICE)
    if dev.type == "cuda":
        import torch

        name = torch.cuda.get_device_name(dev)
    else:
        name = "cpu"
    print(f"BENCH_DEVICE_READY {dev.type} {name}", file=sys.stderr, flush=True)
    return dev.type, name


def _launches() -> int:
    """tokenize_hash launches in this process so far."""
    from mapreduce_rust_tpu_torch.ops.tokenize_cuda import tokenize_hash

    return tokenize_hash.launches


def zipf_leg(target_mb: int) -> None:
    """Runs in a subprocess (--zipf): word_count over the Zipf corpus with
    egress budgets engaged, verified exactly against the generator's
    ground-truth counts. Prints one JSON detail line."""
    import shutil

    import numpy as np

    platform, device_name = _leg_device()

    from mapreduce_rust_tpu_torch.runtime.driver import run_job
    from mapreduce_rust_tpu_torch.runtime.spill import RUN_FORMAT

    corpus, counts_p = build_zipf_corpus(target_mb)
    truth = np.load(counts_p)
    cfg = _zipf_cfg("zipf-work", "zipf-out", reduce_n=8)
    shutil.rmtree(cfg.work_dir, ignore_errors=True)
    launches0 = _launches()
    t0 = time.perf_counter()
    res = run_job(cfg, [str(corpus)])
    dt = time.perf_counter() - t0
    s = res.stats
    # Exactness vs generator ground truth, streamed from the output files.
    got = np.zeros(ZIPF_VOCAB, dtype=np.int64)
    n_lines = 0
    for f in res.output_files:
        with open(f, "rb") as fh:
            for line in fh:
                w, v = line.rsplit(b" ", 1)
                got[int(w[1:], 16)] = int(v)
                n_lines += 1
    exact = bool(np.array_equal(got, truth))

    # Roofline attribution: achieved host scan bandwidth (bytes over
    # aggregate scan-thread seconds, the host engine's) against the
    # calibrated host memcpy roof in BENCH_DIR/machine.json. None on the
    # device engine, whose scan runs on the card.
    scan_achieved_gbs = roofline_frac = None
    try:
        from mapreduce_rust_tpu_torch.analysis.roofline import calibrate

        machine = calibrate(str(BENCH_DIR / "machine.json"))
        if s.host_map_s:
            scan_achieved_gbs = round(s.bytes_in / s.host_map_s / 1e9, 4)
            roof = machine.get("host_memcpy_gbs")
            if roof:
                roofline_frac = round(scan_achieved_gbs / roof, 4)
    except Exception:
        pass  # attribution is best-effort; the leg's gate stays exactness

    print(json.dumps({
        "zipf": {
            "bytes": s.bytes_in, "wall_s": round(dt, 3),
            "gbs": round(s.gb_per_s, 4), "platform": platform,
            "device_name": device_name,
            "distinct": s.distinct_keys, "expected_distinct": int((truth > 0).sum()),
            "exact": exact, "lines": n_lines,
            "chunks": s.chunks, "launches": _launches() - launches0,
            "spills": s.spill_events, "spilled_keys": s.spilled_keys,
            "replays": s.partial_overflow_replays,
            "dict_words": s.dictionary_words,
            "map_engine": cfg.map_engine,
            "spill_format": RUN_FORMAT,
            "spill_write_s": round(s.spill_s, 3),
            "spill_stall_s": round(s.spill_stall_s, 3),
            "spill_bytes": s.spill_bytes,
            "dict_runs": s.dict_spill_runs,
            "accum_runs": s.accum_spill_runs,
            "merge_fanin": s.merge_fanin,
            "budget_words": cfg.dictionary_budget_words,
            "bottleneck": s.bottleneck,
            "dispatch_mode": s.dispatch_mode,
            "dispatch_s": round(s.dispatch_s, 3),
            "dispatch_stall_s": round(s.dispatch_stall_s, 3),
            "merge_dispatches": s.merge_dispatches,
            "merge_fill_frac": round(s.merge_fill_frac, 4),
            "device_wait_s": round(s.device_wait_s, 3),
            "compile_count": s.compile_count,
            "scan_achieved_gbs": scan_achieved_gbs,
            "roofline_frac": roofline_frac,
        }
    }))
    if not exact:
        raise SystemExit(3)


def zipf_ii_leg(target_mb: int, n_docs: int = 8) -> None:
    """Runs in a subprocess (--zipf-ii): INVERTED INDEX over a multi-doc
    Zipf corpus, budgets engaged, posting lists verified exactly against
    the generator's presence matrix. Prints one JSON detail line."""
    import shutil

    import numpy as np

    platform, device_name = _leg_device()

    from mapreduce_rust_tpu_torch.apps import InvertedIndex
    from mapreduce_rust_tpu_torch.runtime.driver import run_job

    vocab = ZIPF_VOCAB
    base = BENCH_DIR / f"zipf-ii-{target_mb}mb-n{n_docs}"  # n_docs keys the
    # cache: a different doc split must never reuse another's ground truth
    docs = [base.with_name(base.name + f"-d{d}.txt") for d in range(n_docs)]
    pres_p = base.with_name(base.name + ".presence.npy")
    if not (pres_p.exists() and all(p.exists() for p in docs)):
        BENCH_DIR.mkdir(parents=True, exist_ok=True)
        rng = np.random.default_rng(20260731)
        cdf, table = _zipf_sampler(vocab, ZIPF_S)
        presence = np.zeros((vocab, n_docs), dtype=bool)
        per_doc = (target_mb << 20) // (8 * n_docs) + 1
        try:
            for d, path in enumerate(docs):

                def on_block(ranks, _d=d):
                    presence[:, _d] |= np.bincount(ranks, minlength=vocab) > 0

                with open(path, "wb") as f:
                    _write_zipf_tokens(f, rng, cdf, table, per_doc, on_block)
            # Presence commits LAST, atomically: its existence implies the
            # doc files are complete.
            _atomic_np_save(pres_p, presence)
        except BaseException:
            for p in [pres_p, *docs]:
                try:
                    p.unlink()
                except OSError:
                    pass
            raise
    presence = np.load(pres_p)
    if presence.shape[1] != n_docs:
        raise RuntimeError("stale ground truth for this doc split")

    cfg = _zipf_cfg("zipf-ii-work", "zipf-ii-out", reduce_n=8)
    shutil.rmtree(cfg.work_dir, ignore_errors=True)
    launches0 = _launches()
    t0 = time.perf_counter()
    res = run_job(cfg, [str(p) for p in docs], app=InvertedIndex())
    dt = time.perf_counter() - t0
    s = res.stats
    got = np.zeros((vocab, presence.shape[1]), dtype=bool)
    n_lines = 0
    for f in res.output_files:
        with open(f, "rb") as fh:
            for line in fh:
                w, v = line.rsplit(b" ", 1)
                got[int(w[1:], 16), [int(x) for x in v.split(b",")]] = True
                n_lines += 1
    exact = bool(np.array_equal(got, presence))
    print(json.dumps({
        "zipf_ii": {
            "bytes": s.bytes_in, "wall_s": round(dt, 3),
            "gbs": round(s.gb_per_s, 4), "platform": platform,
            "device_name": device_name, "map_engine": cfg.map_engine,
            "distinct_terms": n_lines,
            "expected_terms": int(presence.any(axis=1).sum()),
            "posting_pairs": int(presence.sum()), "docs": presence.shape[1],
            "exact": exact,
            "chunks": s.chunks, "launches": _launches() - launches0,
            "spills": s.spill_events, "spilled_keys": s.spilled_keys,
            "dict_words": s.dictionary_words,
        }
    }))
    if not exact:
        raise SystemExit(3)


def sort_leg(target_mb: int) -> None:
    """Runs in a subprocess (--sort): GLOBAL SORT over the Zipf corpus
    (range-partitioned via sampled splitters), budgets engaged. The
    concatenation of mr-{r}.txt in partition order must be EXACTLY
    sorted() of the corpus token multiset — verified against the
    generator's counts plus a global order sweep. Prints one JSON detail
    line with wall, partition_bytes skew and the splitter overhead."""
    import shutil

    import numpy as np

    platform, device_name = _leg_device()

    from mapreduce_rust_tpu_torch.apps import get_app
    from mapreduce_rust_tpu_torch.runtime.driver import run_job

    corpus, counts_p = build_zipf_corpus(target_mb)
    truth = np.load(counts_p)
    cfg = _zipf_cfg("sort-work", "sort-out", reduce_n=8)
    shutil.rmtree(cfg.work_dir, ignore_errors=True)
    shutil.rmtree(cfg.output_dir, ignore_errors=True)
    launches0 = _launches()
    t0 = time.perf_counter()
    res = run_job(cfg, [str(corpus)], app=get_app("sort"))
    dt = time.perf_counter() - t0
    s = res.stats
    # Every output line is the fixed-width token 'w%06x' + newline (8
    # bytes), so each partition parses as one uint8 matrix; lexicographic
    # order == numeric rank order, so the global order check is one
    # np.diff per file plus the partition boundary carry.
    got = np.zeros(ZIPF_VOCAB, dtype=np.int64)
    ordered = True
    prev = -1
    lines = 0
    place = np.power(16, np.arange(5, -1, -1, dtype=np.int64))
    for f in res.output_files:  # run_job returns partition order
        data = pathlib.Path(f).read_bytes()
        if not data:
            continue
        arr = np.frombuffer(data, dtype=np.uint8).reshape(-1, 8)
        hexd = arr[:, 1:7].astype(np.int64)
        hexd = np.where(hexd >= ord("a"), hexd - (ord("a") - 10),
                        hexd - ord("0"))
        ranks = (hexd * place).sum(axis=1)
        if ranks[0] < prev or (len(ranks) > 1 and np.any(np.diff(ranks) < 0)):
            ordered = False
        prev = int(ranks[-1])
        got += np.bincount(ranks, minlength=ZIPF_VOCAB)
        lines += len(ranks)
    exact = bool(np.array_equal(got, truth)) and ordered
    pb = list(s.partition_bytes)
    mean_pb = (sum(pb) / len(pb)) if pb else 0.0
    print(json.dumps({
        "sort": {
            "bytes": s.bytes_in, "wall_s": round(dt, 3),
            "platform": platform, "device_name": device_name,
            "map_engine": cfg.map_engine, "lines": lines,
            "ordered": ordered, "exact": exact,
            "distinct": s.distinct_keys,
            "chunks": s.chunks, "launches": _launches() - launches0,
            "partition_mode": s.partition_mode,
            "reduce_n": cfg.reduce_n,
            "partition_bytes": pb,
            # max/mean of the per-partition output bytes: 1.0 = an ideal
            # R-way split.
            "skew": round(max(pb) / mean_pb, 4) if pb and mean_pb else None,
            "splitter_samples": s.splitter_samples,
            "splitter_s": round(s.splitter_s, 4),
            "spills": s.spill_events,
            "dict_runs": s.dict_spill_runs,
            "bottleneck": s.bottleneck,
        }
    }))
    if not exact:
        raise SystemExit(3)


def sort_leg_main() -> None:
    """``bench_torch.py --sort-leg``: the global-sort workload leg as its
    own harness — Zipf corpus, range partitioning via sampled splitters,
    outputs verified globally ordered AND exact against the generator
    inside the subprocess leg, on the card. Appends one history row and
    prints ONE JSON line; exit 1 when the leg failed or diverged."""
    mb = int(os.environ.get("BENCH_SORT_MB", "48"))
    res, err = _run_device_leg(
        pathlib.Path(str(mb)),
        int(os.environ.get("BENCH_SORT_TIMEOUT_S", "420")),
        None, init_timeout_s=PROBE_TIMEOUT_S, mode="--sort",
    )
    det = (res or {}).get("sort")
    result: dict = {
        "metric": f"global sort over {mb}MB Zipf corpus "
                  "(range-partitioned, sampled splitters)",
        "unit": "s",
        "value": None,  # the GB/s history series must never mix in sort walls
        "platform": (det or {}).get("platform", "none"),
        "sort_wall_s": (det or {}).get("wall_s"),
        "sort_skew": (det or {}).get("skew"),
        "sort_splitter_s": (det or {}).get("splitter_s"),
        "sort_splitter_samples": (det or {}).get("splitter_samples"),
        "sort_lines": (det or {}).get("lines"),
        "sort_chunks": (det or {}).get("chunks"),
        "sort_launches": (det or {}).get("launches"),
        "sort_exact": bool((det or {}).get("exact")),
    }
    if res is None:
        result["error"] = err
    _append_history(result)
    print(json.dumps(result))
    if det is None or not det.get("exact"):
        raise SystemExit(1)


def _timer(platform: str):
    """timed(n, fn) → ms per fn() call over n calls, ended by a wait for
    the device: CUDA events around the calls on the card (after a
    synchronize), the host clock on the CPU."""
    import torch

    def timed(n, fn):
        if platform == "cuda":
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / n
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e3

    return timed


def micro_leg() -> None:
    """Runs in a subprocess (--micro): device micro-benchmarks — the
    64 MB host-to-device rate, then map_combine and the whole step
    (map_combine + merge) in ms per MB on a 1 MiB chunk, through the
    port's make_step_fns."""
    import numpy as np
    import torch

    platform, device_name = _leg_device()

    from mapreduce_rust_tpu_torch.apps.word_count import WordCount
    from mapreduce_rust_tpu_torch.config import Config
    from mapreduce_rust_tpu_torch.core.kv import KVBatch
    from mapreduce_rust_tpu_torch.runtime.driver import make_step_fns, select_device

    dev = select_device(DEVICE)
    cfg = Config(chunk_bytes=1 << 20)
    u_cap = cfg.effective_partial_capacity()
    map_combine, merge = make_step_fns(WordCount(), u_cap)

    seed = b"a b c " * 200000
    chunk = np.frombuffer((seed * (cfg.chunk_bytes // len(seed) + 1))[: cfg.chunk_bytes],
                          np.uint8)
    timed = _timer(platform)

    # h2d: one 64 MB pageable transfer, as a job's caller hands it over.
    # On the CPU there is no transfer to time.
    h2d_mbps = None
    if platform == "cuda":
        big = torch.zeros(64 << 20, dtype=torch.uint8)
        big.to(dev)  # warm path
        h2d_mbps = (64 << 20) / (timed(1, lambda: big.to(dev)) / 1e3) / 1e6

    chunk_dev = torch.from_numpy(chunk.copy()).to(dev)
    state = KVBatch.empty(cfg.merge_capacity, dev)

    def step():
        nonlocal state
        u, _ = map_combine(chunk_dev, 0)
        state, _e, _c = merge(state, u)

    # Three untimed steps first, so the timed ones find the caching
    # allocator already holding the step's working set. On the CPU (tests
    # only) the plain scan takes ~0.5 s per chunk: one of each there.
    warm_n, reps = (3, 10) if platform == "cuda" else (1, 1)
    timed(warm_n, step)
    launches0 = _launches()
    map_ms = timed(reps, lambda: map_combine(chunk_dev, 0))
    step_ms = timed(reps, step)
    mb = cfg.chunk_bytes / 1e6
    print(json.dumps({
        "micro": {
            "platform": platform,
            "device_name": device_name,
            "h2d_MBps": round(h2d_mbps, 1) if h2d_mbps is not None else None,
            "map_combine_ms_per_mb": round(map_ms / mb, 4),
            "map_step_ms_per_mb": round(step_ms / mb, 4),
            "merge_ms": round(step_ms - map_ms, 4),
            "timed_launches": _launches() - launches0,
            "chunk_mb": mb,
            "merge_capacity": cfg.merge_capacity,
            "partial_capacity": u_cap,
        }
    }))


def _overhead_base(out_root: pathlib.Path):
    """The Config of the three overhead legs: bench.py's, on the engine
    BENCH_MAP_ENGINE names and on the card."""
    from mapreduce_rust_tpu_torch.config import Config

    return Config(
        map_engine=_map_engine(),
        host_map_workers=_env_host_workers(),
        fold_shards=_env_fold_shards(),
        host_window_bytes=16 << 20,
        chunk_bytes=1 << 20,
        merge_capacity=1 << 17,
        reduce_n=4,
        output_dir=str(out_root / "out"),
        device=DEVICE,
    )


def _overhead_pair(path: str, base, knob: str, out_root: pathlib.Path,
                   per_side_work: bool, platform: str) -> dict:
    """The sampler-tax estimator of bench.py's three overhead legs: the SAME
    word_count run with ``knob`` on and off, min-of-N per side with the
    sides interleaved (on/off, then off/on), and outputs required
    bit-identical on and off. Scheduling noise only ever adds, so each
    side's minimum converges to its true cost; cpu_frac (process_time,
    every thread's CPU seconds) rides beside the wall frac."""
    import dataclasses

    from mapreduce_rust_tpu_torch.runtime.driver import run_job

    # Warm-up on a one-window prefix with the knob off: the kernels load
    # and the allocator warms before any measured run.
    warm = BENCH_DIR / "warmup-overhead.txt"
    with open(path, "rb") as f:
        warm.write_bytes(f.read(base.host_window_bytes + 4096))
    run_job(dataclasses.replace(base, **{knob: False}), [str(warm)], write_outputs=False)

    chunks = 0
    launches0 = _launches()

    def one(enabled: bool) -> tuple[float, float, dict]:
        nonlocal chunks
        side = "on" if enabled else "off"
        cfg = dataclasses.replace(
            base, **{knob: enabled},
            output_dir=str(out_root / f"out-{side}"),
            **({"work_dir": str(out_root / f"work-{side}")} if per_side_work else {}),
        )
        c0 = time.process_time()
        t0 = time.perf_counter()
        res = run_job(cfg, [str(path)])
        wall = time.perf_counter() - t0
        cpu = time.process_time() - c0
        chunks += res.stats.chunks
        outputs = {
            p.name: p.read_bytes()
            for p in sorted(pathlib.Path(cfg.output_dir).glob("mr-*.txt"))
        }
        return wall, cpu, outputs

    walls: dict = {"on": [], "off": []}
    cpus: dict = {"on": [], "off": []}
    outputs: dict = {}
    identical = True
    for i in range(OVERHEAD_RUNS):
        for enabled in ((True, False) if i % 2 == 0 else (False, True)):
            wall, cpu, out = one(enabled)
            side = "on" if enabled else "off"
            walls[side].append(wall)
            cpus[side].append(cpu)
            if not out:
                identical = False
            elif not outputs:
                outputs = out
            elif out != outputs:
                identical = False
    on_s, off_s = min(walls["on"]), min(walls["off"])
    frac = (on_s - off_s) / off_s if off_s > 0 else None
    cpu_on, cpu_off = min(cpus["on"]), min(cpus["off"])
    cpu_frac = (cpu_on - cpu_off) / cpu_off if cpu_off > 0 else None
    return {
        "platform": platform,
        "map_engine": base.map_engine,
        "bytes": pathlib.Path(path).stat().st_size,
        "runs_per_side": OVERHEAD_RUNS,
        "on_s": round(on_s, 4),
        "off_s": round(off_s, 4),
        "frac": round(frac, 5) if frac is not None else None,
        "cpu_frac": round(cpu_frac, 5) if cpu_frac is not None else None,
        "outputs_identical": identical,
        "chunks": chunks,
        "launches": _launches() - launches0,
    }


def metrics_overhead_leg(path: str) -> None:
    """Runs in a subprocess (--metrics-overhead): the metrics registry's
    tax. Outputs must be bit-identical ON vs OFF (telemetry never reaches
    the data path); ``frac`` = (min_on - min_off) / min_off."""
    platform, _name = _leg_device()
    out_root = BENCH_DIR / "metrics-overhead"
    out = _overhead_pair(path, _overhead_base(out_root), "metrics_enabled", out_root,
                         per_side_work=False, platform=platform)
    print(json.dumps({"metrics_overhead": out}))


def profile_overhead_leg(path: str) -> None:
    """Runs in a subprocess (--profile-overhead): the sampling profiler's
    tax (one thread waking at ``profile_hz`` to walk every thread's
    stack), metrics at their default on both sides."""
    platform, _name = _leg_device()
    out_root = BENCH_DIR / "profile-overhead"
    out = _overhead_pair(path, _overhead_base(out_root), "profile", out_root,
                         per_side_work=False, platform=platform)
    print(json.dumps({"profile_overhead": out}))


def lineage_overhead_leg(path: str) -> None:
    """Runs in a subprocess (--lineage-overhead): the provenance ledger's
    two numbers in one leg.

    1. Ledger tax: the overhead estimator with ``Config.lineage`` as the
       toggled knob — one digest per chunk plus one flushed jsonl line
       per chunk and partition.
    2. Blast radius: grow the corpus ~1% (a new file appended to the input
       list), re-run with lineage on, diff the two ledgers: memo_hit_frac
       is the byte fraction a memo tier could skip."""
    import dataclasses

    platform, _name = _leg_device()

    from mapreduce_rust_tpu_torch.analysis import lineage as lin
    from mapreduce_rust_tpu_torch.runtime.driver import run_job

    out_root = BENCH_DIR / "lineage-overhead"
    base = _overhead_base(out_root)
    out = _overhead_pair(path, base, "lineage", out_root, per_side_work=True,
                         platform=platform)

    # Blast radius: +~1% new file (cut at whitespace so the tokenizer sees
    # whole words). The base-side ledger is the pair loop's last ON run.
    blast: dict | None = None
    try:
        grow = pathlib.Path(path).stat().st_size // 100
        extra = out_root / "grown-extra.txt"
        with open(path, "rb") as f:
            f.seek(-min(grow + (1 << 16), f.seek(0, 2)), 2)
            tail = f.read()
        cut = next((i for i, b in enumerate(tail) if b in _WS), 0)
        extra.write_bytes(tail[cut:cut + grow])
        run_job(
            dataclasses.replace(
                base, lineage=True,
                work_dir=str(out_root / "work-grown"),
                output_dir=str(out_root / "out-grown"),
            ),
            [str(path), str(extra)],
        )
        d = lin.diff(lin.load_ledger(str(out_root / "work-on")),
                     lin.load_ledger(str(out_root / "work-grown")))
        blast = {
            "grown_bytes": extra.stat().st_size,
            "memo_hit_frac": round(d["memo_hit_frac"], 5),
            "changed_chunks": d["changed_chunks"],
            "affected_partition_frac": round(d["affected_partition_frac"], 5),
        }
    except Exception as e:
        blast = {"error": repr(e)}
    print(json.dumps({"lineage_overhead": {**out, "blast_radius": blast}}))


def _ws_aligned_slices(path: pathlib.Path, n: int, limit: int | None = None):
    """n byte ranges cut at whitespace (reading only boundary probes)."""
    size = min(path.stat().st_size, limit or (1 << 62))
    bounds = [0]
    with open(path, "rb") as f:
        for i in range(1, n):
            pos = size * i // n
            f.seek(pos)
            tail = f.read(1 << 16)
            off = next((j for j, b in enumerate(tail) if b in _WS), 0)
            bounds.append(pos + off)
    bounds.append(size)
    return [(int(a), int(b)) for a, b in zip(bounds, bounds[1:])]


def _map_task(args) -> int:
    """One map task with the Rust original's ARCHITECTURE (src/mr/worker.rs:
    142-155): read the slice, tokenize with its semantics (regex strip +
    split, src/app/wc.rs:6-13), then route EVERY occurrence by
    hash(word) % reduce_n into per-(m, r) intermediate files — the
    file-plane shuffle that defines it (worker.rs:117-140). Deliberately
    GENEROUS: each partition file is written in one call instead of one
    awaited write + one println per KV pair (worker.rs:131-136)."""
    import re
    import zlib

    path, start, end, m, reduce_n, workdir = args
    with open(path, "rb") as f:
        f.seek(start)
        text = f.read(end - start).decode("utf-8", errors="replace")
    toks = re.sub(r"[^\w\s]", "", text, flags=re.UNICODE).split()
    bufs: list[list] = [[] for _ in range(reduce_n)]
    # Deterministic hash (builtin hash() is seed-randomized per process —
    # under a spawn start method each worker would route the same word to
    # a DIFFERENT partition and silently break the grouping invariant).
    for w in toks:  # per-KV hash + route, like worker.rs:127-137
        bufs[zlib.crc32(w.encode()) % reduce_n].append(w)
    for r, b in enumerate(bufs):
        with open(os.path.join(workdir, f"mr-{m}-{r}.txt"), "w",
                  encoding="utf-8") as f:
            if b:
                f.write(" 1\n".join(b))
                f.write(" 1\n")
    return len(toks)


def _reduce_task(args) -> collections.Counter:
    """One reduce task (worker.rs:157-193): read every map's partition-r
    file, parse the 'word 1' lines, group-count. Counter replaces the
    original's full lexicographic sort + linear group scan
    (worker.rs:162-184) — again the generous choice."""
    r, map_n, workdir = args
    c: collections.Counter = collections.Counter()
    for m in range(map_n):
        with open(os.path.join(workdir, f"mr-{m}-{r}.txt"),
                  encoding="utf-8") as f:
            # rsplit, not a fixed-width slice: the reader must not depend
            # on the ' 1' suffix staying literally two characters wide.
            c.update(s.rsplit(" ", 1)[0] for s in f.read().splitlines())
    return c


def cpu_baseline_gbs(path: pathlib.Path, limit_bytes: int, workers: int = 8,
                     reduce_n: int = 4) -> float:
    """Multi-process original-ARCHITECTURE word count, GB/s: map tasks
    hash-partition every token into mr-{m}-{r}.txt files, a phase barrier,
    then reduce tasks read them back and count — the original's exact
    data movement (control via the pool, data via the filesystem), with
    batched IO and Counter reduce as generous simplifications."""
    import shutil

    workdir = str(BENCH_DIR / "baseline-shuffle")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    slices = _ws_aligned_slices(path, workers, limit_bytes)
    t0 = time.perf_counter()
    with multiprocessing.Pool(workers) as pool:
        n_tok = pool.map(
            _map_task,
            [(str(path), a, b, m, reduce_n, workdir)
             for m, (a, b) in enumerate(slices)],
        )
        # map→reduce phase barrier (the original's get_reduce_task gate,
        # src/mr/coordinator.rs:183-185) is implicit in the two pool.maps.
        parts = pool.map(
            _reduce_task, [(r, len(slices), workdir) for r in range(reduce_n)]
        )
    dt = time.perf_counter() - t0
    total = sum(len(c) for c in parts)
    if not (total > 0 and sum(n_tok) == sum(sum(c.values()) for c in parts)):
        raise RuntimeError("cpu baseline: reduce counts disagree with the map's tokens")
    shutil.rmtree(workdir, ignore_errors=True)
    return limit_bytes / dt / 1e9


def device_leg(path: str) -> None:
    """Runs INSIDE the bench subprocess: the full run_job path on the card,
    prints one JSON line {gbs, info, stats} on stdout."""
    import dataclasses

    platform, device_name = _leg_device()

    from mapreduce_rust_tpu_torch.config import Config
    from mapreduce_rust_tpu_torch.ops.cuda_build import BUILD_LOG
    from mapreduce_rust_tpu_torch.ops.tokenize_cuda import tokenize_hash
    from mapreduce_rust_tpu_torch.runtime.driver import run_job
    from mapreduce_rust_tpu_torch.runtime.telemetry import stats_to_dict

    cfg = Config(
        map_engine=_map_engine(),
        host_map_workers=_env_host_workers(),
        fold_shards=_env_fold_shards(),
        host_window_bytes=16 << 20,
        chunk_bytes=1 << 20,
        merge_capacity=1 << 18,
        reduce_n=4,
        output_dir=str(BENCH_DIR / "out"),
        device=DEVICE,
        # --trace/--manifest ride into this subprocess as env vars; the
        # measured run then writes the timeline and its own run manifest.
        trace_path=os.environ.get("BENCH_TRACE") or None,
        manifest_path=os.environ.get("BENCH_RUN_MANIFEST") or None,
    )
    # Warm-up on a one-window prefix with the same shapes as the main run:
    # the kernels load and the caching allocator fills. Telemetry is
    # stripped (a warm-up manifest at the same path could pass for the
    # measured run's). The kernels build or load here, so their records
    # land in the leg's info, not in the measured run's compile block.
    builds0 = len(BUILD_LOG)
    warm = BENCH_DIR / "warmup.txt"
    with open(path, "rb") as f:
        warm.write_bytes(f.read(cfg.host_window_bytes + 4096))
    run_job(dataclasses.replace(cfg, trace_path=None, manifest_path=None),
            [str(warm)], write_outputs=False)
    # The manifest counts the process's launches: count the measured run's.
    tokenize_hash.launches = 0

    res = run_job(cfg, [str(path)])
    s = res.stats
    builds = BUILD_LOG[builds0:]
    info = {
        "bytes": s.bytes_in,
        "wall_s": round(s.wall_seconds, 3),
        "distinct": s.distinct_keys,
        "chunks": s.chunks,
        "launches": tokenize_hash.launches,
        "spills": s.spill_events,
        "collisions": s.hash_collisions,
        "ingest_wait_s": round(s.ingest_wait_s, 3),
        "device_wait_s": round(s.device_wait_s, 3),
        "bottleneck": s.bottleneck,
        "host_map_s": round(s.host_map_s, 3),
        "host_glue_s": round(s.host_glue_s, 3),
        "host_workers": s.host_map_workers,
        "fold_shards": s.fold_shards,
        "fold_s": round(s.fold_s, 3),
        "fold_stall_s": round(s.fold_stall_s, 3),
        "scan_wait_s": round(s.scan_wait_s, 3),
        "map_engine": cfg.map_engine,
        "phases": {k: round(v, 3) for k, v in s.phase_seconds.items()},
        "platform": platform,
        "device_name": device_name,
        # Every kernel build or load of the leg's process (the warm-up's),
        # outside the measured run's wall.
        "kernel_builds": {
            "count": len(builds),
            "total_s": round(sum(b["dur_s"] for b in builds), 6),
            "cache_hits": sum(b["cache"] == "hit" for b in builds),
            "cache_misses": sum(b["cache"] == "miss" for b in builds),
        },
    }
    # The FULL JobStats rides back so the bench manifest carries every
    # counter, not the info subset.
    print(json.dumps({"gbs": s.gb_per_s, "info": info, "stats": stats_to_dict(s)}))


def _partial_trace_note(child_env: dict) -> str:
    """A failed or killed leg that was tracing leaves an atomic
    ``*.partial.json`` snapshot (the flight recorder): name it."""
    tp = child_env.get("BENCH_TRACE")
    if not tp:
        return ""
    from mapreduce_rust_tpu_torch.runtime.trace import partial_path

    pp = partial_path(tp)
    if os.path.exists(pp):
        return (
            f"; flight recorder kept {pp} — stitch it with "
            f"`python -m mapreduce_rust_tpu_torch trace merge merged.json {pp}`"
        )
    return ""


def _run_device_leg(corpus: pathlib.Path, timeout_s: int, env: dict | None,
                    init_timeout_s: int | None = None,
                    mode: str = "--device-leg"):
    """Launch a subprocess leg; return (parsed dict | None, error | None).

    env is the child's FULL environment (None = inherit ambient).
    init_timeout_s bounds time-to-heartbeat (BENCH_DEVICE_READY on stderr,
    printed right after select_device in the child): a card that hangs
    its initialization costs the deadline, not the whole timeout_s, and a
    healthy card then gets the full timeout_s for the run itself.
    """
    import threading

    child_env = dict(os.environ) if env is None else dict(env)
    run_manifest = None
    if mode == "--device-leg":
        # Every measured leg writes its own run manifest (full Config +
        # JobStats from inside the subprocess): the parent reads STATS from
        # that structured file; stdout stays the fallback channel.
        run_manifest = child_env.setdefault(
            "BENCH_RUN_MANIFEST", str(BENCH_DIR / "leg-run-manifest.json")
        )
    elif mode in ("--zipf", "--zipf-ii"):
        run_manifest = child_env.get("BENCH_ZIPF_RUN_MANIFEST")
    t_start = time.time()
    proc = subprocess.Popen(
        [sys.executable, str(REPO / "bench_torch.py"), mode, str(corpus)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=child_env, cwd=str(REPO),
    )
    ready = threading.Event()
    err_chunks: list[str] = []
    out_chunks: list[str] = []

    # Both pipes are drained concurrently (a full, unread pipe would block
    # the child mid-write and masquerade as a timeout here).
    def _pump_err() -> None:
        for line in proc.stderr:
            err_chunks.append(line)
            if "BENCH_DEVICE_READY" in line:
                ready.set()

    def _pump_out() -> None:
        for line in proc.stdout:
            out_chunks.append(line)

    pumps = [
        threading.Thread(target=_pump_err, daemon=True),
        threading.Thread(target=_pump_out, daemon=True),
    ]
    for p in pumps:
        p.start()
    try:
        if init_timeout_s is not None:
            deadline = time.monotonic() + init_timeout_s
            # A child that EXITS before the heartbeat (no card, import
            # error) is reported by its rc and stderr tail, not mislabeled
            # a wedge after the full deadline.
            while (
                not ready.is_set()
                and proc.poll() is None
                and time.monotonic() < deadline
            ):
                time.sleep(0.2)
            if not ready.is_set() and proc.poll() is None:
                return None, (
                    f"device init: no heartbeat within {init_timeout_s}s"
                    + _partial_trace_note(child_env)
                )
        try:
            proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            return None, (
                f"device leg timed out after {timeout_s}s"
                + _partial_trace_note(child_env)
            )
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for p in pumps:
            p.join(timeout=30)
        sys.stderr.write("".join(err_chunks)[-4000:])
    out = "".join(out_chunks)
    for line in reversed(out.splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                parsed = json.loads(line)
            except json.JSONDecodeError:
                break
            if proc.returncode != 0:
                # A leg that printed its JSON but exited nonzero FAILED
                # (e.g. a Zipf leg's exactness check exits 3).
                return None, f"{mode} rc={proc.returncode} (result {line[:200]})"
            m = _load_leg_manifest(run_manifest, t_start, proc.pid)
            if m is not None:
                # Structured channel won: the leg's own run manifest
                # carries the authoritative JobStats and phase times, the
                # card it ran on and the kernel's launches.
                parsed["stats"] = m["stats"]
                if "info" in parsed:
                    if m.get("phase_seconds"):
                        parsed["info"]["phases"] = {
                            k: round(v, 3) for k, v in m["phase_seconds"].items()
                        }
                    parsed["info"]["kernel_launches"] = m.get("kernel_launches")
                parsed["platform_info"] = m.get("platform")
                parsed["run_manifest"] = run_manifest
                parsed["stats_source"] = "run_manifest"
            return parsed, None
    tail = ("".join(err_chunks) or out).strip().splitlines()
    return None, (
        f"device leg rc={proc.returncode}: {tail[-1] if tail else 'no output'}"
        + _partial_trace_note(child_env)
    )


def _load_leg_manifest(path, t_start: float, pid: int):
    """The leg's run manifest iff it is FRESH (written after this leg
    started) AND written by THIS leg's process — the manifest embeds the
    writer's pid (telemetry.platform_info), so a stale file from an
    earlier leg or a median repeat never passes for this leg's stats.
    None → the caller keeps the stdout-parsed fallback."""
    try:
        if path and os.path.getmtime(path) >= t_start - 1.0:
            with open(path) as f:
                m = json.load(f)
            if (
                m.get("kind") == "run_manifest"
                and m.get("stats")
                and m.get("platform", {}).get("pid") == pid
            ):
                return m
    except (OSError, ValueError):
        pass
    return None


def main() -> None:
    errors: list[str] = []
    base_gbs = None

    try:
        corpus = build_corpus(TARGET_MB)
    except Exception as e:  # disk pressure etc. — shrink, never die
        errors.append(f"corpus: {e!r}")
        corpus = build_corpus(8)

    try:
        # Median of three: the pool measurement is noisy (fork + import +
        # scheduler jitter swing single runs ±20%).
        runs = sorted(
            cpu_baseline_gbs(corpus, min(BASELINE_MB << 20, corpus.stat().st_size))
            for _ in range(3)
        )
        base_gbs = runs[1]
        print(f"cpu baseline: {base_gbs:.4f} GB/s (runs: {runs})", file=sys.stderr)
    except Exception as e:
        errors.append(f"cpu_baseline: {e!r}")

    # Median of DEVICE_RUNS runs (three by default) — the SAME estimator as
    # the CPU baseline. Repeats are skipped when the first run was slow:
    # one number beats a harness-level timeout.
    def median_leg(c: pathlib.Path, timeout_s: int):
        t0 = time.perf_counter()
        first, e = _run_device_leg(c, timeout_s, None, init_timeout_s=PROBE_TIMEOUT_S)
        if first is None or time.perf_counter() - t0 >= timeout_s / 3:
            return first, e
        more = [first]
        for _ in range(DEVICE_RUNS - 1):
            r, _e = _run_device_leg(c, timeout_s, None, init_timeout_s=PROBE_TIMEOUT_S)
            if r is not None:
                more.append(r)
        return sorted(more, key=lambda r: r["gbs"])[len(more) // 2], None

    probes: list[dict] = []

    def note_probe(tag: str, res, err) -> None:
        p = {"when": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
             "leg": tag, "ok": res is not None}
        if res is None and err:
            p["error"] = err
        probes.append(p)

    def leg(tag: str, corpus_path: pathlib.Path, timeout_s: int, mode: str):
        res, err = _run_device_leg(corpus_path, timeout_s, None,
                                   init_timeout_s=PROBE_TIMEOUT_S, mode=mode)
        note_probe(tag, res, err)
        if res is None:
            errors.append(f"{tag}: {err}")
        return res

    dev, err = median_leg(corpus, DEVICE_TIMEOUT_S)
    note_probe("device", dev, err)
    if dev is None:
        errors.append(err)

    micro = leg("micro", corpus, 180, "--micro")

    # High-cardinality leg: Zipf corpus (2M-rank support), budgets engaged,
    # exact against the generator's counts.
    zipf = None
    zipf_mb = int(os.environ.get("BENCH_ZIPF_MB", "256"))
    if zipf_mb > 0:
        zipf = leg("zipf", pathlib.Path(str(zipf_mb)),
                   int(os.environ.get("BENCH_ZIPF_TIMEOUT_S", "420")), "--zipf")

    # The three overhead pairs over one small corpus, each once per run.
    overhead = prof_overhead = lin_overhead = None
    overhead_mb = int(os.environ.get("BENCH_METRICS_OVERHEAD_MB", "16"))
    overhead_timeout = int(os.environ.get("BENCH_METRICS_OVERHEAD_TIMEOUT_S", "300"))
    overhead_corpus = None
    if overhead_mb > 0:
        try:
            overhead_corpus = build_corpus(min(TARGET_MB, overhead_mb))
        except Exception as e:
            errors.append(f"overhead corpus: {e!r}")
    if overhead_corpus is not None:
        overhead = leg("metrics-overhead", overhead_corpus, overhead_timeout,
                       "--metrics-overhead")
        if os.environ.get("BENCH_PROFILE_OVERHEAD", "1") != "0":
            prof_overhead = leg("profile-overhead", overhead_corpus, overhead_timeout,
                                "--profile-overhead")
        if os.environ.get("BENCH_LINEAGE_OVERHEAD", "1") != "0":
            lin_overhead = leg("lineage-overhead", overhead_corpus, overhead_timeout,
                               "--lineage-overhead")

    value = round(dev["gbs"], 4) if dev else None
    platform = dev["info"].get("platform", "unknown") if dev else "none"
    # The corpus label comes from the bytes the measured leg processed.
    measured_mb = round(dev["info"]["bytes"] / (1 << 20)) if dev else 0
    result = {
        "metric": (
            f"word_count GB/s end-to-end ({measured_mb}MB corpus, "
            f"{dev['info']['map_engine']} engine, single {platform} device "
            f"{dev['info']['device_name']} vs {BASELINE_MB}MB 8-proc CPU baseline)"
            if dev
            else "word_count GB/s end-to-end (no device measurement)"
        ),
        "value": value,
        "unit": "GB/s",
        "vs_baseline": (
            round(value / base_gbs, 2) if value is not None and base_gbs else None
        ),
        "platform": platform,
        "probes": probes,
    }
    if dev is not None:
        result["device_name"] = dev["info"]["device_name"]
        result["map_engine"] = dev["info"]["map_engine"]
        result["kernel_builds"] = dev["info"]["kernel_builds"]
        if dev.get("stats"):
            result["fold_shards"] = dev["stats"].get("fold_shards")
    if micro is not None:
        result["device_micro"] = micro.get("micro")
    if zipf is not None:
        result["zipf"] = zipf.get("zipf")
    if overhead is not None:
        result["metrics_overhead"] = overhead.get("metrics_overhead")
    if prof_overhead is not None:
        result["profile_overhead"] = prof_overhead.get("profile_overhead")
    if lin_overhead is not None:
        result["lineage_overhead"] = lin_overhead.get("lineage_overhead")
    if errors:
        result["error"] = "; ".join(errors)
    result["doctor"] = _doctor_measured_leg(dev)
    _write_bench_manifest(result, dev, base_gbs)
    _append_history(result)
    print(json.dumps(result))
    if dev:
        print(
            json.dumps({"detail": dev["info"],
                        "cpu_baseline_gbs": round(base_gbs, 4) if base_gbs else None}),
            file=sys.stderr,
        )
    else:
        raise SystemExit(1)  # no device measurement: no number


def _doctor_measured_leg(dev) -> "dict | None":
    """Run the doctor (analysis/doctor.py, torch-free, in-process) on the
    measured leg's own run manifest, so every bench line names its
    bottleneck and carries the ranked findings next to the number. The
    manifest on disk describes the LAST completed leg (median repeats
    rewrite it), the freshest leg of the same config. Best-effort."""
    path = (dev or {}).get("run_manifest")
    if not path or not os.path.exists(path):
        return None
    try:
        from mapreduce_rust_tpu_torch.analysis.doctor import diagnose
        from mapreduce_rust_tpu_torch.runtime.telemetry import load_manifest

        diag = diagnose(load_manifest(path))
        out = {
            "bottleneck": (diag.get("bottleneck") or {}).get("name"),
            "findings": [
                f"[{f['severity']}] {f['code']}: {f['message']}"
                for f in (diag.get("findings") or [])[:8]
            ],
            "manifest": path,
        }
        hists = diag.get("histograms_ms") or {}
        for name in ("host_map.scan_s", "a2a.round_s", "device.drain_s"):
            if name in hists:
                out.setdefault("p99_ms", {})[name] = hists[name].get("p99")
        print(f"doctor: bottleneck={out['bottleneck']} "
              f"findings={len(out['findings'])}", file=sys.stderr)
        return out
    except Exception as e:
        return {"error": repr(e)}


def _append_history(result: dict) -> None:
    """Append one line per bench run to BENCH_DIR/history.jsonl: a durable
    trajectory instead of whatever the last manifest overwrote. Errors are
    recorded, never raised."""
    try:
        from mapreduce_rust_tpu_torch.runtime.telemetry import git_rev

        zipf = result.get("zipf") or {}
        line = {
            "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "git_rev": git_rev(),
            "metric": result.get("metric"),
            "value": result.get("value"),
            "unit": result.get("unit"),
            "vs_baseline": result.get("vs_baseline"),
            "platform": result.get("platform"),
            "device_name": result.get("device_name"),
            "map_engine": result.get("map_engine"),
            "doctor_bottleneck": (result.get("doctor") or {}).get("bottleneck"),
            "fold_shards": result.get("fold_shards"),
            "zipf_gbs": zipf.get("gbs"),
            "zipf_wall_s": zipf.get("wall_s"),
            "zipf_spill_stall_s": zipf.get("spill_stall_s"),
            "zipf_spill_write_s": zipf.get("spill_write_s"),
            "spill_run_format": zipf.get("spill_format"),
            "merge_dispatches": zipf.get("merge_dispatches"),
            "merge_fill_frac": zipf.get("merge_fill_frac"),
            "dispatch_mode": zipf.get("dispatch_mode"),
            "zipf_dispatch_stall_s": zipf.get("dispatch_stall_s"),
            "metrics_overhead_frac": (result.get("metrics_overhead") or {}).get("frac"),
            "scan_achieved_gbs": zipf.get("scan_achieved_gbs"),
            "roofline_frac": zipf.get("roofline_frac"),
            "profile_overhead_frac": (result.get("profile_overhead") or {}).get("frac"),
            "lineage_overhead_frac": (result.get("lineage_overhead") or {}).get("frac"),
            "lineage_memo_hit_frac": (
                ((result.get("lineage_overhead") or {}).get("blast_radius")
                 or {}).get("memo_hit_frac")
            ),
            "had_errors": bool(result.get("error")),
        }
        # Sort rows carry their own fields verbatim; their "value" stays
        # None so the GB/s series never mixes in sort walls.
        line.update({k: v for k, v in result.items() if k.startswith("sort_")})
        BENCH_DIR.mkdir(parents=True, exist_ok=True)
        with open(BENCH_DIR / "history.jsonl", "a") as f:
            f.write(json.dumps(line) + "\n")
        print(f"history: appended to {BENCH_DIR / 'history.jsonl'}", file=sys.stderr)
    except Exception as e:
        print(f"history append failed: {e!r}", file=sys.stderr)


def _card(dev) -> dict:
    """The card as ``nvidia-smi`` names it (name, power limit) beside the
    CUDA version of the measured leg's torch (its run manifest's)."""
    card: dict = {"nvidia_smi": None,
                  "torch_cuda": ((dev or {}).get("platform_info") or {}).get("cuda")}
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        if r.returncode == 0 and r.stdout.strip():
            card["nvidia_smi"] = r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return card


def _write_bench_manifest(result: dict, dev, base_gbs) -> None:
    """One manifest.json per bench run — config, platform, card, git rev,
    the measured leg's full JobStats, probe outcomes — so later rounds read
    structured state instead of scraping log tails. Best effort: a manifest
    failure never costs the stdout JSON line."""
    try:
        from mapreduce_rust_tpu_torch.runtime import telemetry

        path = os.environ.get("BENCH_MANIFEST") or str(BENCH_DIR / "manifest.json")
        bench_cfg = {
            "target_mb": TARGET_MB, "baseline_mb": BASELINE_MB,
            "zipf_mb": int(os.environ.get("BENCH_ZIPF_MB", "256")),
            "map_engine": _map_engine(),
            "device": DEVICE,
            "device_runs": DEVICE_RUNS,
            "overhead_runs": OVERHEAD_RUNS,
            "device_timeout_s": DEVICE_TIMEOUT_S,
            "probe_timeout_s": PROBE_TIMEOUT_S,
        }
        manifest = telemetry.build_manifest(
            bench_cfg,
            probes=result.get("probes"),
            extra={
                "kind": "bench_manifest",
                "app": "word_count",
                "result": result,
                # The port has no lint command yet; bench.py's block is the
                # reference package's lint counts.
                "lint": None,
                "card": _card(dev),
                "cpu_baseline_gbs": round(base_gbs, 4) if base_gbs else None,
                # NOT trace_path: every traced leg (median repeats) rewrites
                # the same trace and run-manifest files, so on disk they
                # describe the LAST completed leg, which may not be the
                # median-selected result above.
                "last_leg_run_manifest": (
                    (dev or {}).get("run_manifest")
                    or os.environ.get("BENCH_RUN_MANIFEST")
                    or None
                ),
                "last_leg_trace": os.environ.get("BENCH_TRACE") or None,
            },
        )
        if dev is not None and dev.get("stats"):
            manifest["stats"] = dev["stats"]
            manifest["phase_seconds"] = dev["info"].get("phases", {})
        telemetry.write_manifest(path, manifest)
        print(f"bench manifest: {path}", file=sys.stderr)
    except Exception as e:
        print(f"bench manifest write failed: {e!r}", file=sys.stderr)


def _take_flag(argv: list, flag: str) -> str | None:
    """Pop `flag VALUE` from argv (the legs' positional dispatch below must
    not see it). Flag values travel to subprocess legs as env vars."""
    if flag in argv:
        i = argv.index(flag)
        if i + 1 >= len(argv):
            raise SystemExit(f"{flag} needs a value")
        v = argv[i + 1]
        del argv[i:i + 2]
        return v
    return None


def _take_switch(argv: list, flag: str) -> bool:
    """Pop a valueless `flag` from argv (same contract as _take_flag)."""
    if flag in argv:
        argv.remove(flag)
        return True
    return False


if __name__ == "__main__":
    _argv = sys.argv[1:]
    _trace = _take_flag(_argv, "--trace")
    if _trace:
        os.environ["BENCH_TRACE"] = str(pathlib.Path(_trace).resolve())
    _manifest = _take_flag(_argv, "--manifest")
    if _manifest:
        _mp = pathlib.Path(_manifest).resolve()
        os.environ["BENCH_MANIFEST"] = str(_mp)
        # The measured device-leg run writes its OWN run manifest beside
        # the bench-level one, so the two never clobber each other.
        os.environ.setdefault(
            "BENCH_RUN_MANIFEST", str(_mp.with_name(_mp.stem + "-run.json"))
        )
    _sort_leg = _take_switch(_argv, "--sort-leg")
    _legs = {
        "--device-leg": lambda a: device_leg(a),
        "--micro": lambda a: micro_leg(),
        "--metrics-overhead": lambda a: metrics_overhead_leg(a),
        "--profile-overhead": lambda a: profile_overhead_leg(a),
        "--lineage-overhead": lambda a: lineage_overhead_leg(a),
        "--zipf": lambda a: zipf_leg(int(a)),
        "--zipf-ii": lambda a: zipf_ii_leg(int(a)),
        "--sort": lambda a: sort_leg(int(a)),
    }
    if _sort_leg and not _argv:
        try:
            sort_leg_main()
        except SystemExit:
            raise
        except BaseException as e:  # one JSON line, like the main harness
            print(json.dumps({
                "metric": "global sort over Zipf corpus",
                "unit": "s", "value": None,
                "error": f"sort-leg harness: {e!r}",
            }))
            raise SystemExit(1)
    elif len(_argv) == 2 and _argv[0] in _legs:
        _legs[_argv[0]](_argv[1])
    elif _argv:
        # bench.py's other modes (the service leg, chaos, the sweeps, the
        # dispatch A/B, the model leg) and its flags are not ported yet.
        raise SystemExit(f"bench_torch.py: unknown arguments {_argv} (bench.py's "
                         "other modes are not ported)")
    else:
        try:
            main()
        except SystemExit:
            raise
        except BaseException as e:  # the JSON line survives ANY failure
            print(json.dumps({
                "metric": "word_count GB/s end-to-end",
                "value": None, "unit": "GB/s", "vs_baseline": None,
                "error": f"bench harness: {e!r}",
            }))
            raise SystemExit(1)

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

Also ``bench.py``'s other modes, each printing its own JSON line with
``bench.py``'s keys and exit codes and appending its history rows:
``--sort-leg`` (global sort over the Zipf corpus, exact and ordered),
``--zipf-ii MB`` (inverted index over an 8-document Zipf corpus, exact
against the presence matrix), ``--model-leg`` (the control-plane model
checker's schedules per second; torch-free, in this process), the four
sweeps ``--sweep-host-workers``, ``--sweep-fold-shards``,
``--sweep-spill-budget`` and ``--sweep-dispatch-fill``, ``--dispatch-ab``,
``--chaos`` (the seeded fault matrix over a coordinator and two workers,
then the slow-disk and slow-dispatch pairs) and ``--service-leg`` /
``--sched-ab`` (the job service and two workers). A mode that needs the
card checks for it before it starts a process, and without one prints its
line with no number and an ``error``, and exits 1.

Engines: the host-worker, fold-shard and dispatch-fill sweeps and
``--dispatch-ab`` vary knobs that exist only on the host engine, so their
legs run ``BENCH_MAP_ENGINE=host`` (the card still runs every packed
merge); the spill-budget sweep keeps the caller's engine. The chaos and
service workers run the device engine on the card unless
``BENCH_MAP_ENGINE=host`` names the host engine; the slow pairs run the
host engine, whose dispatches and spill writes the seeded delays target.
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


def model_leg() -> None:
    """``bench_torch.py --model-leg``: the control-plane model checker's
    exploration throughput — the lease and pipeline foci at a fixed
    budget, depth and seed, in this process (``analysis/mrmodel.py`` is
    torch-free, so the platform is the CPU). Appends one history row with
    model_schedules_per_s and explored/pruned. Prints ONE JSON line; exit
    1 when a focus finds a counterexample."""
    from mapreduce_rust_tpu_torch.analysis.mrmodel import run_model

    budget = int(os.environ.get("BENCH_MODEL_BUDGET", "1500"))
    depth = int(os.environ.get("BENCH_MODEL_DEPTH", "12"))
    docs = {f: run_model(focus=f, budget=budget, depth=depth, seed=0)
            for f in ("lease", "pipeline")}
    explored = sum(d["explored"] for d in docs.values())
    elapsed = sum(d["elapsed_s"] for d in docs.values())
    ok = all(d["ok"] for d in docs.values())
    result: dict = {
        "metric": f"mrmodel exploration, lease+pipeline foci at "
                  f"budget {budget} depth {depth}",
        "unit": "schedules/s",
        "value": None,  # the GB/s trend series must never mix in these
        "platform": "cpu",
        "model_schedules_per_s": (round(explored / elapsed, 1)
                                  if elapsed > 0 else None),
        "model_explored": explored,
        "model_pruned": sum(d["pruned"] for d in docs.values()),
        "model_steps": sum(d["steps"] for d in docs.values()),
        "model_ok": ok,
        "model_counterexamples": [
            {"focus": f, "code": c["code"], "chaos_spec": c["chaos_spec"]}
            for f, d in docs.items() for c in d["counterexamples"]
        ],
    }
    _append_history(result)
    print(json.dumps(result))
    if not ok:
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
    from mapreduce_rust_tpu_torch.ops.cuda_build import BUILD_LOG, build_totals
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
        "kernel_builds": build_totals(builds),
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


def _need_card() -> None:
    """Raise unless the legs can run where BENCH_DEVICE asks: the card, or
    the CPU only when it is named. Every mode that needs the card calls it
    before it starts a process, so without one it starts none."""
    if DEVICE == "cpu":
        return
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available: this mode runs on the card "
                           "(BENCH_DEVICE=cpu runs it on the CPU)")


def _build_libraries() -> None:
    """Build, or find built, every library a worker loads (the native host
    library, and the CUDA kernels unless the legs run on the CPU), so that
    no worker builds under a lease and each worker's kernel_builds holds
    hits only."""
    from mapreduce_rust_tpu_torch.native.host import get_lib

    get_lib()
    if DEVICE != "cpu":
        from mapreduce_rust_tpu_torch.ops.cuda_build import CSRC_DIR, build_all

        build_all(sorted(p.name for p in CSRC_DIR.glob("*.cu")))


def _leg_platform(engine: str) -> str:
    """Where a fleet's map tasks ran: the card for device-engine workers
    unless the legs run on the CPU by name; host-engine workers map on
    the host's cores."""
    return "cuda" if engine == "device" and DEVICE != "cpu" else "cpu"


def _parse_sweep_counts(spec: str, flag: str, typ=int) -> list:
    """Comma-separated sweep points. ``typ=float`` for fraction sweeps
    (--sweep-dispatch-fill) — those must land in (0, 1]; integer sweeps
    stay >= 1."""
    counts = []
    for tok in spec.split(","):
        tok = tok.strip()
        if tok:
            n = typ(tok)
            if (typ is int and n < 1) or (typ is float and not 0 < n <= 1):
                raise SystemExit(f"{flag}: bad count {n}")
            counts.append(n)
    if not counts:
        raise SystemExit(
            f"{flag} needs counts, e.g. "
            + ("0.25,0.5,0.9" if typ is float else "1,2,4")
        )
    return counts


def _run_sweep(counts: list, env_var: str, file_prefix: str, point_key: str,
               metric_label: str, manifest_cfg_key: str, point_stats,
               engine: "str | None" = None,
               mode: str = "--device-leg", corpus=None,
               manifest_env: str = "BENCH_RUN_MANIFEST",
               gbs_of=None, timeout_s: "int | None" = None,
               corpus_label: "str | None" = None) -> None:
    """THE sweep harness the four sweeps share: one measured leg per count
    with ``env_var`` riding into the subprocess and each leg writing its
    own run manifest under BENCH_DIR/sweep/ (run-{prefix}{n}.json), so
    scaling curves come from structured files. ``engine`` pins every
    leg's BENCH_MAP_ENGINE (None keeps the caller's). Prints ONE JSON
    line: the curve with per-point GB/s plus what ``point_stats(stats)``
    extracts, anchored to the FIRST count, and the engine and platform
    the legs ran on."""
    _need_card()
    if corpus is None:
        corpus = build_corpus(TARGET_MB)
    if gbs_of is None:
        gbs_of = lambda res: res.get("gbs")  # noqa: E731
    engine = engine or _map_engine()
    sweep_dir = BENCH_DIR / "sweep"
    sweep_dir.mkdir(parents=True, exist_ok=True)
    curve = []
    platform = "none"
    for n in counts:
        env = dict(os.environ)
        env["BENCH_MAP_ENGINE"] = engine
        env[env_var] = str(n)
        env[manifest_env] = str(sweep_dir / f"run-{file_prefix}{n}.json")
        if env.get("BENCH_TRACE"):
            # Per-leg trace files: one shared --trace path would be
            # rewritten by every leg and end up holding only the last.
            env["BENCH_TRACE"] = str(sweep_dir / f"trace-{file_prefix}{n}.json")
        res, err = _run_device_leg(
            corpus, timeout_s or DEVICE_TIMEOUT_S, env,
            init_timeout_s=PROBE_TIMEOUT_S, mode=mode,
        )
        point: dict = {point_key: n, "manifest": env[manifest_env]}
        if res is None:
            point["error"] = err
        else:
            platform = (res.get("info") or res.get("zipf") or {}).get("platform", platform)
            gbs = gbs_of(res)
            if gbs is not None:
                point["gbs"] = round(gbs, 4)
            point.update(point_stats(res.get("stats") or {}))
        curve.append(point)
        print(f"sweep {file_prefix}={n}: {json.dumps(point)}", file=sys.stderr)
    # Anchor strictly to the FIRST requested count: if that leg failed,
    # every speedup is null — a ratio against some other surviving count
    # would silently misstate the scaling claim the field names.
    base = curve[0].get("gbs")
    result = {
        "metric": f"word_count GB/s vs {metric_label} "
                  f"({corpus_label or f'{TARGET_MB}MB corpus'}, "
                  f"{engine} engine, counts {counts})",
        "unit": "GB/s",
        "sweep": curve,
        "speedup_vs_first": [
            round(p["gbs"] / base, 2) if p.get("gbs") and base else None
            for p in curve
        ],
        "map_engine": engine,
        "platform": platform,
    }
    mp = os.environ.get("BENCH_MANIFEST")
    if mp:
        # --manifest in sweep mode: the curve itself is the run's result.
        try:
            from mapreduce_rust_tpu_torch.runtime import telemetry

            telemetry.write_manifest(mp, telemetry.build_manifest(
                {manifest_cfg_key: counts, "target_mb": TARGET_MB,
                 "map_engine": engine, "device": DEVICE},
                extra={"kind": "bench_sweep_manifest", "result": result},
            ))
            print(f"sweep manifest: {mp}", file=sys.stderr)
        except Exception as e:  # best-effort, like _write_bench_manifest
            print(f"sweep manifest write failed: {e!r}", file=sys.stderr)
    print(json.dumps(result))


def sweep_host_workers(spec: str) -> None:
    """`--sweep-host-workers 1,2,4`: the scan fan-out scaling curve, one
    run manifest per worker count, on the host engine (the only one with
    scan workers)."""

    def point_stats(s: dict) -> dict:
        split = s.get("host_map_split") or {}
        return {
            "bottleneck": s.get("bottleneck"),
            "host_map_s": s.get("host_map_s"),
            "scan_wait_s": s.get("scan_wait_s"),
            "scan_parallelism": split.get("scan_parallelism"),
        }

    _run_sweep(
        _parse_sweep_counts(spec, "--sweep-host-workers"),
        "BENCH_HOST_WORKERS", "w", "workers", "host-map workers",
        "sweep_counts", point_stats, engine="host",
    )


def sweep_fold_shards(spec: str) -> None:
    """`--sweep-fold-shards 1,2,4`: the egress-fold scaling curve, one run
    manifest per shard count, on the host engine (the only one with fold
    shards)."""

    def point_stats(s: dict) -> dict:
        split = s.get("fold_split") or {}
        return {
            "bottleneck": s.get("bottleneck"),
            "host_glue_s": s.get("host_glue_s"),
            "fold_stall_s": s.get("fold_stall_s"),
            "fold_parallelism": split.get("fold_parallelism"),
            "fold_balance": split.get("balance"),
        }

    _run_sweep(
        _parse_sweep_counts(spec, "--sweep-fold-shards"),
        "BENCH_FOLD_SHARDS", "s", "fold_shards", "fold shards",
        "sweep_fold_shards", point_stats, engine="host",
    )


def _zipf_sweep(spec: str, typ, flag: str, env_var: str, prefix: str,
                point_key: str, label: str, cfg_key: str, point_stats,
                engine: "str | None") -> None:
    """A sweep of the Zipf leg (budgets engaged, exact against the
    generator) once per point."""
    zipf_mb = int(os.environ.get("BENCH_ZIPF_MB", "256"))
    _run_sweep(
        _parse_sweep_counts(spec, flag, typ=typ), env_var, prefix, point_key,
        f"{label} (zipf leg)", cfg_key, point_stats, engine=engine,
        mode="--zipf", corpus=pathlib.Path(str(zipf_mb)),
        manifest_env="BENCH_ZIPF_RUN_MANIFEST",
        gbs_of=lambda res: (res.get("zipf") or {}).get("gbs"),
        timeout_s=int(os.environ.get("BENCH_ZIPF_TIMEOUT_S", "420")),
        corpus_label=f"{zipf_mb}MB zipf corpus",
    )


def sweep_spill_budget(spec: str) -> None:
    """`--sweep-spill-budget 131072,262144,524288`: the spill tiers'
    pressure curve — the Zipf leg once per dictionary budget, the budget
    riding in as BENCH_SPILL_BUDGET_WORDS, on the caller's engine (the
    device engine by default, so each leg launches the scan kernel).
    Smaller budget = more, smaller runs = more writer handoffs and a wider
    egress fan-in; the per-point spill_split says whether the async writer
    still hides the disk (stall_s ~ 0)."""

    def point_stats(s: dict) -> dict:
        split = s.get("spill_split") or {}
        return {
            "bottleneck": s.get("bottleneck"),
            "wall_s": s.get("wall_seconds"),
            "spill_write_s": split.get("write_s"),
            "spill_stall_s": split.get("stall_s"),
            "dict_runs": split.get("dict_runs"),
            "merge_fanin": split.get("merge_fanin"),
        }

    _zipf_sweep(spec, int, "--sweep-spill-budget", "BENCH_SPILL_BUDGET_WORDS",
                "b", "budget_words", "dictionary spill budget",
                "sweep_spill_budget", point_stats, engine=None)


def sweep_dispatch_fill(spec: str) -> None:
    """`--sweep-dispatch-fill 0.25,0.5,0.9`: the dispatch plane's
    coalescing curve — the Zipf leg once per dispatch_fill_frac, riding in
    as BENCH_DISPATCH_FILL, on the host engine (the only one with a
    dispatch plane). Lower fill = more, emptier merges; higher = fewer,
    fuller device hops."""

    def point_stats(s: dict) -> dict:
        split = s.get("dispatch_split") or {}
        return {
            "bottleneck": s.get("bottleneck"),
            "wall_s": s.get("wall_seconds"),
            "dispatch_s": split.get("dispatch_s"),
            "dispatch_stall_s": split.get("stall_s"),
            "merge_dispatches": split.get("dispatches"),
            "merge_fill_frac": split.get("fill_frac"),
        }

    _zipf_sweep(spec, float, "--sweep-dispatch-fill", "BENCH_DISPATCH_FILL",
                "f", "dispatch_fill_frac", "dispatch fill threshold",
                "sweep_dispatch_fill", point_stats, engine="host")


def dispatch_ab_pair() -> None:
    """`--dispatch-ab`: the Zipf spill leg with the FULL dispatch plane
    (async + cross-window coalescing) against the sync path (inline
    dispatch, no coalescing), INTERLEAVED min-of-N per side
    (BENCH_DISPATCH_AB_REPEATS, 3) so machine drift hits both sides. On
    the host engine, the only one with a dispatch plane; its merges run
    on the card. One JSON line + one history row with both walls and the
    speedup; exactness is enforced inside every leg (exit 3)."""
    _need_card()
    zipf_mb = int(os.environ.get("BENCH_ZIPF_MB", "256"))
    repeats = int(os.environ.get("BENCH_DISPATCH_AB_REPEATS", "3"))
    timeout = int(os.environ.get("BENCH_ZIPF_TIMEOUT_S", "420"))
    sides: dict = {"plane": [], "pr10": []}
    errors: list[str] = []
    for r in range(repeats):
        for side in ("plane", "pr10"):  # interleaved: drift hits both
            env = dict(os.environ, BENCH_MAP_ENGINE="host")
            if side == "pr10":
                env["MR_DISPATCH_SYNC"] = "1"
                env["BENCH_DISPATCH_COALESCE"] = "0"
            res, err = _run_device_leg(
                pathlib.Path(str(zipf_mb)), timeout, env,
                init_timeout_s=PROBE_TIMEOUT_S, mode="--zipf",
            )
            if res is None:
                errors.append(f"{side}[{r}]: {err}")
                continue
            sides[side].append(res.get("zipf") or {})
            print(f"dispatch-ab {side}[{r}]: "
                  f"wall={sides[side][-1].get('wall_s')}s",
                  file=sys.stderr)

    def best(rows: list) -> dict | None:
        rows = [r for r in rows if r.get("wall_s")]
        return min(rows, key=lambda r: r["wall_s"]) if rows else None

    a, b = best(sides["plane"]), best(sides["pr10"])
    speedup = (
        round(b["wall_s"] / a["wall_s"], 3) if a and b else None
    )
    pick = lambda r: None if r is None else {  # noqa: E731
        k: r.get(k) for k in (
            "wall_s", "gbs", "bottleneck", "dispatch_mode", "dispatch_s",
            "dispatch_stall_s", "merge_dispatches", "merge_fill_frac",
            "spill_stall_s",
        )
    }
    platform = (a or b or {}).get("platform", "none")
    result = {
        "metric": f"zipf dispatch-plane A/B ({zipf_mb}MB, host engine, "
                  f"async+coalesce vs sync uncoalesced, interleaved "
                  f"min-of-{repeats})",
        "unit": "x",
        "value": speedup,
        "plane": pick(a),
        "pr10": pick(b),
        "map_engine": "host",
        "platform": platform,
    }
    if errors:
        result["error"] = "; ".join(errors)
    _append_history({
        "metric": result["metric"],
        "value": speedup,
        "unit": "x",
        "platform": platform,
        "map_engine": "host",
        "zipf": a or {},
        "dispatch_ab": {"plane": pick(a), "pr10": pick(b)},
        "error": result.get("error"),
    })
    print(json.dumps(result))
    if a is None or b is None:
        raise SystemExit(1)


#: Runs per side of each slow pair, interleaved (async, sync, sync, async):
#: scheduling noise only ever adds to a wall, so each side's fastest run is
#: its estimate, as in the overhead pairs and --dispatch-ab.
_PAIR_RUNS = 2


def _slow_pair(name: str, dev: tuple, path: str, base, knob: str, spec: str,
               fired, side_stats) -> None:
    """The body of the two chaos pairs, on ``dev`` = (platform, device
    name) from the leg's ``_leg_device``: a chaos-free warm-up on a
    one-window prefix (libraries load, the allocator warms), then the SAME
    budgeted job under the seeded ``spec`` with ``knob`` on (async) and
    off (sync), _PAIR_RUNS times per side. Outputs must stay bit-identical
    and the fault must fire (else exit 3); ``hidden_s`` = the sync side's
    fastest wall - the async side's."""
    import dataclasses
    import shutil

    from mapreduce_rust_tpu_torch.runtime.driver import run_job

    platform, device_name = dev
    root = pathlib.Path(base.work_dir).parent
    shutil.rmtree(root, ignore_errors=True)
    BENCH_DIR.mkdir(parents=True, exist_ok=True)
    warm = BENCH_DIR / f"warmup-{name.replace('_', '')}.txt"
    with open(path, "rb") as f:
        warm.write_bytes(f.read(base.host_window_bytes + 4096))
    run_job(dataclasses.replace(
        base, work_dir=str(root / "warm-work"),
        output_dir=str(root / "warm-out"),
        # Budgets off: a budgeted run demands write_outputs (streaming
        # egress), and the warm-up exists for the loads only.
        dictionary_budget_words=None, host_accum_budget_mb=None,
    ), [str(warm)], write_outputs=False)

    os.environ["MR_CHAOS"] = spec
    runs: dict = {"async": [], "sync": []}
    outputs: list = []
    for i in range(_PAIR_RUNS):
        order = (("async", True), ("sync", False))
        for side, on in (order if i % 2 == 0 else order[::-1]):
            cfg = dataclasses.replace(
                base, **{knob: on},
                work_dir=str(root / f"work-{side}"),
                output_dir=str(root / f"out-{side}"),
            )
            shutil.rmtree(cfg.output_dir, ignore_errors=True)
            t0 = time.perf_counter()
            res = run_job(cfg, [str(path)])
            runs[side].append({"wall_s": round(time.perf_counter() - t0, 3),
                               **side_stats(res.stats)})
            outputs.append({
                p.name: p.read_bytes()
                for p in sorted(pathlib.Path(cfg.output_dir).glob("mr-*.txt"))
            })
    sides = {side: min(rows, key=lambda r: r["wall_s"]) for side, rows in runs.items()}
    n_fired = len(fired(spec))
    identical = bool(outputs[0]) and all(out == outputs[0] for out in outputs)
    print(json.dumps({
        name: {
            "platform": platform,
            "device_name": device_name,
            "map_engine": base.map_engine,
            "spec": spec,
            "fired": n_fired,
            "runs_per_side": _PAIR_RUNS,
            "async": sides["async"],
            "sync": sides["sync"],
            "walls_s": {side: [r["wall_s"] for r in rows] for side, rows in runs.items()},
            "hidden_s": round(sides["sync"]["wall_s"] - sides["async"]["wall_s"], 3),
            "outputs_identical": identical,
        }
    }))
    if not identical or n_fired == 0:
        raise SystemExit(3)


def slow_dispatch_leg(path: str) -> None:
    """Runs in a subprocess (--slow-dispatch-leg): the SAME word-count job
    under a seeded per-merge-dispatch delay (``slow_dispatch``), async
    dispatch plane against the inline sync path, on the host engine with
    its merges on the card. The async side overlaps the delayed hops with
    the router's fold (stall only when the depth-bounded queue fills); the
    sync side eats every delay on the router's wall. ``path`` is unused:
    the leg builds its own high-cardinality Zipf corpus."""
    dev = _leg_device()

    from mapreduce_rust_tpu_torch.config import Config
    from mapreduce_rust_tpu_torch.runtime.driver import dispatch_chaos_fired

    # Rate-matched injection: a small delay on EVERY dispatch pipelines
    # through the depth-bounded queue, so the async side can hide it
    # behind the router's fold; few-but-large delays cannot show that
    # (the bounded queue caps run-ahead per sleep episode).
    spec = os.environ.get("BENCH_SLOW_DISPATCH_SPEC", "seed=7;slow_dispatch:0.01")
    corpus, _counts = build_zipf_corpus(
        int(os.environ.get("BENCH_SLOW_DISPATCH_MB", "48")))
    root = BENCH_DIR / "slow-dispatch"
    base = Config(
        map_engine="host",
        # Small windows and a small staging cap: the staging buffer
        # crosses its fill threshold once or more per window, so the delay
        # fires a dispatch-rate stream on both sides (coalescing stays on
        # for both: the pair isolates the overlap). The engaged dictionary
        # budget gives the router's fold per-window work of its own.
        host_window_bytes=256 << 10,
        chunk_bytes=1 << 20,
        merge_capacity=1 << 14,          # constant device eviction = compute
        host_update_cap=1 << 13,
        # The fold stays on the router: it is the work the async plane
        # overlaps the delayed hops with. Auto fold shards (1 below 4
        # cores, 4 on an 8-core host) would move it to shard threads and
        # leave the router idle, with nothing to hide the delay behind.
        fold_shards=1,
        dictionary_budget_words=4096,
        host_accum_budget_mb=64,
        reduce_n=4,
        device=DEVICE,
        work_dir=str(root / "work"),
        output_dir=str(root / "out"),
    )
    _slow_pair("slow_dispatch", dev, str(corpus), base, "dispatch_async", spec,
               dispatch_chaos_fired,
               lambda s: {"dispatch_s": round(s.dispatch_s, 3),
                          "dispatch_stall_s": round(s.dispatch_stall_s, 3),
                          "merge_dispatches": s.merge_dispatches,
                          "glue_s": round(s.host_glue_s, 3)})


def slow_disk_leg(path: str) -> None:
    """Runs in a subprocess (--slow-disk-leg): the SAME budgeted
    word-count job under a seeded per-spill-run write delay
    (``slow_disk``), async writer against the sync plane, on the host
    engine with its merges on the card. The async side overlaps the
    delayed writes with scan and merge (stall only when the depth-2
    buffer fills); the sync side eats every delay on the fold thread's
    wall."""
    dev = _leg_device()

    from mapreduce_rust_tpu_torch.config import Config
    from mapreduce_rust_tpu_torch.runtime.spill import chaos_fired

    spec = os.environ.get("BENCH_SLOW_DISK_SPEC", "seed=6;slow_disk:0.25")
    root = BENCH_DIR / "slow-disk"
    base = Config(
        map_engine="host",
        # Small windows: a batch flush fires at most once per window, so
        # window count bounds run count — a steady stream of delayed
        # writes to hide.
        host_window_bytes=1 << 20,
        chunk_bytes=1 << 20,
        merge_capacity=1 << 14,          # constant device eviction = compute
        dictionary_budget_words=1024,    # every new-vocab window flushes
        host_accum_budget_mb=64,
        reduce_n=4,
        device=DEVICE,
        work_dir=str(root / "work"),
        output_dir=str(root / "out"),
    )
    _slow_pair("slow_disk", dev, path, base, "spill_async", spec, chaos_fired,
               lambda s: {"spill_write_s": round(s.spill_s, 3),
                          "spill_stall_s": round(s.spill_stall_s, 3),
                          "runs": s.dict_spill_runs + s.accum_spill_runs})


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_CHAOS_TEXTS = [
    b"the quick brown fox jumps over the lazy dog " * 400,
    b"pack my box with five dozen liquor jugs " * 400,
    b"sphinx of black quartz judge my vow " * 400,
]


def _fleet_env() -> dict:
    """The environment of a fleet's processes: this one's, with the repo
    first on the path."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    return env


def _start(role: str, args: list, env: dict, log_dir: pathlib.Path):
    """One fleet process of the port's CLI, its stderr in
    ``log_dir/{role}.log``."""
    with open(log_dir / f"{role}.log", "wb") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "mapreduce_rust_tpu_torch", *args],
            env=env, cwd=str(REPO), stdout=subprocess.DEVNULL, stderr=log,
        )


def _worker_manifests(manifest: pathlib.Path) -> list[dict]:
    """What each worker's per-process manifest (``manifest-w<pid>.json``
    beside ``manifest``) says it ran: engine, the card's name, its
    tokenize_hash launches, its map-task grants and its kernel builds."""
    rows = []
    for p in sorted(manifest.parent.glob(f"{manifest.stem}-w*.json")):
        try:
            m = json.loads(p.read_text())
        except (OSError, ValueError):
            continue
        tasks = (m.get("report") or {}).get("tasks") or {}
        rows.append({
            "engine": m.get("engine"),
            "device_name": (m.get("platform") or {}).get("device_name"),
            "tokenize_hash": (m.get("kernel_launches") or {}).get("tokenize_hash"),
            "map_grants": sum(t.get("grants", 0) for t in tasks.get("map", {}).values()),
            "kernel_builds": m.get("kernel_builds"),
        })
    return rows


def _chaos_cluster(name: str, work_root: pathlib.Path, chaos_spec: str | None,
                   speculate: bool, timeout_s: int = 120,
                   trace: bool = False, app: str = "word_count",
                   sched: str = "fifo") -> dict:
    """One chaos leg: coordinator + 2 worker OS processes of the port's CLI
    over TCP (the recovery paths under test live in the real renewal and
    report loops). Faults ride in as MR_CHAOS on BOTH workers: the seeded
    spec targets (phase, tid, wid), so which process draws which task
    stays irrelevant. The workers run BENCH_MAP_ENGINE's engine (the
    device engine on the card by default) with ``--device`` BENCH_DEVICE,
    and each writes its manifest beside the coordinator's. Returns wall
    (coordinator exit = job complete), output bytes, the leg dir (``dir``:
    job_report.json and traces live under it), the coordinator manifest
    path for the doctor and the workers' manifests."""
    leg = work_root / name
    docs = leg / "in"
    docs.mkdir(parents=True)
    for i, t in enumerate(_CHAOS_TEXTS):
        (docs / f"doc-{i}.txt").write_bytes(t)
    port = _free_port()
    manifest = leg / "manifest.json"
    engine = _map_engine()
    common = [
        "--input", str(docs), "--output", str(leg / "out"),
        "--work", str(leg / "work"), "--port", str(port), "--reduce-n", "3",
        "--app", app, "--manifest", str(manifest),
        "--lease-timeout", "2.0", "--lease-check-period", "0.3",
        "--renew-period", "0.3", "--poll-retry", "0.05",
    ]
    if sched != "fifo":
        # --sched rides in `common` so the coordinator and BOTH workers
        # agree on the mode.
        common += ["--sched", sched]
    if trace:
        common += ["--trace", str(leg / "trace.json")]
    coord_args = ["coordinator", "--worker-n", "2", *common]
    if speculate:
        coord_args += ["--speculate", "--speculate-after-frac", "0.5"]
    env = _fleet_env()
    worker_env = dict(env)
    if chaos_spec:
        worker_env["MR_CHAOS"] = chaos_spec
    t0 = time.perf_counter()
    coord = _start("coord", coord_args, env, leg)
    workers = [
        _start(f"worker-{i}", ["worker", "--engine", engine, "--device", DEVICE,
                               *common], worker_env, leg)
        for i in range(2)
    ]
    result: dict = {"scenario": name, "speculate": speculate, "sched": sched,
                    "map_engine": engine}
    try:
        rc = coord.wait(timeout=timeout_s)
        result["wall_s"] = round(time.perf_counter() - t0, 3)
        result["recovered"] = rc == 0
        for w in workers:
            try:
                w.wait(timeout=30)
            except subprocess.TimeoutExpired:
                w.kill()
                result["recovered"] = False
    except subprocess.TimeoutExpired:
        result["recovered"] = False
        result["error"] = f"coordinator did not finish within {timeout_s}s"
    finally:
        for p in [coord, *workers]:
            if p.poll() is None:
                p.kill()
                p.wait()
    result["outputs"] = {
        p.name: p.read_bytes()
        for p in sorted((leg / "out").glob("mr-*.txt"))
    }
    # The coordinator writes its manifest under the per-process name
    # (manifest-coord.json): co-hosted processes never clobber each other.
    from mapreduce_rust_tpu_torch.runtime.trace import per_process_path

    coord_manifest = pathlib.Path(per_process_path(str(manifest), "coord"))
    if coord_manifest.exists():
        result["manifest"] = str(coord_manifest)
    result["workers"] = _worker_manifests(manifest)
    result["dir"] = str(leg)
    return result


def _pair_leg(name: str, corpus: pathlib.Path, timeout_env: str,
              mode: str) -> tuple[dict, bool]:
    """Run one slow pair in its subprocess: (its detail dict, passed).
    It passes when it ran, its outputs are identical and the async side
    measurably hid the injected delay the sync side eats (hidden_s > 0)."""
    res, err = _run_device_leg(
        corpus, int(os.environ.get(timeout_env, "300")), None,
        init_timeout_s=PROBE_TIMEOUT_S, mode=mode,
    )
    if res is None:
        return {"error": err}, False
    det = res.get(name) or {}
    hidden = det.get("hidden_s")
    return det, bool(det.get("outputs_identical")) and hidden is not None and hidden > 0


def chaos_legs() -> None:
    """``bench_torch.py --chaos``: the seeded fault-injection matrix
    (analysis/chaos.SCENARIOS) over the port's control plane. Each
    scenario measures recovery cost (wall vs the fault-free baseline),
    checks the outputs stay BIT-IDENTICAL to the fault-free run, runs the
    doctor on the coordinator manifest and ``run_check`` on the leg's
    journal and report (a violation fails the matrix), and appends a
    history row. slow_scan runs with speculation off, then on; a
    pipelined pair (fault-free and kill) follows. Then the slow-disk and
    slow-dispatch pairs, each in its subprocess. Prints ONE JSON line;
    exits 1 if any leg failed to recover, diverged or broke the protocol,
    or a pair hid nothing."""
    import shutil

    from mapreduce_rust_tpu_torch.analysis.chaos import SCENARIOS
    from mapreduce_rust_tpu_torch.analysis.doctor import diagnose
    from mapreduce_rust_tpu_torch.analysis.mrcheck import run_check
    from mapreduce_rust_tpu_torch.runtime.telemetry import load_manifest

    _need_card()
    _build_libraries()
    engine = _map_engine()
    platform = _leg_platform(engine)
    work_root = BENCH_DIR / "chaos"
    shutil.rmtree(work_root, ignore_errors=True)
    legs: list[tuple[str, str | None, bool, str]] = [
        ("baseline", None, False, "fifo"),
    ]
    for name, spec in SCENARIOS.items():
        if name == "slow_scan":
            legs.append(("slow_scan-nospec", spec, False, "fifo"))
            legs.append(("slow_scan-spec", spec, True, "fifo"))
        else:
            legs.append((name, spec, False, "fifo"))
    # Pipelined pair: per-partition reduce release must survive a mid-map
    # re-execution and both legs stay bit-identical to the FIFO baseline.
    legs.append(("baseline-pipeline", None, False, "pipeline"))
    legs.append(("kill-pipeline", SCENARIOS["kill"], False, "pipeline"))
    baseline_outputs = None
    baseline_wall = None
    rows = []
    ok = True
    for name, spec, speculate, sched in legs:
        r = _chaos_cluster(name, work_root, spec, speculate, sched=sched)
        outputs = r.pop("outputs")
        if name == "baseline":
            baseline_outputs, baseline_wall = outputs, r.get("wall_s")
            r["bit_identical"] = bool(outputs)
        else:
            r["bit_identical"] = bool(outputs) and outputs == baseline_outputs
            if baseline_wall is not None and r.get("wall_s") is not None:
                r["recovery_cost_s"] = round(r["wall_s"] - baseline_wall, 3)
        if r.get("manifest"):
            try:
                diag = diagnose(load_manifest(r["manifest"]))
                r["doctor"] = {
                    "findings": [
                        f"[{f['severity']}] {f['code']}: {f['message']}"
                        for f in (diag.get("findings") or [])[:6]
                    ],
                    "speculation": diag.get("speculation"),
                }
            except Exception as e:
                r["doctor"] = {"error": repr(e)}
        # run_check on the leg's control-plane artifacts (journal +
        # job_report under work/) is the matrix's real oracle: matching
        # bytes say nothing about a double-granted lease.
        try:
            cdoc = run_check(str(pathlib.Path(r["dir"]) / "work"))
            r["mrcheck"] = {
                "ok": cdoc["ok"],
                "violations": [
                    f"[{v['code']}] {v['message']}"
                    for v in cdoc["violations"][:6]
                ],
            }
            if not cdoc["ok"]:
                ok = False
        except Exception as e:  # an uncheckable leg is a failed leg
            ok = False
            r["mrcheck"] = {"ok": False, "error": repr(e)}
        ok = ok and r.get("recovered", False) and r["bit_identical"]
        rows.append(r)
        print(f"chaos {name}: wall={r.get('wall_s')}s recovered="
              f"{r.get('recovered')} identical={r['bit_identical']} "
              f"mrcheck={'ok' if r['mrcheck']['ok'] else 'VIOLATION'}",
              file=sys.stderr)
        _append_history({
            "metric": f"chaos recovery ({name})",
            "value": None,  # chaos rows must not pollute the trend series
            "unit": "s",
            "platform": platform,
            "map_engine": engine,
            "doctor": r.get("doctor"),
            "chaos_scenario": name,
            "chaos_wall_s": r.get("wall_s"),
            "chaos_recovery_cost_s": r.get("recovery_cost_s"),
            "chaos_bit_identical": r["bit_identical"],
            "chaos_speculate": speculate,
            "chaos_sched": sched,
            "chaos_mrcheck": r["mrcheck"],
        })
    # The two pairs: the cluster legs run unbudgeted on the device engine,
    # where neither delay fires, so the proof that the async writer and
    # the dispatch thread HIDE them needs budgeted host-engine jobs.
    pairs = {}
    for pname, corpus, timeout_env, mode in (
        ("slow_disk", lambda: build_corpus(min(TARGET_MB, 24)),
         "BENCH_SLOW_DISK_TIMEOUT_S", "--slow-disk-leg"),
        # The leg builds its own Zipf corpus; the argument is unused.
        ("slow_dispatch", lambda: pathlib.Path("zipf-slow-dispatch"),
         "BENCH_SLOW_DISPATCH_TIMEOUT_S", "--slow-dispatch-leg"),
    ):
        try:
            pairs[pname], passed = _pair_leg(pname, corpus(), timeout_env, mode)
        except Exception as e:
            pairs[pname], passed = {"error": repr(e)}, False
        ok = ok and passed
        print(f"chaos {pname} pair: {json.dumps(pairs[pname])}", file=sys.stderr)
        _append_history({
            "metric": f"chaos {pname}: async-vs-sync "
                      f"{'spill' if pname == 'slow_disk' else 'dispatch'} pair",
            "value": None,  # chaos rows stay out of the trend series
            "unit": "s",
            "platform": pairs[pname].get("platform", "none"),
            "map_engine": "host",
            "chaos_scenario": f"{pname}-pair",
            f"chaos_{pname}": pairs[pname],
        })
    nospec = next((r for r in rows if r["scenario"] == "slow_scan-nospec"), None)
    spec = next((r for r in rows if r["scenario"] == "slow_scan-spec"), None)
    result = {
        "metric": "chaos matrix: seeded fault recovery, wall seconds per "
                  f"scenario (coordinator+2 workers, {engine} engine, {platform})",
        "unit": "s",
        "ok": ok,
        "baseline_wall_s": baseline_wall,
        "scenarios": rows,
        "slow_disk_pair": pairs["slow_disk"],
        "slow_dispatch_pair": pairs["slow_dispatch"],
        "speculation_speedup": (
            round(nospec["wall_s"] / spec["wall_s"], 2)
            if nospec and spec and nospec.get("wall_s") and spec.get("wall_s")
            else None
        ),
        "map_engine": engine,
        "platform": platform,
    }
    print(json.dumps(result))
    if not ok:
        raise SystemExit(1)


def _service_run(k_jobs: int, sched: str, root: pathlib.Path,
                 docs_n: int = 3, scale: int = 1) -> dict:
    """One service cluster run over the mixed two-wave matrix: one
    OS-process service (torch-free) + 2 service workers of the port's CLI
    under ``--sched {sched}``, the workers on BENCH_MAP_ENGINE's engine
    (the device engine on the card by default), each with a manifest; a
    stream of K mixed submissions (three distinct (app, corpus) triples
    cycled, so repeats past the first cycle are cache hits). Measures
    jobs/minute, queue-wait p95 and the cache hit rate; run_check over the
    service work root fails the run on a violation; the fleet profiler
    adds the bubble fraction and pipelining opportunity. Returns the
    result dict WITHOUT printing or touching history — shared by
    --service-leg and --sched-ab."""
    import asyncio
    import shutil

    from mapreduce_rust_tpu_torch.analysis.mrcheck import run_check
    from mapreduce_rust_tpu_torch.runtime.histogram import Histogram

    shutil.rmtree(root, ignore_errors=True)
    corpora = []
    for ci in range(3):
        d = root / f"corpus-{ci}"
        d.mkdir(parents=True)
        # docs_n/scale size the per-job map wave and per-task weight: the
        # default is the tiny matrix; the sched A/B needs real phase
        # windows or the scheduling delta drowns in process startup.
        for i in range(max(3, docs_n)):
            t = _CHAOS_TEXTS[i % len(_CHAOS_TEXTS)] * max(1, scale)
            # Distinct corpora (distinct digests): a per-corpus marker
            # token repeated ci+1 times; a per-doc token keeps repeated
            # texts from collapsing into identical files.
            (d / f"doc-{i}.txt").write_bytes(
                t + f"doc{i} ".encode()
                + (f"corpusmark{ci} " * (ci + 1)).encode()
            )
        corpora.append(str(d))
    # Three distinct (app, corpus, config) triples: every submission past
    # the first cycle is an exact repeat and must hit the result cache.
    triples = [
        {"app": "word_count", "input_dir": corpora[0], "reduce_n": 3},
        {"app": "inverted_index", "input_dir": corpora[1], "reduce_n": 2},
        {"app": "word_count", "input_dir": corpora[2], "reduce_n": 3},
    ]
    port = _free_port()
    env = _fleet_env()
    engine = _map_engine()
    manifest = root / "manifest.json"
    common = [
        "--input", corpora[0], "--output", str(root / "out"),
        "--work", str(root / "work"), "--port", str(port),
        "--lease-timeout", "5.0", "--lease-check-period", "0.3",
        "--renew-period", "0.3", "--poll-retry", "0.05",
        # The service AND its workers agree on the scheduling mode.
        "--sched", sched,
    ]
    svc = _start("service", ["service", "--max-jobs", "3", *common], env, root)
    workers = [
        _start(f"worker-{i}", ["worker", "--service", "--engine", engine,
                               "--device", DEVICE, "--manifest", str(manifest),
                               *common], env, root)
        for i in range(2)
    ]
    platform = _leg_platform(engine)
    result: dict = {
        "metric": "job service: K mixed submissions, jobs/minute "
                  f"(service+2 workers, {engine} engine, {platform})",
        "unit": "jobs/min", "k_jobs": k_jobs, "sched": sched,
        "map_engine": engine, "platform": platform,
    }
    ok = True
    try:
        async def drive() -> dict:
            from mapreduce_rust_tpu_torch.coordinator.server import CoordinatorClient

            client = CoordinatorClient("127.0.0.1", port, timeout_s=15.0)
            await client.connect(retries=100, delay=0.1, budget_s=20.0)
            deadline = time.perf_counter() + int(
                os.environ.get("BENCH_SERVICE_TIMEOUT_S", "300")
            )
            jids: list = []
            states: dict = {}

            async def submit(spec) -> None:
                res = await client.call("submit_job", spec)
                if not res.get("ok"):
                    raise RuntimeError(f"submit rejected: {res}")
                jids.append(res["job"])

            async def wait_done() -> None:
                nonlocal states
                while time.perf_counter() < deadline:
                    view = await client.call("stats")
                    states = {j["job"]: j["state"] for j in view["jobs"]}
                    if all(states.get(j) == "done" for j in jids):
                        return
                    await asyncio.sleep(0.2)

            t0 = time.perf_counter()
            # Wave 1: the three distinct triples — real compute. Wave 2
            # (after wave 1 settles): every remaining submission repeats a
            # triple, so the expected cache-hit count is EXACT (K-3).
            for i in range(min(3, k_jobs)):
                await submit(triples[i % 3])
            await wait_done()
            for i in range(3, k_jobs):
                await submit(triples[i % 3])
            await wait_done()
            wall_s = time.perf_counter() - t0
            view = await client.call("stats")
            await client.call("shutdown")
            await client.close()
            return {"wall_s": wall_s, "states": states, "view": view}

        out = asyncio.run(drive())
        states = out["states"]
        completed = sum(1 for j in states.values() if j == "done")
        ok = completed == k_jobs
        sv = out["view"]["service"]
        cache = sv["cache"]
        lookups = cache["hits"] + cache["misses"]
        qh = Histogram.from_dict(sv["queue_wait_s"])
        result.update({
            "value": round(completed / (out["wall_s"] / 60.0), 2),
            "wall_s": round(out["wall_s"], 3),
            "completed": completed,
            "cache_hits": cache["hits"],
            "cache_hit_rate": (
                round(cache["hits"] / lookups, 3) if lookups else None
            ),
            "queue_wait_p95_s": (
                round(qh.percentile(0.95) or 0.0, 3) if qh.count else None
            ),
        })
        # The expected hit count is exact: a lower number = the cache broke.
        expected_hits = max(k_jobs - 3, 0)
        if cache["hits"] < expected_hits:
            ok = False
            result["error"] = (
                f"cache hits {cache['hits']} < expected {expected_hits}"
            )
    except Exception as e:
        ok = False
        result["error"] = repr(e)
    finally:
        for p in [svc, *workers]:
            # The shutdown sends the workers DONE: let them write their
            # manifests before a terminate (a drain) or a kill.
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                try:
                    p.terminate()
                    p.wait(timeout=20)
                except (OSError, subprocess.TimeoutExpired):
                    p.kill()
                    p.wait()
    result["workers"] = _worker_manifests(manifest)
    # run_check over the whole service work root (every job's journal +
    # report): the leg's conformance oracle.
    try:
        cdoc = run_check(str(root / "work"))
        result["mrcheck"] = {
            "ok": cdoc["ok"],
            "jobs": cdoc["checked"].get("jobs"),
            "violations": [
                f"[{v['code']}] {v['message']}"
                for v in cdoc["violations"][:6]
            ],
        }
        ok = ok and cdoc["ok"]
    except Exception as e:  # an uncheckable leg is a failed leg
        ok = False
        result["mrcheck"] = {"ok": False, "error": repr(e)}
    # Fleet profiler over the same work root: cross-job utilization,
    # barrier-bubble fraction and the per-job pipelining opportunity.
    # Post-mortem only, so a profiler failure degrades to nulls.
    try:
        from mapreduce_rust_tpu_torch.runtime.fleet import (
            build_fleet_report,
            fleet_history_row,
        )

        result.update(fleet_history_row(build_fleet_report(str(root / "work"))))
    except Exception as e:
        result["fleet_error"] = repr(e)
    result["ok"] = ok
    return result


def _service_history(result: dict, sched: str, k_jobs: int, metric: str,
                     unit: str = "jobs/min", **extra) -> None:
    """The history row of a service run: its jobs/min, queue-wait p95 and
    cache-hit rate under the service_ keys (value None: jobs/min has its
    own trend series), its fleet_ and pipelining_ keys."""
    _append_history({
        "metric": metric,
        "value": None,
        "unit": unit,
        "platform": result.get("platform"),
        "map_engine": result.get("map_engine"),
        "service_sched": sched,
        "service_jobs_per_min": result.get("value"),
        "service_queue_wait_p95_s": result.get("queue_wait_p95_s"),
        "service_cache_hit_rate": result.get("cache_hit_rate"),
        "service_k_jobs": k_jobs,
        "service_mrcheck": result.get("mrcheck"),
        **{k: v for k, v in result.items()
           if k.startswith(("fleet_", "pipelining_"))},
        **extra,
    })


def service_leg(k_jobs: int | None = None) -> None:
    """``bench_torch.py --service-leg``: continuous-traffic throughput of
    the multi-tenant job service — one _service_run over the mixed
    two-wave matrix, recorded into the history. BENCH_SERVICE_SCHED=
    pipeline runs it under the pipelined scheduler; the A/B pair is
    ``--sched-ab``. Prints ONE JSON line; exit 1 on failure."""
    _need_card()
    _build_libraries()
    k_jobs = k_jobs or int(os.environ.get("BENCH_SERVICE_JOBS", "12"))
    sched = os.environ.get("BENCH_SERVICE_SCHED", "fifo")
    result = _service_run(k_jobs, sched, BENCH_DIR / "service")
    _service_history(result, sched, k_jobs, result["metric"], error=result.get("error"))
    print(json.dumps(result))
    if not result["ok"]:
        raise SystemExit(1)


def service_sched_ab(k_jobs: int | None = None) -> None:
    """``bench_torch.py --sched-ab``: the SAME mixed two-wave matrix under
    ``--sched fifo`` and ``--sched pipeline``, sides INTERLEAVED per repeat
    (BENCH_SCHED_AB_REPEATS, 1) so machine drift hits both. Best repeat per
    side by jobs/min; one JSON line + ONE history row with both sides (the
    pipeline side feeds the watched service_ series). Correctness (all
    jobs done, exact cache-hit count, run_check clean) fails the pair; the
    throughput delta is recorded, not gated."""
    _need_card()
    _build_libraries()
    k_jobs = k_jobs or int(os.environ.get("BENCH_SERVICE_JOBS", "12"))
    repeats = int(os.environ.get("BENCH_SCHED_AB_REPEATS", "1"))
    # Heavier matrix than the single leg's: enough docs (map tasks) and
    # bytes per task that phase windows are real and barrier bubbles
    # exist for the pipeline side to fill.
    docs_n = int(os.environ.get("BENCH_SCHED_AB_DOCS", "12"))
    scale = int(os.environ.get("BENCH_SCHED_AB_SCALE", "8"))
    sides: dict = {"fifo": [], "pipeline": []}
    ok = True
    for rep in range(repeats):
        for sched in ("fifo", "pipeline"):  # interleaved: drift hits both
            try:
                res = _service_run(
                    k_jobs, sched, BENCH_DIR / f"service-ab-{sched}",
                    docs_n=docs_n, scale=scale,
                )
            except Exception as e:
                res = {"ok": False, "error": repr(e), "sched": sched}
            ok = ok and bool(res.get("ok"))
            sides[sched].append(res)
            print(
                f"sched-ab {sched}[{rep}]: jobs/min={res.get('value')} "
                f"queue_p95={res.get('queue_wait_p95_s')}s "
                f"bubble={res.get('fleet_bubble_frac')} "
                f"pipelining_opp={res.get('pipelining_opportunity_s')}s "
                f"ok={res.get('ok')}",
                file=sys.stderr,
            )

    def best(rows: list) -> dict:
        scored = [r for r in rows if r.get("value")]
        return max(scored or rows, key=lambda r: r.get("value") or 0.0)

    f, p = best(sides["fifo"]), best(sides["pipeline"])
    pick = lambda r: {  # noqa: E731
        k: r.get(k) for k in (
            "value", "wall_s", "queue_wait_p95_s", "cache_hit_rate",
            "fleet_bubble_frac", "fleet_util_frac",
            "pipelining_opportunity_s", "ok", "error", "completed",
            "cache_hits", "mrcheck", "workers",
        )
    }
    speedup = (
        round(p["value"] / f["value"], 3)
        if p.get("value") and f.get("value") else None
    )
    engine = _map_engine()
    result = {
        "metric": f"service sched A/B ({k_jobs} mixed jobs, fifo vs "
                  f"pipeline, {engine} engine, interleaved best-of-{repeats})",
        "unit": "x",
        "value": speedup,
        "fifo": pick(f),
        "pipeline": pick(p),
        "ok": ok,
        "k_jobs": k_jobs,
        "docs": docs_n,
        "map_engine": engine,
        "platform": _leg_platform(engine),
    }
    # The pipeline side feeds the watched series: it is the configuration
    # the scheduling plane ships with.
    _service_history(p, "pipeline", k_jobs, result["metric"], unit="x",
                     service_sched_ab={"fifo": pick(f), "pipeline": pick(p)},
                     service_sched_speedup=speedup)
    print(json.dumps(result))
    if not ok:
        raise SystemExit(1)


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
        # Chaos, service, sort, fleet and model rows carry their own fields
        # verbatim; their "value" stays None so the GB/s series never
        # mixes in recovery walls or jobs per minute.
        line.update({
            k: v for k, v in result.items()
            if k.startswith(("chaos_", "service_", "sort_", "fleet_",
                             "pipelining_", "model_", "dispatch_ab"))
        })
        if result.get("chaos_scenario"):
            line["doctor_findings"] = [
                f.split(": ", 1)[0]
                for f in ((result.get("doctor") or {}).get("findings") or [])
            ]
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


def _lint_counts() -> dict:
    """Run the port's torch-free mrlint analyzer and reduce its JSON report
    to the counts a bench trajectory diffs (a regressing rule shows up in
    the manifest) — bench.py's block, from the port's linter. Best effort:
    a broken linter is itself a recorded fact, never a lost bench."""
    try:
        r = subprocess.run(
            [sys.executable, "-m", "mapreduce_rust_tpu_torch", "lint",
             "--format", "json"],
            capture_output=True, text=True, timeout=120, cwd=str(REPO),
        )
        doc = json.loads(r.stdout)
        return {
            "ok": doc.get("ok"),
            "exit_code": r.returncode,
            "findings": len(doc.get("findings", [])),
            "files_checked": doc.get("files_checked"),
            "rules": len(doc.get("rules", [])),
            "suppressed_inline": doc.get("suppressed_inline"),
            "suppressed_baseline": doc.get("suppressed_baseline"),
            "unused_baseline_entries": len(
                doc.get("unused_baseline_entries", [])
            ),
        }
    except Exception as e:
        return {"error": repr(e)}


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
                "lint": _lint_counts(),
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


def _one_line(run, fail: dict, tag: str, catch_exit: bool = False) -> None:
    """Run a mode so that its ONE JSON line survives any failure: when it
    raises, print ``fail`` with the error and exit 1. A SystemExit passes
    through (the mode printed its line first) unless ``catch_exit``: a
    sweep's bad counts are a usage error that still gets its line."""
    try:
        run()
    except BaseException as e:
        if isinstance(e, SystemExit) and not catch_exit:
            raise
        print(json.dumps({**fail, "error": f"{tag} harness: {e!r}"}))
        raise SystemExit(1)


if __name__ == "__main__":
    _argv = sys.argv[1:]
    if _take_switch(_argv, "--sanitize"):
        # Thread-ownership sanitizer on every leg and fleet process: the
        # env var rides into every child environment.
        os.environ["MR_SANITIZE"] = "1"
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
    for _flag, _var in (("--host-workers", "BENCH_HOST_WORKERS"),
                        ("--fold-shards", "BENCH_FOLD_SHARDS")):
        _v = _take_flag(_argv, _flag)
        if _v:
            # A bad value is a usage error here, not an opaque traceback
            # in every leg's subprocess.
            if not _v.isdigit() or int(_v) < 1:
                raise SystemExit(f"{_flag} needs a positive integer, got {_v!r}")
            os.environ[_var] = _v
    if _take_switch(_argv, "--sync-spill"):
        os.environ["MR_SPILL_SYNC"] = "1"  # the inline spill writer, every leg
    if _take_switch(_argv, "--sync-dispatch"):
        os.environ["MR_DISPATCH_SYNC"] = "1"  # inline merge dispatch, every leg
    _chaos = _take_switch(_argv, "--chaos")
    _sched_ab = _take_switch(_argv, "--sched-ab")
    _service_leg = _take_switch(_argv, "--service-leg") or _sched_ab
    _sort_leg = _take_switch(_argv, "--sort-leg")
    _model_leg = _take_switch(_argv, "--model-leg")
    _sweeps = [
        (_take_flag(_argv, flag), fn, label)
        for flag, fn, label in (
            ("--sweep-host-workers", sweep_host_workers,
             "word_count GB/s vs host-map workers"),
            ("--sweep-fold-shards", sweep_fold_shards,
             "word_count GB/s vs fold shards"),
            ("--sweep-spill-budget", sweep_spill_budget,
             "zipf GB/s vs dictionary spill budget"),
            ("--sweep-dispatch-fill", sweep_dispatch_fill,
             "zipf GB/s vs dispatch fill threshold"),
        )
    ]
    _dispatch_ab = _take_switch(_argv, "--dispatch-ab")
    _legs = {
        "--device-leg": device_leg,
        "--micro": lambda a: micro_leg(),
        "--metrics-overhead": metrics_overhead_leg,
        "--profile-overhead": profile_overhead_leg,
        "--lineage-overhead": lineage_overhead_leg,
        "--zipf": lambda a: zipf_leg(int(a)),
        "--zipf-ii": lambda a: zipf_ii_leg(int(a)),
        "--sort": lambda a: sort_leg(int(a)),
        "--slow-disk-leg": slow_disk_leg,
        "--slow-dispatch-leg": slow_dispatch_leg,
    }
    _is_leg = len(_argv) == 2 and _argv[0] in _legs
    if _argv and not _is_leg:
        raise SystemExit(f"bench_torch.py: unknown arguments {_argv}")
    _sweep = next(((spec, fn, label) for spec, fn, label in _sweeps if spec), None)
    if _sort_leg:
        _one_line(sort_leg_main, {"metric": "global sort over Zipf corpus",
                                  "unit": "s", "value": None}, "sort-leg")
    elif _model_leg:
        _one_line(model_leg, {"metric": "mrmodel exploration, lease+pipeline foci",
                              "unit": "schedules/s", "value": None}, "model-leg")
    elif _service_leg:
        _one_line(service_sched_ab if _sched_ab else service_leg,
                  {"metric": "job service: K mixed submissions, jobs/minute",
                   "unit": "jobs/min", "ok": False, "value": None}, "service-leg")
    elif _chaos:
        _one_line(chaos_legs, {"metric": "chaos matrix: seeded fault recovery",
                               "unit": "s", "ok": False, "scenarios": None}, "chaos")
    elif _sweep:
        _one_line(lambda: _sweep[1](_sweep[0]),
                  {"metric": _sweep[2], "unit": "GB/s", "value": None, "sweep": None},
                  "sweep", catch_exit=True)
    elif _dispatch_ab:
        _one_line(dispatch_ab_pair, {"metric": "zipf dispatch-plane A/B",
                                     "unit": "x", "value": None}, "dispatch-ab")
    elif _is_leg:
        _legs[_argv[0]](_argv[1])
    else:
        _one_line(main, {"metric": "word_count GB/s end-to-end", "value": None,
                         "unit": "GB/s", "vs_baseline": None}, "bench")

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It imports nothing of the JAX package and fails (non-zero exit, no result
line) without a CUDA device or outside a checkout. Phases, each printed as
one JSON line; any failure raises and ends the run:

1. device   — the card (nvidia-smi name and power limit), torch and CUDA;
2. build    — every kernel of the path compiled from the checkout's
              sources with nvcc (one nvcc per source), and the native host
              library (native/loader.cpp) with g++, all started together;
   bench    — ``python3 bench_torch.py`` in a subprocess with every leg on
              at small sizes (BENCH_ENV: a 16 MB target, one device run,
              one overhead run per side), then ``--sort-leg`` on 8 MB: exit
              0, one GB/s line with a value, vs_baseline and platform
              cuda, the Zipf and sort legs exact, each leg's tokenize_hash
              launches equal to its chunks, the measured leg's run
              manifest naming the card, and the leg's kernel builds
              (made in its warm-up) counted, none of them in the measured
              run's "compile" block;
   bench-modes — bench_torch.py's other modes, each in its subprocess:
              ``--chaos`` (the seeded fault matrix over a coordinator and
              two device-engine workers on the card: every leg recovered,
              bit-identical and run_check clean, the fault-free baselines
              with no lease expiry; the slow-disk and slow-dispatch pairs
              on the host engine fired, identical, on cuda, each hiding
              its delay), ``--sched-ab`` on 4 documents at 2 copies (both
              sides: every job done, K-3 cache hits, run_check clean),
              ``--model-leg``, ``--sweep-host-workers 1,4`` (host engine)
              and ``--sweep-spill-budget 131072,524288`` (device engine) at
              16 MB, and one ``--dispatch-ab`` repeat at 16 MB, these five
              together after the matrix, each in a BENCH_DIR of its own
              (their times are contended: PERF.md quotes them run alone). Every
              worker manifest names the card, holds only library hits and
              counts one tokenize_hash launch per one-chunk map task it
              was granted (none for a cache hit); each sweep leg's run
              manifest counts one per chunk on the device engine, none on
              the host engine;
3. kernel   — both entries of the scan kernel, hash_scan and the fused
              tokenize_hash (last_is_boundary True and False), held bit for
              bit against their plain versions on the card at the main
              path's shapes and at every edge of the kernel's tiles and
              look-back; then timed at 4 MiB after a warm-up, as the median
              of runs of 20 calls between one CUDA event pair, both
              replayed from a CUDA graph (the device's time) and eager (the
              host's work per call included), and once at 64 MiB;
4. native   — the host library's path and build seconds; scan_unique_raw,
              scan_count_raw, scan_count_sharded_raw (S = 4),
              normalize_native and coalesce_updates_into held against their
              plain Python versions on a 4 MiB slice of the Zipf corpus and
              of the unicode text corpus;
5. main     — a seeded 128 MiB Zipf corpus (4 files; cut from 256 MiB to
              make room for bench-modes) through run_job with
              the default Config (device engine, 4 MiB chunks, 2^21-key
              state), reduce_n=8, every output line checked against the
              generator's counts;
   step     — the device time of one main-path step (map_combine + merge)
              on a 4 MiB chunk of that corpus, against the host's time per
              chunk in the main phase (step-ii: the same for
              inverted_index's "distinct" step in the ii phase);
   prof     — the main phase's job again with the sampling profiler,
              ``profile_dir`` (a torch.profiler trace with CUDA activity)
              and the lineage ledger on, with a trace and a manifest:
              exact, each mr-{r}.txt byte-identical to main's, one
              tokenize_hash launch per chunk and as many scan-kernel events
              in the device trace; prints the device busy share (the union
              of kernel, copy and set intervals over the stream seconds),
              the top 10 device kernels by time with their launches, the
              scan kernel's mean in-job time, the per-plane self time and
              top frames of the sampling profile, and the wall beside
              main's (the three switches' tax, reported, not gated);
6. evict    — merge_capacity=2^18 (on 64 MiB, see host-evict), so evicted tails
              flow to the host accumulator on every merge; exact as well;
7. host     — zipf-128M through the host-map engine
              (map_engine="host", default host Config: auto workers and
              shards, async dispatch, coalescing); exact, no scan kernel
              launched, the native scan's arenas live;
8. host-evict — the host engine with merge_capacity=2^18, no coalescing,
              sync dispatch: the pinned stager's event barrier on every
              merge; exact, keys spilled. It and evict run after the apps,
              on documents 0-1 of zipf-ii-256M (64 MiB, cut from the main corpus
              to make room for the mesh phases);
9. ii       — a seeded 256 MiB Zipf corpus in 8 documents (the generator
              of the reference bench's inverted-index leg); its documents
              0-3 (128 MiB, 2.23 M posting pairs against the 2^21 state)
              through inverted_index on the device engine, default
              Config: every posting list equal to its row of the
              generator's presence matrix; evictions cut posting sets,
              the host unions them;
   ii-host  — inverted_index on documents 0-1 on the host engine with a
              2^18-key state and 16 MiB windows;
   grep     — grep on the device engine over documents 0-3, for the words
              of five ranks and one word outside the vocabulary: each line
              equal to the presence row, no line for an absent word;
   join     — join on the host engine, corpus a = document 0, b = 2:
              for every rank on both sides exactly the cross product of
              its relative doc ids;
   top_k    — top_k (k = 20) on the device engine over documents 0-1,
              equal to the generator's 20 best by (-count, word);
   prof-host — word_count on documents 0-1 through the host engine with
              the profiler, the ledger, a device trace and a manifest:
              exact, no scan kernel launched, the packed merge's per-dispatch
              cost (``merge_cost``) in the manifest;
   calibrate — analysis/roofline.calibrate in this process into a machine
              file of the run's own: the card's row with the data sheet's
              HBM rate;
   analysis-cli — ``python -m mapreduce_rust_tpu_torch`` stats (one
              manifest, then main's against prof's with --no-gate),
              doctor (with the trace), prof --roofline --folded over
              prof-host's manifest (no fraction above 1.05, a
              device-merge row from its merge_cost), lineage
              (summary, a forward query, a backward query whose chunks are
              in the ledger) and trace merge, each in a subprocess with its
              own timeout, exit 0 and output; after the service phase,
              fleet over its service root (every utilization in [0, 1]);
              after cluster-kill, ``check`` over its artifacts (conformant
              through a lease expiry and a re-execution) and ``model
              --focus lease`` at depth 10, each exiting 0 in a process
              that never loads torch;
10. sort / sort-host — a seeded 24 MiB Zipf corpus through sort on each
              engine: mr-{r}.txt concatenated in partition order is in
              order and holds exactly the generator's counts; partition
              skew and the splitter pre-pass reported;
11. spill tiers — the bounded-memory tiers and the streaming merge-join
              egress, each exact against its generator's truth:
   spill      — zipf-128M word_count on the device engine, merge_capacity
              2^18, host_accum_budget_mb 16, dictionary_budget_words 2^19:
              both tiers write runs;
   spill-host — the same corpus under the reference bench's ``_zipf_cfg``
              field for field (host engine, 1 MiB chunks, 16 MiB windows,
              2^18 state, fill 0.5, coalescing, 256 MiB and 2^19 words):
              the dictionary tier writes runs;
   spill-ii   — inverted_index on zipf-ii-256M, device engine, 16 MiB and
              2^19 words: accumulator runs of ``distinct`` rows;
   spill-sort — sort on a 48 MiB corpus of the same generator (the
              reference bench's sort size) under ``_zipf_cfg`` with the inline
              (sync) spill writer;
   spill-topk — top_k on documents 0-1 with a 2^17-word dictionary
              budget, through the rehydrate path (top_k overrides
              finalize);
12. mesh    — the single-process mesh, four shards all on the one card
              (make_mesh places shard i on cuda:(i % cards)), each phase
              printing its shard → device map and the card count, wall,
              stream, all_to_all_s, device_wait_s, wire bytes, replays and
              mesh_shard_rows, each launching tokenize_hash once per shard
              per round:
   mesh       — zipf-128M, default Config, mesh_shape 4: exact and each
              mr-{r}.txt byte-identical to main's;
   sharded    — the same with sharded_stream (each 16 MiB window cut into
              four shards anywhere, the halo repairing the seams): exact,
              byte-identical to main's, no halo truncation, forced group
              cuts reported;
   mesh-ii    — inverted_index on documents 0-1 of zipf-ii-256M against
              the presence matrix (the distinct op through the shuffle);
   mesh-replay — documents 0-1 of zipf-ii-256M in 1 MiB chunks, the
              partial capacity at the median of the groups' largest
              per-chunk distinct counts and a bucket slack of 0.5, so
              both replay tiers run: exact;
   mesh-topk  — top_k (k = 20) on documents 0-1: exact, and the driver's
              log shows the per-shard selection was taken;
   mesh-ckpt  — ``run --mesh 4 --checkpoint-every 1`` through the CLI on
              document 0, SIGKILLed once
              driver.ckpt.npz exists, then
              ``--resume``: exact, and the resumed process's manifest
              counts 4 launches per round it ran, for the groups after
              the checkpoint;
   mh         — the multi-process mesh: two processes of ``run
              --distributed --mesh 4 --dist-backend gloo`` (two shards
              each, all on the one card, where NCCL cannot put two ranks:
              gloo carries the collectives of the card's tensors) over
              documents 0-1 of zipf-ii-256M, one document per rank: every
              rank's mr-{r}.p{rank}.txt together exact (no word in two
              ranks' files), equal rounds on both ranks, each rank's
              manifest counting 2 launches per round (the padding rounds
              of a rank without data included), no unknown key, no
              collision, only this job's dictionary shards and markers in
              the work dir; wall, stream, all_to_all_s (now a collective
              between processes) and wire bytes per rank;
   mh-grep    — grep on the same two ranks, its query holding a word only
              document 0 has and one only document 1 has: the dictionary
              exchange prints each from whichever rank owns its hash class;
13. cluster — the coordinator/worker task path on documents 0-1 of
              zipf-ii-256M (64 MiB in 2 files: map_n 2,
              reduce_n 8, default Config): a port
              Coordinator.serve() and two Worker(engine="device") as
              asyncio tasks in this process, worker_n 2; every mr-{r}.txt
              exact, tokenize_hash launched at least once per map-task
              chunk, every mr-{m}-{r}.npz and dict-{m}-{r}.txt shard
              present, no spill run left; wall, the map and reduce task
              durations from job_report.json and peak device memory;
    cluster-kill — word_count through the CLI in subprocesses on
              documents 0-1 of zipf-ii-256M (64 MiB in 2 files: map_n 2,
              reduce_n 8; a cut from zipf-128M that keeps the script near
              half its time limit; a 2 s lease checked every 0.3 s) with
              ``coordinator --worker-n 2`` and
              two ``worker --engine device``, one worker with ``--chaos
              'kill:map:*'``: it
              SIGKILLs itself on its first map task while holding the
              lease; outputs exact, job_report.json shows a lease expiry
              and a re-execution, the victim died by SIGKILL and the
              survivor exited 0; every process has a timeout;
14. service — the multi-tenant job service in this process: a port
              JobService.serve() (service_max_jobs 3, in-flight budget
              1024 MiB) and two ServiceWorker(engine="device") as asyncio
              tasks; three jobs at once on document 0 of zipf-ii-256M
              (32 MiB each) — word_count (reduce_n 8),
              inverted_index and grep with the grep phase's query — each exact
              against its truth, no re-execution, tokenize_hash launched
              once per map-task chunk of the three jobs; then the
              word_count spec again, served from the result cache with
              zero new grants and no launch; wall, each job's queue wait
              and execution seconds, peak device memory;
15. cli     — a few-MB unicode/punctuation corpus through
              ``python -m mapreduce_rust_tpu_torch run``, once per engine,
              checked against the port's reference_word_counts; then
              ``--app grep --query ...`` and ``--app join --input a=DIR
              b=DIR`` on it, against oracles from reference_word_counts
              per file; then a budgeted run (``--accum-budget-mb 0
              --dict-budget-words 4096``) and ``clean``;
16. service-drain — the service through the CLI in subprocesses on that
              corpus: ``service --max-jobs 1``, two word_count jobs
              submitted (one queues), SIGTERM while it is queued, then two
              ``worker --service --engine device``: the service finishes
              the running job and exits 0, the workers exit 0; a restarted
              service and fleet complete the queued job from
              service.journal. Both exact against reference_word_counts;
              every worker that launched the kernel names the card and
              has device memory in its manifest, and each fleet launched
              tokenize_hash once per chunk; every child has a timeout.

Every job phase checks unknown_keys == 0 and hash_collisions == 0 and
that no spill run file is left in its work dir, and prints its wall,
phase seconds, device_wait_s, spills, the spill tiers' runs, seconds and
bytes, and tokenize_hash launches (at least the chunk count on the device
engine, 0 on the host engine; on the mesh 4 per round).

Then the tokenize_hash launches of every driven phase, the card's
nvidia-smi line, the ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``. Kernel launch counts are reset just
before each driven phase and read just after it; launches made to compare
a kernel with its plain version are not counted.
"""

from __future__ import annotations

import json
import logging
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types

ROOT = pathlib.Path(__file__).resolve().parent

#: Device-memory rate of the card: H100 SXM, HBM3 (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
HBM_FIGURE = "H100 SXM HBM3 3.35 TB/s (NVIDIA data sheet)"
#: Peak rate for 32-bit arithmetic outside the tensor cores (the data
#: sheet's float32 figure, an upper bound for int32 work).
ALU_OPS_PER_S = 67e12
#: Integer operations hash_scan needs per input byte: two multiply-adds on
#: each hash lane, the count, and the final INIT*m + a of both lanes.
SCAN_OPS_PER_BYTE = 10

ZIPF_VOCAB = 1 << 21
ZIPF_S = 1.05
ZIPF_SEED = 20260730
ZIPF_BYTES = 128 << 20
ZIPF_FILES = 4
#: The inverted-index corpus: the reference bench's zipf-ii leg
#: (bench.py:345-398), 8 documents, its own seed.
II_SEED = 20260731
II_BYTES = 256 << 20
II_DOCS = 8
#: The sort corpus: half the reference bench's sort leg size (bench.py:517),
#: which bench_torch.py --sort-leg runs; spill-sort keeps the full size,
#: whose ~0.7 M distinct words pass its 2^19-word dictionary budget.
SORT_BYTES = 24 << 20
SPILL_SORT_BYTES = 48 << 20
#: The reference bench's budgets-engaged config ``_zipf_cfg``
#: (bench.py:159-172), field for field; reduce_n and paths are the phase's.
ZIPF_CFG = dict(map_engine="host", host_window_bytes=16 << 20, chunk_bytes=1 << 20,
                merge_capacity=1 << 18, host_accum_budget_mb=256,
                dictionary_budget_words=1 << 19, dispatch_fill_frac=0.5,
                dispatch_coalesce=True)
#: The fields of JobStats that the spill tiers fill.
SPILL_FIELDS = ("accum_spill_runs", "dict_spill_runs", "spill_s", "spill_stall_s",
                "spill_bytes", "merge_fanin")
#: Host time per 4 MiB chunk of the main path before the native scan, ms
#: (PERF.md §5: chip_smoke.py main phase, NVIDIA H100 80GB HBM3, 700 W).
HOST_MS_PER_CHUNK_PYTHON_SCAN = (672, 1539)
SLICE_BYTES = 4 << 20
#: The grep cell's query (documents 0-3 of zipf-ii-256M): five ranks and
#: one word outside the vocabulary.
GREP_RANKS = (0, 7, 1000, 100_000, 2_000_000)
GREP_ABSENT = b"nothere"
GREP_QUERY = tuple("w%06x" % r for r in GREP_RANKS) + (GREP_ABSENT.decode(),)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int, reps: int, groups: int = 5, graph: bool = False) -> float:
    """Time of one fn() call in ms: the median over ``groups`` runs of
    ``reps`` calls, each run between one CUDA event pair.

    Eager (``graph=False``): the calls run back to back from the host, so
    the time includes the host's work per call whenever that is longer
    than the card's. Graph (``graph=True``): the ``reps`` calls are
    captured once into a CUDA graph and each run replays it, so the time
    is the device's alone (launches and memsets, no host work)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()  # the first replay uploads the graph
        run = g.replay
    else:
        def run():
            for _ in range(reps):
                fn()
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    times.sort()
    return times[len(times) // 2]


# ---------------------------------------------------------------- phases


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from mapreduce_rust_tpu_torch.native import host as native_host
    from mapreduce_rust_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        native = pool.submit(native_host.get_lib)
        builds = cuda_build.build_all(["hash_scan.cu"])
        native.result()
    ptxas = [f"{b.source}: {line.strip()}" for b in builds for line in b.log.splitlines()
             if "registers" in line or "spill" in line]
    emit({"phase": "build", "arch": cuda_build.ARCH,
          "seconds": time.perf_counter() - t0,
          "sources": {b.source: b.seconds for b in builds}, "ptxas": ptxas,
          "native": str(native_host.loaded_path().relative_to(ROOT)),
          "native_seconds": native_host.build_seconds})


def _text_bytes(n: int, gen) -> "torch.Tensor":
    import torch

    letters = torch.randint(97, 123, (n,), dtype=torch.uint8, generator=gen)
    spaces = torch.rand(n, generator=gen) < 0.15
    return torch.where(spaces, torch.full_like(letters, 32), letters)


def _no_space_bytes(n: int, gen) -> "torch.Tensor":
    """Random bytes with every whitespace byte replaced by a word char:
    word chars, punctuation and bytes >= 0x80, never a reset."""
    import torch

    x = torch.randint(0, 256, (n,), dtype=torch.uint8, generator=gen)
    is_ws = (x == 32) | ((x >= 9) & (x <= 13))
    return torch.where(is_ws, torch.full_like(x, ord("a")), x)


def kernel_cases(gen, tile: int) -> dict:
    """The inputs both entries are held bit for bit against their plain
    versions on: the main path's 4 MiB chunk, and every edge of the
    kernel's design (tile edges, look-back chains, ragged ends)."""
    import torch

    n_main = 4 << 20  # Config.chunk_bytes: the main path's chunk
    cases = {
        "random_4MiB": torch.randint(0, 256, (n_main,), dtype=torch.uint8, generator=gen),
        "text_4MiB": _text_bytes(n_main, gen),
        "one_byte": torch.tensor([ord("a")], dtype=torch.uint8),
        "random_16KiB+7": torch.randint(0, 256, ((16 << 10) + 7,), dtype=torch.uint8,
                                        generator=gen),
        "text_tile-1": _text_bytes(tile - 1, gen),
        "text_tile+1": _text_bytes(tile + 1, gen),
    }
    # Tokens straddling every kernel tile edge (and so every 16 KiB TPU
    # block edge).
    edges = torch.full((1 << 20,), 32, dtype=torch.uint8)
    for e in range(tile, 1 << 20, tile):
        edges[e - 5: e + 6] = torch.tensor(list(b"straddle_Xy"), dtype=torch.uint8)
    cases["tile_edges_1MiB"] = edges
    run = _text_bytes(n_main, gen)
    run[100_000: 100_000 + 50_000] = 97
    cases["ws_free_run_4MiB"] = run
    # No whitespace at all: no tile holds a reset, so every look-back runs
    # to the nearest tile that has published its inclusive prefix.
    cases["ws_free_4MiB"] = _no_space_bytes(n_main, gen)
    # Whitespace only in the last, or only in the first, byte of each tile
    # (the ragged last tile included).
    last = _no_space_bytes((1 << 20) + 100, gen)
    last[tile - 1:: tile] = 32
    last[-1] = 32
    cases["ws_last_byte_of_tiles"] = last
    first = _no_space_bytes((1 << 20) + 100, gen)
    first[::tile] = 10
    cases["ws_first_byte_of_tiles"] = first
    return cases


def _max_abs_err(got, want) -> int:
    import torch

    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               for g, w in zip(got, want))


def phase_kernel() -> list[dict]:
    """Both entries bit-exact against their plain versions on every case,
    then timed at 4 MiB (graph replay and eager) and once at 64 MiB."""
    import torch

    from mapreduce_rust_tpu_torch.ops import tokenize_cuda as tc

    gen = torch.Generator().manual_seed(0)
    cases = kernel_cases(gen, tc.TILE_BYTES)
    worst = {"hash_scan": 0, "tokenize_hash": 0}
    for name, host in cases.items():
        x = host.cuda()
        pairs = [("hash_scan", None, tc.hash_scan(x), tc.hash_scan_reference(x))]
        for lib in (True, False):
            pairs.append(("tokenize_hash", lib, tc.tokenize_hash(x, lib),
                          tc.tokenize_hash_reference(x, lib)))
        torch.cuda.synchronize()
        for entry, lib, got, want in pairs:
            err = _max_abs_err(got, want)
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"{entry} (last_is_boundary={lib}) disagrees with its plain version "
                  f"on {name} (max |diff| {err})")
            worst[entry] = max(worst[entry], err)

    n_main = cases["random_4MiB"].numel()
    x = cases["random_4MiB"].cuda()
    n_big = 64 << 20
    big = torch.randint(0, 256, (n_big,), dtype=torch.uint8, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(1))
    entries = {
        "hash_scan": (tc.hash_scan, tc.hash_scan_reference, (), tc.BYTES_PER_INPUT_BYTE),
        "tokenize_hash": (tc.tokenize_hash, tc.tokenize_hash_reference, (True,),
                          tc.FUSED_BYTES_PER_INPUT_BYTE),
    }
    rows = []
    for entry, (fn, ref, args, bytes_per_byte) in entries.items():
        graph_ms = time_ms(lambda: fn(x, *args), warmup=5, reps=20, graph=True)
        eager_ms = time_ms(lambda: fn(x, *args), warmup=5, reps=20)
        plain_ms = time_ms(lambda: ref(x, *args), warmup=1, reps=2, groups=3)
        big_ms = time_ms(lambda: fn(big, *args), warmup=2, reps=5, groups=3, graph=True)
        bytes_ms = bytes_per_byte * n_main / HBM_BYTES_PER_S * 1e3
        ops_ms = SCAN_OPS_PER_BYTE * n_main / ALU_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        big_bound_ms = bytes_per_byte * n_big / HBM_BYTES_PER_S * 1e3
        rows.append({
            "name": entry, "route": "cuda",
            "source": "mapreduce_rust_tpu_torch/ops/csrc/hash_scan.cu",
            "replaces": tc.REPLACES, "launches": None, "max_abs_err": worst[entry],
            "ms": graph_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            # No single PyTorch call computes this segmented hash scan.
            "library_ms": None,
        })
        emit({"phase": "kernel", "kernel": entry, "cases": list(cases), "bit_exact": True,
              "last_is_boundary": [True, False] if args else None,
              "n_bytes": n_main, "graph_ms": graph_ms, "eager_ms": eager_ms,
              "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_share": bound_ms / graph_ms,
              "bound_figure": HBM_FIGURE, "bytes_per_input_byte": bytes_per_byte,
              "input_GB_per_s": n_main / graph_ms / 1e6,
              "moved_GB_per_s": bytes_per_byte * n_main / graph_ms / 1e6,
              # 4 MiB of input and its outputs (~50 MiB) nearly fit the 50 MB
              # L2 across back-to-back calls; 64 MiB does not.
              "n_bytes_big": n_big, "graph_ms_big": big_ms,
              "bound_share_big": big_bound_ms / big_ms,
              "moved_GB_per_s_big": bytes_per_byte * n_big / big_ms / 1e6})
    return rows


def _ws_slice(data: bytes, n: int) -> bytes:
    """The first n bytes of data, cut back to the last ASCII space."""
    if len(data) <= n:
        return data
    return data[: data.rindex(b" ", 0, n) + 1]


def phase_native(zipf_dir: pathlib.Path, text_blob: bytes) -> None:
    """Each entry of the native host library against its plain Python
    version on a 4 MiB slice of each corpus."""
    import numpy as np

    from mapreduce_rust_tpu_torch.core.normalize import normalize_python
    from mapreduce_rust_tpu_torch.native import host
    from mapreduce_rust_tpu_torch.runtime.dictionary import shard_ids_of_packed
    from mapreduce_rust_tpu_torch.runtime.driver import (
        _coalesce_updates_py,
        _py_scan_count,
        _scan_payload_python,
    )

    def words_of(raw, ends):
        starts = [0] + ends[:-1].tolist()
        return [raw[a:b] for a, b in zip(starts, ends.tolist())]

    slices = {"zipf": _ws_slice((zipf_dir / "part-0.txt").read_bytes(), SLICE_BYTES),
              "text": _ws_slice(text_blob, SLICE_BYTES)}
    out = {"phase": "native", "library": str(host.loaded_path().relative_to(ROOT)),
           "build_seconds": host.build_seconds, "slices": {}}
    for name, raw in slices.items():
        row = {"bytes": len(raw)}
        t0 = time.perf_counter()
        norm = host.normalize_native(raw)
        row["normalize_ms"] = (time.perf_counter() - t0) * 1e3
        check(norm == normalize_python(raw), f"normalize_native differs on {name}")

        t0 = time.perf_counter()
        uraw, uends, ukeys = host.scan_unique_raw(norm)
        row["scan_unique_ms"] = (time.perf_counter() - t0) * 1e3
        words, keys = _scan_payload_python(norm)
        check(words_of(uraw, uends) == words and np.array_equal(ukeys, keys),
              f"scan_unique_raw differs on {name}")

        t0 = time.perf_counter()
        craw, cends, ckeys, ccounts = host.scan_count_raw(raw)
        row["scan_count_ms"] = (time.perf_counter() - t0) * 1e3
        pwords, pkeys, pcounts = _py_scan_count(raw)
        check(words_of(craw, cends) == pwords and np.array_equal(ckeys, pkeys)
              and np.array_equal(ccounts, pcounts), f"scan_count_raw differs on {name}")

        t0 = time.perf_counter()
        graw, gends, gkeys, gcounts, pos, shard_counts = host.scan_count_sharded_raw(raw, 4)
        row["scan_count_sharded_ms"] = (time.perf_counter() - t0) * 1e3
        packed = (pkeys[:, 0].astype(np.uint64) << np.uint64(32)) \
            | pkeys[:, 1].astype(np.uint64)
        shard = shard_ids_of_packed(packed, 4).astype(np.int64)
        order = np.argsort(shard, kind="stable")
        check(words_of(graw, gends) == [pwords[i] for i in order.tolist()]
              and np.array_equal(gkeys, pkeys[order])
              and np.array_equal(gcounts, pcounts[order]) and np.array_equal(pos, order)
              and np.array_equal(shard_counts, np.bincount(shard, minlength=4)),
              f"scan_count_sharded_raw differs on {name}")

        # Coalesce the slice's sorted (key, count) column into itself
        # shifted: every key of b either new or summed.
        sorted_idx = np.argsort(packed, kind="stable")
        a_k = np.ascontiguousarray(packed[sorted_idx])
        a_v = np.ascontiguousarray(pcounts[sorted_idx].astype(np.int64))
        b_k = np.ascontiguousarray(a_k[::2] + np.uint64(1))
        b_k = np.unique(np.concatenate([b_k, a_k[1::3]]))
        b_v = np.arange(1, len(b_k) + 1, dtype=np.int64)
        out_k = np.empty(len(a_k) + len(b_k), np.uint64)
        out_v = np.empty(len(a_k) + len(b_k), np.int64)
        t0 = time.perf_counter()
        m = host.coalesce_updates_into(a_k, a_v, len(a_k), b_k, b_v, out_k, out_v)
        row["coalesce_ms"] = (time.perf_counter() - t0) * 1e3
        want_k, want_v = _coalesce_updates_py(a_k, a_v, len(a_k), b_k, b_v)
        check(np.array_equal(out_k[:m], want_k) and np.array_equal(out_v[:m], want_v),
              f"coalesce_updates_into differs on {name}")
        row.update(unique_words=len(pwords), tokens=int(pcounts.sum()), exact=True)
        out["slices"][name] = row
    emit(out)


def _zipf_sampler():
    """(cdf, token table): the inverse-CDF Zipf(ZIPF_S) sampler over
    ZIPF_VOCAB ranks; rank r is the fixed 8-byte token b'w%06x '."""
    import numpy as np

    weights = 1.0 / np.arange(1, ZIPF_VOCAB + 1, dtype=np.float64) ** ZIPF_S
    cdf = np.cumsum(weights)
    cdf /= cdf[-1]
    table = np.frombuffer(
        b"".join(b"w%06x " % r for r in range(ZIPF_VOCAB)), dtype=np.uint8
    ).reshape(ZIPF_VOCAB, 8)
    return cdf, table


def _write_tokens(f, rng, cdf, table, n_tokens: int, on_block) -> None:
    """n_tokens sampled tokens into f in 4M-token blocks, then a newline;
    on_block(ranks) records the ground truth."""
    import numpy as np

    left = n_tokens
    while left > 0:
        block = min(left, 4 << 20)
        ranks = np.searchsorted(cdf, rng.random(block))
        on_block(ranks)
        f.write(table[ranks].tobytes())
        left -= block
    f.write(b"\n")


def write_zipf_corpus(dirpath: pathlib.Path, total_bytes: int = ZIPF_BYTES,
                      files: int = ZIPF_FILES):
    """``files`` files of 8-byte tokens b'w%06x ' drawn Zipf(s) over
    ZIPF_VOCAB ranks by inverse-CDF sampling; returns the generator-side
    count of every rank (the ground truth)."""
    import numpy as np

    rng = np.random.default_rng(ZIPF_SEED)
    cdf, table = _zipf_sampler()
    counts = np.zeros(ZIPF_VOCAB, dtype=np.int64)
    for i in range(files):
        with open(dirpath / f"part-{i}.txt", "wb") as f:
            _write_tokens(f, rng, cdf, table, total_bytes // 8 // files,
                          lambda ranks: counts.__iadd__(
                              np.bincount(ranks, minlength=ZIPF_VOCAB)))
    return counts


def write_ii_corpus(dirpath: pathlib.Path):
    """The zipf-ii corpus (bench.py:345-398): II_DOCS documents doc-{d}.txt
    of (II_BYTES // (8 * II_DOCS) + 1) tokens each, seed II_SEED. Returns
    (presence bool [ZIPF_VOCAB, II_DOCS], counts of documents 0-1 per
    rank, counts of document 0 per rank) — the ground truth of every app
    phase on it."""
    import numpy as np

    rng = np.random.default_rng(II_SEED)
    cdf, table = _zipf_sampler()
    presence = np.zeros((ZIPF_VOCAB, II_DOCS), dtype=bool)
    counts01 = np.zeros(ZIPF_VOCAB, dtype=np.int64)
    counts0 = np.zeros(ZIPF_VOCAB, dtype=np.int64)
    per_doc = II_BYTES // (8 * II_DOCS) + 1
    for d in range(II_DOCS):
        def on_block(ranks, d=d):
            c = np.bincount(ranks, minlength=ZIPF_VOCAB)
            presence[:, d] |= c > 0
            if d < 2:
                counts01[:] += c
            if d == 0:
                counts0[:] += c

        with open(dirpath / f"doc-{d}.txt", "wb") as f:
            _write_tokens(f, rng, cdf, table, per_doc, on_block)
    return presence, counts01, counts0


def _line_table(files):
    """(bytes, line starts, line ends) of every file's lines, concatenated
    in file order; each file must be empty or end in a newline. Line i is
    bytes[starts[i]:ends[i]], its newline at ends[i]."""
    import numpy as np

    blobs = []
    for path in files:
        data = pathlib.Path(path).read_bytes()
        check(not data or data.endswith(b"\n"), f"{path} does not end in a newline")
        blobs.append(data)
    arr = np.frombuffer(b"".join(blobs), dtype=np.uint8)
    ends = np.flatnonzero(arr == 10)
    starts = np.concatenate([np.zeros(min(len(ends), 1), np.int64), ends[:-1] + 1])
    return arr, starts, ends


def _line_ranks(arr, starts, ends):
    """The rank of every line's word, each line 'w' + 6 lowercase hex digits
    + a space + at least one more byte; no rank twice."""
    import numpy as np

    check(bool((ends - starts >= 9).all()), "an output line is too short")
    word = arr[starts[:, None] + np.arange(8)]
    hexd = word[:, 1:7]
    check(bool((word[:, 0] == ord("w")).all() and (word[:, 7] == 32).all()
               and (((hexd >= ord("0")) & (hexd <= ord("9")))
                    | ((hexd >= ord("a")) & (hexd <= ord("f")))).all()),
          "an output line's word is not w%06x")
    ranks = _hex_ranks(word)
    check(len(np.unique(ranks)) == len(ranks), "a word was emitted twice")
    return ranks


def check_zipf_outputs(files, truth) -> int:
    """Every line 'w%06x COUNT', each word once, the counts equal to the
    generator's; returns the line count."""
    import numpy as np

    arr, starts, ends = _line_table(files)
    ranks = _line_ranks(arr, starts, ends)
    # The count: the decimal digits after the space, parsed column by column.
    width = ends - starts - 8
    value = np.zeros(len(ranks), dtype=np.int64)
    for k in range(int(width.max(initial=0))):
        live = np.flatnonzero(width > k)
        digit = arr[starts[live] + 8 + k].astype(np.int64) - ord("0")
        check(bool(((digit >= 0) & (digit <= 9)).all()), "an output count is not decimal")
        value[live] = value[live] * 10 + digit
    got = np.zeros(ZIPF_VOCAB, dtype=np.int64)
    got[ranks] = value
    lines = len(ranks)
    check(lines == int((truth > 0).sum()), f"{lines} output lines, "
          f"{int((truth > 0).sum())} distinct words generated")
    check(np.array_equal(got, truth), "output counts differ from the generator's")
    return lines


def drive_job(name: str, work: pathlib.Path, check_outputs, app=None,
              corpus: "pathlib.Path | None" = None, **cfg_kw):
    """One run_job through the port's entry point on the card, with the
    kernel launch counts set to 0 just before and read just after;
    ``check_outputs(res)`` holds the outputs to the generator's truth and
    returns the phase's own fields."""
    import torch

    from mapreduce_rust_tpu_torch.config import Config
    from mapreduce_rust_tpu_torch.ops.tokenize_cuda import hash_scan, tokenize_hash
    from mapreduce_rust_tpu_torch.runtime.driver import run_job

    if corpus is not None:
        cfg_kw["input_dir"] = str(corpus)
    cfg = Config(output_dir=str(work / f"{name}-out"), work_dir=str(work / f"{name}-work"),
                 reduce_n=8, **cfg_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hash_scan.launches = tokenize_hash.launches = 0
    res = run_job(cfg, app=app)
    launches = {"hash_scan": hash_scan.launches, "tokenize_hash": tokenize_hash.launches}
    s = res.stats
    check(s.unknown_keys == 0, f"{name}: {s.unknown_keys} unknown keys")
    check(s.hash_collisions == 0, f"{name}: {s.hash_collisions} hash collisions")
    left = [p.name for p in pathlib.Path(cfg.work_dir).glob("*run-*")]
    check(not left, f"{name}: spill run files left in the work dir: {left[:4]}")
    t0 = time.perf_counter()
    fields = check_outputs(res)
    stream_s = s.phase_seconds["stream"]
    out = {"phase": name, "exact": True, "app": app.name if app else "word_count",
           "map_engine": cfg.map_engine, "launches": launches,
           "wall_s": s.wall_seconds, "GB_per_s": s.gb_per_s, "bytes_in": s.bytes_in,
           "chunks": s.chunks, "device_wait_s": s.device_wait_s,
           "ingest_wait_s": s.ingest_wait_s, "distinct_keys": s.distinct_keys,
           **fields, "check_s": time.perf_counter() - t0,
           "spilled_keys": s.spilled_keys, "spill_events": s.spill_events,
           "partial_overflow_replays": s.partial_overflow_replays,
           **{k: getattr(s, k) for k in SPILL_FIELDS},
           "phase_seconds": s.phase_seconds,
           "device_mem_peak_bytes": torch.cuda.max_memory_allocated(),
           "merge_capacity": cfg.merge_capacity,
           "host_accum_budget_mb": cfg.host_accum_budget_mb,
           "dictionary_budget_words": cfg.dictionary_budget_words,
           "spill_async": cfg.spill_async}
    if cfg.mesh_shape:
        out.update(_mesh_fields(name, cfg, s, launches))
    if cfg.map_engine == "device" or cfg.mesh_shape:
        check(launches["tokenize_hash"] >= s.chunks > 0, f"{name}: tokenize_hash launched "
              f"{launches['tokenize_hash']} times for {s.chunks} chunks")
        out.update(chunk_bytes=cfg.chunk_bytes,
                   host_ms_per_chunk=stream_s / s.chunks * 1e3,
                   fold_ms_per_chunk=s.fold_s / s.chunks * 1e3,
                   host_ms_per_chunk_python_scan=list(HOST_MS_PER_CHUNK_PYTHON_SCAN))
    else:
        check(launches == {"hash_scan": 0, "tokenize_hash": 0},
              f"{name}: the host engine launched a scan kernel: {launches}")
        check(s.host_arena_bytes > 0, f"{name}: no native scan arena was live")
        out.update({k: getattr(s, k) for k in (
            "host_map_workers", "fold_shards", "host_map_s", "host_glue_s",
            "scan_wait_s", "dispatch_s", "dispatch_stall_s", "dispatch_mode",
            "merge_dispatches", "merge_fill_frac", "fold_s", "fold_stall_s",
            "host_arena_bytes")},
            host_window_bytes=cfg.host_window_bytes,
            host_update_cap=cfg.host_update_cap, windows=s.chunks)
    emit(out)
    return out


def _mesh_fields(name: str, cfg, s, launches) -> dict:
    """A mesh run's own checks and numbers: one scan-kernel launch per
    shard per round (replay rounds included), no halo truncation, and the
    shard → device map beside the card count."""
    import torch

    from mapreduce_rust_tpu_torch.parallel.shuffle import make_mesh

    mesh = make_mesh(cfg.mesh_shape, cfg.device)
    check(launches["tokenize_hash"] == mesh.size * s.mesh_rounds > 0,
          f"{name}: tokenize_hash launched {launches['tokenize_hash']} times in "
          f"{s.mesh_rounds} rounds of {mesh.size} shards")
    check(s.halo_truncations == 0, f"{name}: {s.halo_truncations} halo truncations")
    return {"mesh_shape": mesh.size, "shard_devices": [str(dev) for dev in mesh.devices],
            "device_count": torch.cuda.device_count(), "sharded_stream": cfg.sharded_stream,
            "stream_s": s.phase_seconds["stream"], "all_to_all_s": s.all_to_all_s,
            "mesh_rounds": s.mesh_rounds, "shuffle_wire_bytes": s.shuffle_wire_bytes,
            "bucket_skew_replays": s.bucket_skew_replays,
            "halo_truncations": s.halo_truncations, "forced_cuts": s.forced_cuts,
            "mesh_shard_rows": s.mesh_shard_rows,
            "partial_capacity": cfg.effective_partial_capacity(),
            "bucket_capacity_factor": cfg.bucket_capacity_factor}


def zipf_check(truth):
    return lambda res: {"output_lines": check_zipf_outputs(res.output_files, truth)}


def _hex_ranks(arr):
    """Ranks of the fixed-width tokens b'w%06x' in columns 0-6 of a uint8
    line matrix (one output line per row)."""
    import numpy as np

    hexd = arr[:, 1:7].astype(np.int64)
    hexd = np.where(hexd >= ord("a"), hexd - (ord("a") - 10), hexd - ord("0"))
    return (hexd * np.power(16, np.arange(5, -1, -1, dtype=np.int64))).sum(axis=1)


def ii_check(presence):
    """Every line 'w%06x d,d,...' (single-digit doc ids, strictly
    increasing), each word once, the posting lists equal to the presence
    matrix's rows."""
    import numpy as np

    def run(res):
        arr, starts, ends = _line_table(res.output_files)
        ranks = _line_ranks(arr, starts, ends)
        width = ends - starts - 8
        check(bool((width % 2 == 1).all()), "a posting list is out of format")
        n_docs = (width + 1) // 2
        line = np.repeat(np.arange(len(ranks)), n_docs)
        nth = np.arange(int(n_docs.sum())) - np.repeat(np.cumsum(n_docs) - n_docs, n_docs)
        pos = starts[line] + 8 + 2 * nth
        docs = arr[pos].astype(np.int64) - ord("0")
        later = nth > 0
        check(bool(((docs >= 0) & (docs < presence.shape[1])).all()
                   and (arr[pos[later] - 1] == ord(",")).all()),
              "a posting list is out of format")
        check(bool((docs[later] > docs[np.flatnonzero(later) - 1]).all()),
              "a posting list is not sorted")
        got = np.zeros_like(presence)
        got[ranks[line], docs] = True
        check(np.array_equal(got, presence), "posting lists differ from the generator's")
        return {"output_lines": len(ranks), "posting_pairs": int(presence.sum()),
                "docs": presence.shape[1]}

    return run


def grep_check(presence, ranks, absent: bytes):
    """One line per present query word, equal to its presence row; no line
    for a query word that no document holds."""
    def run(res):
        want = sorted(b"w%06x %s" % (r, b",".join(b"%d" % d for d in presence[r].nonzero()[0]))
                      for r in ranks if presence[r].any())
        got = sorted(line for path in res.output_files
                     for line in pathlib.Path(path).read_bytes().splitlines())
        check(got == want, f"grep lines {got[:8]} differ from {want[:8]}")
        check(all(not line.startswith(absent + b" ") for line in got),
              "grep emitted the absent word")
        return {"query_ranks": list(ranks), "output_lines": len(got)}

    return run


def join_check(presence, n_left: int):
    """Every line 'w%06x a b' (a, b relative doc ids, single digits): the
    set of lines is exactly the cross product per rank on both sides."""
    import numpy as np

    def run(res):
        codes = []
        for path in res.output_files:
            data = pathlib.Path(path).read_bytes()
            if not data:
                continue
            arr = np.frombuffer(data, dtype=np.uint8).reshape(-1, 12)
            check(bool((arr[:, 0] == ord("w")).all() and (arr[:, 7] == 32).all()
                       and (arr[:, 9] == 32).all() and (arr[:, 11] == 10).all()),
                  "join line out of format")
            ranks = _hex_ranks(arr)
            a = arr[:, 8].astype(np.int64) - ord("0")
            b = arr[:, 10].astype(np.int64) - ord("0")
            codes.append(ranks * 100 + a * 10 + b)
        got = np.sort(np.concatenate(codes)) if codes else np.zeros(0, np.int64)
        left, right = presence[:, :n_left], presence[:, n_left:]
        want = [np.nonzero(left[:, a] & right[:, b])[0] * 100 + a * 10 + b
                for a in range(left.shape[1]) for b in range(right.shape[1])]
        want = np.sort(np.concatenate(want))
        check(np.array_equal(got, want), f"join: {len(got)} lines, want {len(want)}")
        return {"output_lines": int(len(got)),
                "keys_on_both_sides": int((left.any(1) & right.any(1)).sum())}

    return run


def topk_check(counts, k: int):
    """mr-0.txt holds the k best (-count, word); the other partitions are
    empty. Words are fixed-width hex, so word order is rank order."""
    import numpy as np

    def run(res):
        order = np.lexsort((np.arange(len(counts)), -counts))[:k]
        want = [b"w%06x %d" % (r, counts[r]) for r in order.tolist()]
        got = [pathlib.Path(p).read_bytes().splitlines() for p in res.output_files]
        check(got[0] == want, f"top_k lines {got[0][:4]} differ from {want[:4]}")
        check(not any(got[1:]), "top_k wrote to a partition other than 0")
        return {"k": k, "output_lines": len(got[0])}

    return run


def sort_check(truth):
    """The reference bench's sort oracle (bench.py:455-485): every line is
    the 8-byte b'w%06x\\n', mr-{r}.txt concatenated in partition order is
    non-decreasing, and the rank counts equal the generator's."""
    import numpy as np

    def run(res):
        got = np.zeros(len(truth), dtype=np.int64)
        prev, lines = -1, 0
        for path in res.output_files:  # partition order
            data = pathlib.Path(path).read_bytes()
            if not data:
                continue
            ranks = _hex_ranks(np.frombuffer(data, dtype=np.uint8).reshape(-1, 8))
            check(bool(ranks[0] >= prev and (np.diff(ranks) >= 0).all()),
                  f"sort output out of order in {path}")
            prev = int(ranks[-1])
            got += np.bincount(ranks, minlength=len(truth))
            lines += len(ranks)
        check(np.array_equal(got, truth), "sort output differs from the generator's counts")
        s = res.stats
        pb = s.partition_bytes
        return {"output_lines": lines, "partition_mode": s.partition_mode,
                "partition_bytes": pb, "skew": max(pb) / (sum(pb) / len(pb)),
                "splitter_samples": s.splitter_samples, "splitter_s": s.splitter_s}

    return run


def phase_step(name: str, path: pathlib.Path, run: dict, app=None) -> None:
    """Device time of one main-path step (map_combine + merge) of ``app``
    on the first 4 MiB chunk of ``path`` at the default Config's shapes,
    against the host's wall time per chunk in the phase ``run``."""
    import torch

    from mapreduce_rust_tpu_torch.apps.word_count import WordCount
    from mapreduce_rust_tpu_torch.config import Config
    from mapreduce_rust_tpu_torch.core.kv import KVBatch
    from mapreduce_rust_tpu_torch.runtime.chunker import chunk_stream
    from mapreduce_rust_tpu_torch.runtime.driver import make_step_fns

    cfg = Config()
    app = app or WordCount()
    with open(path, "rb") as f:
        chunk = next(chunk_stream(f, 0, cfg.chunk_bytes))
    x = torch.from_numpy(chunk.data).cuda()
    map_combine, merge = make_step_fns(app, cfg.effective_partial_capacity())
    state = KVBatch.empty(cfg.merge_capacity, "cuda")

    def step():
        update, _ovf = map_combine(x, 0)
        merge(state, update)

    ms = time_ms(step, warmup=3, reps=5, groups=3)
    stream_s = run["phase_seconds"]["stream"]
    emit({"phase": name, "app": app.name, "combine_op": app.combine_op, "step_ms": ms,
          "chunk_bytes": cfg.chunk_bytes, "merge_capacity": cfg.merge_capacity,
          "host_ms_per_chunk": stream_s / run["chunks"] * 1e3,
          "device_busy_share_est": run["chunks"] * ms / 1e3 / stream_s})


#: Mean time of tokenize_hash's scan kernel at 4 MiB, replayed from a CUDA
#: graph (PERF.md §6: chip_smoke.py kernel phase, NVIDIA H100 80GB HBM3,
#: 700 W), set beside its in-job time from the device trace.
SCAN_KERNEL_GRAPH_MS = 0.0327
#: The sampling profiler's planes (runtime/prof.py), in the order printed.
PROF_PLANES = ("router", "ingest", "scan", "fold", "spill", "dispatch", "other")


def _digests(out_dir: pathlib.Path, reduce_n: int = 8) -> list[str]:
    import hashlib

    return [hashlib.blake2b((out_dir / f"mr-{r}.txt").read_bytes(), digest_size=16)
            .hexdigest() for r in range(reduce_n)]


def device_trace_summary(trace_dir: pathlib.Path, stream_s: float) -> dict:
    """The one torch.profiler trace in ``trace_dir``: device busy share (the
    union of every kernel, copy and set interval over the stream phase's
    seconds), the top 10 device kernels by total time with their launch
    counts, the scan kernel's events and mean time, and which threads'
    CPU operators the trace holds."""
    from mapreduce_rust_tpu_torch.runtime.driver import DEVICE_TRACE_CATS

    traces = sorted(trace_dir.glob("*.pt.trace.json"))
    check(len(traces) == 1, f"expected one device trace in {trace_dir}, found {traces}")
    path = traces[0]
    events = json.loads(path.read_text()).get("traceEvents") or []
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in events if e.get("cat") in DEVICE_TRACE_CATS)
    check(spans, f"{path.name}: no device activity in the trace")
    busy_us, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    kernels: dict = {}
    for e in events:
        if e.get("cat") == "kernel":
            k = kernels.setdefault(e["name"], [0, 0.0])
            k[0] += 1
            k[1] += float(e.get("dur", 0))
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    scan = [(n, c, t) for n, (c, t) in kernels.items() if "scan_kernel" in n]
    scan_n = sum(c for _n, c, _t in scan)
    scan_us = sum(t for _n, _c, t in scan)
    cpu_tids: dict = {}
    for e in events:
        if e.get("cat") == "cpu_op":
            cpu_tids[str(e.get("tid"))] = cpu_tids.get(str(e.get("tid")), 0) + 1
    return {
        "trace": path.name, "trace_bytes": path.stat().st_size,
        "device_events": len(spans), "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / stream_s,
        "kernel_names": len(kernels), "kernel_launches": sum(c for c, _t in kernels.values()),
        "kernel_time_s": sum(t for _c, t in kernels.values()) / 1e6,
        "top_kernels": [{"name": n[:120], "launches": c, "total_ms": t / 1e3,
                         "mean_ms": t / c / 1e3, "share_of_stream": t / 1e6 / stream_s}
                        for n, (c, t) in top],
        "scan_kernel_events": scan_n,
        "scan_kernel_mean_ms": scan_us / scan_n / 1e3 if scan_n else None,
        "scan_kernel_graph_ms_kernel_phase": SCAN_KERNEL_GRAPH_MS,
        "cpu_op_threads": cpu_tids,
    }


def profile_summary(manifest: dict) -> dict:
    """Per-plane self-time seconds and the top 5 frames of a manifest's
    ``stats.profile``."""
    prof = manifest["stats"].get("profile")
    check(bool(prof) and prof.get("samples", 0) > 0, "the manifest holds no sampling profile")
    planes = prof["planes"]
    # Of the router's (MainThread's) sampled stacks, the share inside the
    # dictionary fold (the manifest keeps the 512 most frequent stacks).
    router = fold = 0
    for line in prof["stacks"]:
        stack, n = line.rsplit(" ", 1)
        if stack.startswith("MainThread;"):
            router += int(n)
            fold += int(n) * (":fold_scan_into_dictionary:" in stack)
    return {"hz": prof["hz"], "wall_s": prof["wall_s"], "samples": prof["samples"],
            "self_s": {p: planes.get(p, {}).get("self_s", 0.0) for p in PROF_PLANES},
            "unlisted_planes": sorted(set(planes) - set(PROF_PLANES)),
            "top_frames": prof["top_frames"][:5],
            "router_fold_share": fold / router if router else None}


def phase_prof(work: pathlib.Path, corpus: pathlib.Path, truth, main_run: dict) -> dict:
    """zipf-128M through run_job on the device engine with the main phase's
    Config and the three observability switches on: the sampling profiler,
    ``profile_dir`` (a torch.profiler trace with CUDA activity) and the
    lineage ledger, plus a trace and a manifest. Exact, byte-identical to
    the main phase's files, one tokenize_hash launch per chunk, as many
    scan-kernel events in the device trace as launches."""
    main_digests = _digests(work / "main-out")

    def outputs(res):
        fields = zipf_check(truth)(res)
        check(_digests(work / "prof-out") == main_digests,
              "prof: mr-{r}.txt differ from the main phase's")
        return {**fields, "identical_to_main": True}

    run = drive_job("prof", work, outputs, corpus=corpus, profile=True,
                    profile_dir=str(work / "prof-tp"), lineage=True,
                    trace_path=str(work / "prof-trace.json"),
                    manifest_path=str(work / "prof-manifest.json"))
    launches = run["launches"]["tokenize_hash"]
    check(launches == run["chunks"], f"prof: {launches} launches for {run['chunks']} chunks")
    dev = device_trace_summary(work / "prof-tp", run["phase_seconds"]["stream"])
    check(dev["scan_kernel_events"] == launches,
          f"prof: {dev['scan_kernel_events']} scan-kernel events in the device trace, "
          f"{launches} launches counted")
    manifest = json.loads((work / "prof-manifest.json").read_text())
    check((work / "prof-manifest.folded").stat().st_size > 0, "prof: no .folded export")
    ledger = manifest["stats"].get("lineage") or {}
    check(ledger.get("chunks") == run["chunks"],
          f"prof: the ledger holds {ledger.get('chunks')} chunks of {run['chunks']}")
    out = {"phase": "prof", "wall_s": run["wall_s"], "main_wall_s": main_run["wall_s"],
           "switch_tax_frac": run["wall_s"] / main_run["wall_s"] - 1.0,
           "stream_s": run["phase_seconds"]["stream"], "launches": launches,
           "device_trace": dev, "profile": profile_summary(manifest),
           "lineage": {k: ledger.get(k) for k in ("chunks", "bytes", "corpus_digest")}}
    emit(out)
    run["prof"] = out
    return run


def phase_prof_host(work: pathlib.Path, corpus: pathlib.Path, truth) -> dict:
    """Documents 0-1 of zipf-ii-256M through the host engine with the
    sampling profiler, the lineage ledger and a manifest (and a device
    trace, which shows whose CPU operators torch.profiler records): exact
    against the generator's counts, no scan kernel launched."""
    run = drive_job("prof-host", work, zipf_check(truth), corpus=corpus, map_engine="host",
                    profile=True, lineage=True, profile_dir=str(work / "prof-host-tp"),
                    manifest_path=str(work / "prof-host-manifest.json"))
    manifest = json.loads((work / "prof-host-manifest.json").read_text())
    mc = manifest.get("merge_cost") or {}
    check(run["merge_dispatches"] > 0 and mc.get("flops", 0) > 0
          and mc.get("bytes_accessed", 0) > 0,
          f"prof-host: no merge_cost for {run['merge_dispatches']} dispatches: {mc}")
    dev = device_trace_summary(work / "prof-host-tp", run["phase_seconds"]["stream"])
    out = {"phase": "prof-host", "wall_s": run["wall_s"], "launches": run["launches"],
           "merge_cost": mc, "profile": profile_summary(manifest),
           "device_trace": {k: dev[k] for k in ("device_events", "device_busy_share",
                                                "kernel_launches", "cpu_op_threads",
                                                "trace_bytes")},
           "merge_dispatches": run["merge_dispatches"]}
    emit(out)
    return run


def phase_calibrate(work: pathlib.Path) -> pathlib.Path:
    """roofline.calibrate in this process, where CUDA is initialized: its
    devices row names the card with the data sheet's HBM rate. Writes a
    machine file of its own and never reads the checkout's."""
    import torch

    from mapreduce_rust_tpu_torch.analysis import roofline

    path = work / "machine.json"
    m = roofline.calibrate(str(path), force=True)
    name = torch.cuda.get_device_name(0)
    rows = [d for d in m["devices"] if d.get("kind") == name]
    check(bool(rows) and rows[0].get("hbm_gbs") == 3350.0,
          f"calibrate: no {name} row with hbm_gbs 3350: {m['devices']}")
    emit({"phase": "calibrate", "host_memcpy_gbs": m["host_memcpy_gbs"],
          "devices": m["devices"]})
    return path


#: Runs the port's CLI on argv, then says on its last line whether torch
#: was loaded.
_TORCH_FREE_MAIN = ("import sys; from mapreduce_rust_tpu_torch.__main__ import main; "
                    "rc = main(sys.argv[1:]); print('torch loaded:', 'torch' in sys.modules); "
                    "sys.exit(rc)")


def _analysis_cli(work: pathlib.Path, name: str, args: list, ok=(0,),
                  torch_free: bool = False) -> str:
    """One analysis command of the port's CLI in a subprocess with its own
    timeout; returns its standard output, which must not be empty. With
    ``torch_free`` the process must also end without torch loaded."""
    t0 = time.perf_counter()
    cmd = (["-c", _TORCH_FREE_MAIN] if torch_free else ["-m", "mapreduce_rust_tpu_torch"])
    r = subprocess.run([sys.executable, *cmd, *args],
                       capture_output=True, text=True, timeout=120, cwd=ROOT)
    check(r.returncode in ok and r.stdout.strip(),
          f"cli {name}: exit {r.returncode}, {len(r.stdout)} bytes of output\n"
          f"{r.stderr[-2000:]}")
    if torch_free:
        check(r.stdout.rstrip().endswith("torch loaded: False"),
              f"cli {name}: torch was loaded: {r.stdout[-300:]}")
    emit({"phase": "analysis-cli", "command": name, "rc": r.returncode,
          "seconds": time.perf_counter() - t0, "output_lines": len(r.stdout.splitlines()),
          **({"torch_loaded": False} if torch_free else {})})
    return r.stdout


def phase_control_cli(work: pathlib.Path) -> None:
    """check over cluster-kill's artifacts (a lease expiry and a
    re-execution conform to the protocol) and a small-depth model of the
    lease surface: each exits 0 and never loads torch."""
    doc = json.loads(_analysis_cli(work, "check", [
        "check", str(work / "kill-work"), "--format", "json"], torch_free=True)
        .rsplit("torch loaded:", 1)[0])
    check(doc["ok"] and doc["checked"]["journal_lines"] > 0,
          f"check: {doc['violations'][:4]}")
    out = _analysis_cli(work, "model", ["model", "--focus", "lease", "--budget", "400",
                                        "--depth", "10"], torch_free=True)
    check("mrmodel: ok" in out, f"model: {out[-500:]}")
    emit({"phase": "control-cli", "check_events": doc["checked"]["events"],
          "check_journal_lines": doc["checked"]["journal_lines"],
          "model": out.splitlines()[0]})


def phase_prof_cli(work: pathlib.Path, machine: pathlib.Path) -> None:
    """stats, doctor, prof --roofline, lineage and trace merge over the prof
    and prof-host phases' artifacts."""
    pm, hm = str(work / "prof-manifest.json"), str(work / "prof-host-manifest.json")
    _analysis_cli(work, "stats", ["stats", pm])
    _analysis_cli(work, "stats-diff", ["stats", str(work / "main-manifest.json"), pm,
                                       "--no-gate"])
    _analysis_cli(work, "doctor", ["doctor", pm, "--trace", str(work / "prof-trace.json")])
    folded = work / "prof-host.folded"
    doc = json.loads(_analysis_cli(work, "prof", [
        "prof", hm, "--roofline", "--machine", str(machine), "--folded", str(folded),
        "--format", "json"]))
    _analysis_cli(work, "prof-text", ["prof", hm, "--roofline", "--machine", str(machine)])
    check(folded.stat().st_size > 0, "prof: empty .folded export")
    stages = doc["roofline"]["stages"]
    check(stages, "prof: no roofline stage")
    over = [s for s in stages if s.get("frac") is not None and s["frac"] > 1.05]
    check(not over, f"prof: roofline fractions above 1.05: {over}")
    check(any(s["stage"] == "device-merge" for s in stages),
          f"prof: no device-merge row from prof-host's merge_cost: {stages}")
    emit({"phase": "roofline", "stages": stages,
          "device_hbm_gbs": doc["roofline"]["machine"]["device_hbm_gbs"]})
    lw = str(work / "prof-work")
    _analysis_cli(work, "lineage", ["lineage", lw])
    _analysis_cli(work, "lineage-forward", ["lineage", lw, "--forward", "0"])
    back = json.loads(_analysis_cli(work, "lineage-backward", [
        "lineage", lw, "--backward", "0", "--format", "json"]))
    ledger = [json.loads(line) for line in (work / "prof-work" / "lineage.jsonl")
              .read_text().splitlines()]
    digests = {rec["dg"] for rec in ledger if rec.get("t") == "chunk"}
    named = [c["dg"] for c in back["chunks"]]
    check(named and set(named) <= digests,
          f"lineage: the backward query names chunks outside the ledger: {named[:4]}")
    _analysis_cli(work, "trace-merge", ["trace", "merge", str(work / "prof-merged.json"),
                                        str(work / "prof-trace.json")])


def phase_fleet_cli(work: pathlib.Path) -> None:
    """fleet over the service phase's service root: the fleet's and every
    worker's utilization in [0, 1]."""
    doc = json.loads(_analysis_cli(work, "fleet", ["fleet", str(work / "service-work"),
                                                   "--format", "json"]))
    utils = [doc["fleet"]["util_frac"]] + [w["util_frac"] for w in doc["workers"].values()]
    check(all(0.0 <= u <= 1.0 for u in utils), f"fleet: utilizations outside [0, 1]: {utils}")
    emit({"phase": "fleet", "util_frac": utils[0], "worker_util_frac": utils[1:],
          "bubble_frac": doc["fleet"]["bubble_frac"], "jobs": len(doc["jobs"])})


#: The bench phase: bench_torch.py with every leg on at a smoke's sizes
#: (one device run, one overhead run per side), then its --sort-leg.
BENCH_ENV = {"BENCH_TARGET_MB": "16", "BENCH_BASELINE_MB": "16", "BENCH_ZIPF_MB": "16",
             "BENCH_METRICS_OVERHEAD_MB": "8", "BENCH_DEVICE_RUNS": "1",
             "BENCH_OVERHEAD_RUNS": "1", "BENCH_SORT_MB": "8"}


def _bench_start(bench_dir: pathlib.Path, args: list, **extra) -> tuple:
    """Start bench_torch.py with BENCH_ENV (and ``extra``) and BENCH_DIR
    ``bench_dir``, its stdout and stderr in files there: (process, args,
    stdout path, stderr path)."""
    import os

    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(BENCH_ENV, BENCH_DIR=str(bench_dir), **extra)
    bench_dir.mkdir(parents=True, exist_ok=True)
    files = (bench_dir / f"{args[0].lstrip('-')}.out", bench_dir / f"{args[0].lstrip('-')}.err")
    with open(files[0], "w") as out, open(files[1], "w") as err:
        proc = subprocess.Popen([sys.executable, str(ROOT / "bench_torch.py"), *args],
                                stdout=out, stderr=err, text=True, cwd=ROOT, env=env)
    return (proc, args, *files)


def _bench_result(started: tuple, deadline: float) -> dict:
    """Wait for a bench_torch.py started by _bench_start until ``deadline``
    (time.monotonic()); its exit code must be 0 and its one stdout line
    parse."""
    proc, args, out_path, err_path = started
    try:
        rc = proc.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = None
    stdout, stderr = out_path.read_text(), err_path.read_text()
    lines = stdout.strip().splitlines()
    check(rc == 0 and len(lines) == 1,
          f"bench {args}: exit {rc}, stdout {stdout[-1500:]}\n{stderr[-2500:]}")
    return json.loads(lines[0])


def _bench_line(work: pathlib.Path, args: list, timeout: int, **extra) -> dict:
    """Run bench_torch.py with BENCH_ENV (and ``extra``) and BENCH_DIR in
    the work dir to its end; see _bench_result."""
    return _bench_result(_bench_start(work / "bench", args, **extra),
                         time.monotonic() + timeout)


def phase_bench(work: pathlib.Path) -> dict:
    """bench_torch.py end to end on the card: the GB/s line (value,
    vs_baseline, platform cuda), the Zipf leg exact, every leg's
    tokenize_hash launches equal to its chunks, the measured leg's run
    manifest naming the card, and the leg's kernel builds (its warm-up's)
    counted outside the measured run; then --sort-leg, exact and ordered."""
    import torch

    t0 = time.perf_counter()
    manifest = work / "bench-manifest.json"
    line = _bench_line(work, ["--manifest", str(manifest)], timeout=400)
    check(line["unit"] == "GB/s" and line["value"] is not None
          and line["vs_baseline"] is not None and line["platform"] == "cuda"
          and "error" not in line, f"bench: {line}")
    check(line["zipf"]["exact"], f"bench: zipf leg not exact: {line['zipf']}")
    run = json.loads((work / "bench-manifest-run.json").read_text())
    chunks = run["stats"]["chunks"]
    launches = (run.get("kernel_launches") or {}).get("tokenize_hash")
    check(run["platform"].get("device_name") == torch.cuda.get_device_name(0),
          f"bench: the run manifest names {run['platform'].get('device_name')}")
    check(chunks > 0 and launches == chunks,
          f"bench: {launches} tokenize_hash launches for {chunks} chunks")
    builds = line.get("kernel_builds") or {}
    check(builds.get("count", 0) >= 1, f"bench: the device leg recorded no kernel build: {builds}")
    # The warm-up built or loaded the kernels: the measured run's compile
    # block holds only builds made inside its own wall, if any.
    compile_s = (run["stats"].get("compile") or {}).get("total_s", 0.0)
    check(compile_s <= run["stats"]["wall_seconds"],
          f"bench: {compile_s} s of builds in a {run['stats']['wall_seconds']} s run")
    legs = {"zipf": line["zipf"], **{k: line[k] for k in (
        "metrics_overhead", "profile_overhead", "lineage_overhead")}}
    for name, leg in legs.items():
        check(leg["launches"] == leg["chunks"] > 0,
              f"bench {name}: {leg['launches']} launches for {leg['chunks']} chunks")
        check(leg.get("outputs_identical", True), f"bench {name}: outputs differ")
    # The manifest's lint block: the port's linter over the checkout, clean.
    lint = json.loads(manifest.read_text()).get("lint") or {}
    check(lint.get("ok") is True and lint.get("findings") == 0,
          f"bench: the manifest's lint block is {lint}")
    bench_s = time.perf_counter() - t0
    sort = _bench_line(work, ["--sort-leg"], timeout=200)
    check(sort["sort_exact"] and sort["sort_launches"] == sort["sort_chunks"] > 0,
          f"bench --sort-leg: {sort}")
    out = {"phase": "bench", "seconds": time.perf_counter() - t0, "bench_s": bench_s,
           "value_gbs": line["value"], "vs_baseline": line["vs_baseline"],
           "metric": line["metric"], "kernel_builds": builds,
           "run_compile": run["stats"].get("compile"),
           "launches": {"device": launches, **{k: v["launches"] for k, v in legs.items()},
                        "sort": sort["sort_launches"]},
           "chunks": {"device": chunks, **{k: v["chunks"] for k, v in legs.items()},
                      "sort": sort["sort_chunks"]},
           "micro": line["device_micro"], "zipf_wall_s": line["zipf"]["wall_s"],
           "overhead_frac": {k: line[k]["frac"] for k in (
               "metrics_overhead", "profile_overhead", "lineage_overhead")},
           "doctor": line["doctor"].get("bottleneck"), "sort_wall_s": sort["sort_wall_s"],
           "lint": lint}
    emit(out)
    return out


#: bench_torch.py's other modes at the bench-modes phase's sizes: the sched
#: A/B on 4 documents per corpus at 2 copies of each text (the reference
#: bench's 12 and 8), one dispatch A/B repeat (3).
BENCH_MODES_ENV = {"BENCH_SCHED_AB_DOCS": "4", "BENCH_SCHED_AB_SCALE": "2",
                   "BENCH_DISPATCH_AB_REPEATS": "1"}


def _fleet_workers(name: str, workers: list, card: str) -> dict:
    """Each worker manifest of a fleet names the card, built nothing and
    launched tokenize_hash once per map task it was granted (every
    document of these fleets is one chunk); returns the sums."""
    check(workers, f"{name}: no worker manifest")
    for w in workers:
        check(w["engine"] == "device" and w["device_name"] == card,
              f"{name}: a worker ran {w['engine']} on {w['device_name']}")
        check(w["tokenize_hash"] == w["map_grants"],
              f"{name}: a worker launched tokenize_hash {w['tokenize_hash']} times "
              f"for {w['map_grants']} one-chunk map tasks")
        check((w["kernel_builds"] or {}).get("cache_misses") == 0,
              f"{name}: a worker built a kernel: {w['kernel_builds']}")
    return {"tokenize_hash": sum(w["tokenize_hash"] for w in workers),
            "map_grants": sum(w["map_grants"] for w in workers)}


def phase_bench_modes(work: pathlib.Path) -> dict:
    """bench_torch.py's other modes on the card, each line checked: the
    chaos matrix (every leg recovered, bit-identical, run_check clean; the
    fault-free baseline with no lease expiry or re-execution; both slow
    pairs fired, identical, on cuda), the sched A/B (every job done, K-3
    cache hits, run_check clean on both sides), the model leg, a two-point
    integer sweep and a two-point Zipf sweep at 16 MB, and one dispatch
    A/B repeat, these five together after the chaos matrix. Every worker
    manifest names the card, and the device workers' tokenize_hash
    launches equal their map tasks' chunks, none for a cache hit."""
    import torch

    card = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    chaos = _bench_line(work, ["--chaos"], 600, **BENCH_MODES_ENV)
    seconds = {"chaos": round(time.perf_counter() - t0, 1)}
    check(chaos["ok"] and chaos["platform"] == "cuda" and chaos["map_engine"] == "device",
          f"bench --chaos: {json.dumps(chaos)[:3000]}")
    fleets = {}
    for r in chaos["scenarios"]:
        check(r["recovered"] and r["bit_identical"] and r["mrcheck"]["ok"],
              f"bench --chaos {r['scenario']}: {r}")
        fleets[r["scenario"]] = _fleet_workers(f"chaos {r['scenario']}", r["workers"], card)
        if r["scenario"].startswith("baseline"):
            totals = json.loads((pathlib.Path(r["dir"]) / "work" / "job_report.json")
                                .read_text())["report"]["totals"]
            check(all(t["expiries"] == t["re_executions"] == 0 for t in totals.values()),
                  f"bench --chaos {r['scenario']}: expiries in a fault-free run: {totals}")
            check(fleets[r["scenario"]]["tokenize_hash"] == 3,
                  f"bench --chaos {r['scenario']}: {fleets[r['scenario']]}")
    for pname in ("slow_disk_pair", "slow_dispatch_pair"):
        pair = chaos[pname]
        check(pair["fired"] > 0 and pair["outputs_identical"] and pair["platform"] == "cuda"
              and pair["device_name"] == card, f"bench --chaos {pname}: {pair}")

    # The other modes run together, each in a BENCH_DIR of its own: their
    # checks are exact, and their times, contended here, are measured alone
    # by running each mode by itself (PERF.md). The chaos matrix above runs
    # alone: its walls and the pairs' hidden_s are gated.
    t = time.perf_counter()
    group = {tag: _bench_start(work / f"bench-{tag}", args, **BENCH_MODES_ENV)
             for tag, args in (
                 ("sched-ab", ["--sched-ab"]), ("model", ["--model-leg"]),
                 ("sweep-host-workers", ["--sweep-host-workers", "1,4"]),
                 ("sweep-spill-budget", ["--sweep-spill-budget", "131072,524288"]),
                 ("dispatch-ab", ["--dispatch-ab"]))}
    deadline = time.monotonic() + 400
    res = {tag: _bench_result(started, deadline) for tag, started in group.items()}
    seconds["together"] = round(time.perf_counter() - t, 1)

    ab = res["sched-ab"]
    check(ab["ok"] and ab["platform"] == "cuda", f"bench --sched-ab: {json.dumps(ab)[:3000]}")
    docs = int(BENCH_MODES_ENV["BENCH_SCHED_AB_DOCS"])
    for side in ("fifo", "pipeline"):
        r = ab[side]
        check(r["ok"] and r["completed"] == ab["k_jobs"]
              and r["cache_hits"] == ab["k_jobs"] - 3 and r["mrcheck"]["ok"],
              f"bench --sched-ab {side}: {r}")
        fleets[f"sched-{side}"] = f = _fleet_workers(f"sched-ab {side}", r["workers"], card)
        check(f["tokenize_hash"] == f["map_grants"] == 3 * docs,
              f"bench --sched-ab {side}: {f} for 3 computed jobs of {docs} documents")

    model = res["model"]
    check(model["model_ok"] and model["model_schedules_per_s"] > 0, f"bench --model-leg: {model}")

    sweeps = {}
    for tag, engine in (("sweep-host-workers", "host"), ("sweep-spill-budget", "device")):
        sw = res[tag]
        check(sw["map_engine"] == engine and sw["platform"] == "cuda"
              and all("error" not in p and p["gbs"] > 0 for p in sw["sweep"]),
              f"bench {tag}: {sw}")
        launches = []
        for p in sw["sweep"]:
            run = json.loads(pathlib.Path(p["manifest"]).read_text())
            n = (run.get("kernel_launches") or {}).get("tokenize_hash", 0)
            check(run["platform"].get("device_name") == card
                  and n == (run["stats"]["chunks"] if engine == "device" else 0),
                  f"bench {tag}: {n} launches for {run['stats']['chunks']} chunks on "
                  f"{run['platform'].get('device_name')}")
            launches.append(n)
        sweeps[tag] = {"gbs": [p["gbs"] for p in sw["sweep"]],
                       "speedup_vs_first": sw["speedup_vs_first"], "launches": launches}

    dab = res["dispatch-ab"]
    check(dab["value"] is not None and dab["platform"] == "cuda" and "error" not in dab,
          f"bench --dispatch-ab: {dab}")

    out = {"phase": "bench-modes", "seconds": time.perf_counter() - t0,
           "mode_seconds": seconds, "card": card, "together": list(group),
           "chaos": {"baseline_wall_s": chaos["baseline_wall_s"],
                     "speculation_speedup": chaos["speculation_speedup"],
                     "scenarios": {r["scenario"]: {"wall_s": r["wall_s"],
                                                   "recovery_cost_s": r.get("recovery_cost_s")}
                                   for r in chaos["scenarios"]},
                     "hidden_s": {k: chaos[k]["hidden_s"]
                                  for k in ("slow_disk_pair", "slow_dispatch_pair")},
                     "pairs": {k: {side: chaos[k][side] for side in ("async", "sync")}
                               for k in ("slow_disk_pair", "slow_dispatch_pair")}},
           "sched_ab": {"speedup": ab["value"], **{
               side: {k: ab[side][k] for k in ("value", "wall_s", "queue_wait_p95_s",
                                                "cache_hit_rate", "fleet_bubble_frac")}
               for side in ("fifo", "pipeline")}},
           "model_schedules_per_s": model["model_schedules_per_s"],
           "model_explored": model["model_explored"], "sweeps": sweeps,
           "dispatch_ab": {"speedup": dab["value"], "plane_wall_s": dab["plane"]["wall_s"],
                           "pr10_wall_s": dab["pr10"]["wall_s"]},
           "launches": fleets}
    emit(out)
    return out


def write_text_corpus(dirpath: pathlib.Path) -> list[bytes]:
    import numpy as np

    rng = np.random.default_rng(7)
    vocab = [b"w%d" % i for i in range(5000)] + [
        s.encode() for s in ("café", "naïve", "Ωmega", "don’t", "“quoted”",
                             "end—dash", "ｗｉｄｅ", "日本語", "it's", "x,y", "--")]
    seps = [b" ", b"\t", b"\r\n", b"\n", b"  ", " ".encode()]
    blobs = []
    for i in range(3):
        n = 400_000
        ws = rng.integers(0, len(vocab), n).tolist()
        ss = rng.integers(0, len(seps), n).tolist()
        blob = b"".join(vocab[w] + seps[s] for w, s in zip(ws, ss))
        (dirpath / f"text-{i}.txt").write_bytes(blob)
        blobs.append(blob)
    return blobs


def _cli(work: pathlib.Path, tag: str, args: list) -> tuple[pathlib.Path, float, str]:
    out = work / f"text-out-{tag}"
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "mapreduce_rust_tpu_torch", "run", *args,
         "--output", str(out), "--work", str(work / f"text-work-{tag}"), "--reduce-n", "4"],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
    )
    wall = time.perf_counter() - t0
    check(r.returncode == 0, f"cli run ({tag}) failed ({r.returncode}):\n{r.stderr[-3000:]}")
    return out, wall, r.stdout.strip().splitlines()[0]


def _lines(out: pathlib.Path) -> list[bytes]:
    return sorted(line for path in sorted(out.glob("mr-*.txt"))
                  for line in path.read_bytes().splitlines())


def phase_cli(work: pathlib.Path, corpus: pathlib.Path, blobs: list[bytes]) -> None:
    import os

    from mapreduce_rust_tpu_torch.core.normalize import normalize_unicode, reference_word_counts
    from mapreduce_rust_tpu_torch.runtime.dictionary import extract_words

    per_file = [{w.encode(): c for w, c in reference_word_counts(b).items()} for b in blobs]
    want: dict = {}
    for counts in per_file:
        for w, c in counts.items():
            want[w] = want.get(w, 0) + c
    for engine in ("device", "host"):
        out, wall, summary = _cli(work, engine, ["--input", str(corpus),
                                                 "--map-engine", engine])
        got: dict = {}
        for path in sorted(out.glob("mr-*.txt")):
            for line in path.read_bytes().splitlines():
                w, v = line.rsplit(b" ", 1)
                check(w not in got, f"word {w!r} emitted twice")
                got[w] = int(v)
        check(got == want, f"cli output ({engine}) differs from reference_word_counts "
              f"({len(got)} vs {len(want)} words)")
        emit({"phase": "cli", "app": "word_count", "map_engine": engine, "exact": True,
              "words": len(got), "bytes": sum(len(b) for b in blobs), "wall_s": wall,
              "summary": summary})

    # grep on the device engine: the posting list of each query word.
    query = ["w1", "w4999", "café", "don’t", "naïve", "nothere"]
    out, wall, summary = _cli(work, "grep", ["--input", str(corpus), "--app", "grep",
                                             "--query", ",".join(query)])
    norm = [extract_words(normalize_unicode(q.encode()))[0] for q in query]
    want_lines = sorted(b"%s %s" % (w, b",".join(b"%d" % d for d, c in enumerate(per_file)
                                                   if w in c))
                        for w in norm if any(w in c for c in per_file))
    got_lines = _lines(out)
    check(got_lines == want_lines, f"cli grep lines {got_lines} differ from {want_lines}")
    emit({"phase": "cli", "app": "grep", "map_engine": "device", "exact": True,
          "query": query, "output_lines": len(got_lines), "wall_s": wall, "summary": summary})

    # join on the host engine: a = the first two files, b = the third.
    sides = {"a": work / "text-a", "b": work / "text-b"}
    files = sorted(corpus.glob("*.txt"))
    for side, idx in (("a", (0, 1)), ("b", (2,))):
        sides[side].mkdir()
        for i in idx:
            os.link(files[i], sides[side] / files[i].name)
    out, wall, summary = _cli(work, "join", ["--app", "join", "--map-engine", "host",
                                             "--input", f"a={sides['a']}", f"b={sides['b']}"])
    want_lines = sorted(b"%s %d %d" % (w, a, b)
                        for w in want for a in (0, 1) if w in per_file[a]
                        for b in (0,) if w in per_file[2])
    got_lines = _lines(out)
    check(got_lines == want_lines, f"cli join: {len(got_lines)} lines, want {len(want_lines)}")
    emit({"phase": "cli", "app": "join", "map_engine": "host", "exact": True,
          "output_lines": len(got_lines), "wall_s": wall, "summary": summary})

    # Both spill tiers on the device engine, then ``clean``.
    out, wall, summary = _cli(work, "spill", ["--input", str(corpus), "--accum-budget-mb", "0",
                                              "--dict-budget-words", "4096"])
    got = dict(line.rsplit(b" ", 1) for line in _lines(out))
    check({w: int(v) for w, v in got.items()} == want and len(got) == len(_lines(out)),
          "cli budgeted run differs from reference_word_counts")
    tiers = re.search(r"spill\[runs acc=(\d+) dict=(\d+)", summary)
    check(tiers is not None and min(int(tiers[1]), int(tiers[2])) > 0,
          f"cli budgeted run: a tier wrote no run: {summary}")
    r = subprocess.run(
        [sys.executable, "-m", "mapreduce_rust_tpu_torch", "clean", "--output", str(out),
         "--work", str(work / "text-work-spill")],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    check(r.returncode == 0 and not list(out.glob("mr-*.txt"))
          and not list((work / "text-work-spill").glob("*run-*")),
          f"cli clean failed ({r.returncode}): {r.stdout} {r.stderr[-2000:]}")
    emit({"phase": "cli", "app": "word_count", "map_engine": "device", "exact": True,
          "budgets": {"accum_mb": 0, "dict_words": 4096}, "words": len(got), "wall_s": wall,
          "summary": summary, "clean": r.stdout.strip()})


def phase_apps(work: pathlib.Path) -> tuple[list[dict], dict]:
    """The five other apps on the zipf-ii corpus (and sort on its own
    24 MiB corpus), each held to its generator's truth. Returns the runs
    and the corpora with their truths, for the spill phases."""
    import os

    from mapreduce_rust_tpu_torch.apps import get_app

    ii_dir = work / "zipf-ii"
    ii_dir.mkdir()
    t0 = time.perf_counter()
    presence, counts01, counts0 = write_ii_corpus(ii_dir)
    emit({"phase": "corpus", "name": "zipf-ii-256M",
          "bytes": sum(p.stat().st_size for p in ii_dir.iterdir()), "docs": II_DOCS,
          "distinct_words": int(presence.any(axis=1).sum()),
          "posting_pairs": int(presence.sum()), "seed": II_SEED,
          "seconds": time.perf_counter() - t0})
    docs = sorted(ii_dir.glob("doc-*.txt"))
    subsets = {"left": docs[:4], "top": docs[:2], "d0": docs[:1], "d2": docs[2:3]}
    for name, members in subsets.items():
        (work / name).mkdir()
        for path in members:
            os.link(path, work / name / path.name)

    runs = []
    ii = drive_job("ii", work, ii_check(presence[:, :4]), app=get_app("inverted_index"),
                   corpus=work / "left")
    check(ii["spilled_keys"] > 0, "ii: no posting pairs were evicted")
    runs.append(ii)
    phase_step("step-ii", docs[0], ii, get_app("inverted_index"))
    runs.append(drive_job("ii-host", work, ii_check(presence[:, :2]),
                          app=get_app("inverted_index"), corpus=work / "top",
                          map_engine="host", merge_capacity=1 << 18,
                          host_window_bytes=16 << 20))
    runs.append(drive_job(
        "grep", work, grep_check(presence[:, :4], GREP_RANKS, GREP_ABSENT),
        app=get_app("grep", query=GREP_QUERY), corpus=work / "left"))
    runs.append(drive_job(
        "join", work, join_check(presence[:, [0, 2]], 1), app=get_app("join"),
        map_engine="host", input_dirs=(("a", str(work / "d0")), ("b", str(work / "d2")))))
    runs.append(drive_job("top_k", work, topk_check(counts01, 20), app=get_app("top_k", k=20),
                          corpus=work / "top"))

    sort_dir = work / "zipf-sort"
    sort_dir.mkdir()
    t0 = time.perf_counter()
    truth = write_zipf_corpus(sort_dir, SORT_BYTES, 1)
    emit({"phase": "corpus", "name": "zipf-sort-24M",
          "bytes": sum(p.stat().st_size for p in sort_dir.iterdir()),
          "tokens": int(truth.sum()), "seconds": time.perf_counter() - t0})
    for name, engine in (("sort", "device"), ("sort-host", "host")):
        runs.append(drive_job(name, work, sort_check(truth), app=get_app("sort"),
                              corpus=sort_dir, map_engine=engine))
    return runs, {"ii_dir": ii_dir, "presence": presence, "counts01": counts01,
                  "counts0": counts0, "top_dir": work / "top", "left_dir": work / "left",
                  "d0_dir": work / "d0"}


def phase_spill(work: pathlib.Path, corpus: pathlib.Path, truth, ctx: dict) -> list[dict]:
    """The spill tiers and the streaming egress on the corpora of the
    earlier phases, each exact against its generator's truth."""
    from mapreduce_rust_tpu_torch.apps import get_app

    runs = []
    run = drive_job("spill", work, zipf_check(truth), corpus=corpus,
                    merge_capacity=1 << 18, host_accum_budget_mb=16,
                    dictionary_budget_words=1 << 19)
    check(run["accum_spill_runs"] > 0 and run["dict_spill_runs"] > 0,
          f"spill: a tier wrote no run ({run['accum_spill_runs']} accumulator, "
          f"{run['dict_spill_runs']} dictionary)")
    runs.append(run)
    run = drive_job("spill-host", work, zipf_check(truth), corpus=corpus, **ZIPF_CFG)
    check(run["dict_spill_runs"] > 0, "spill-host: the dictionary wrote no run")
    runs.append(run)
    run = drive_job("spill-ii", work, ii_check(ctx["presence"]),
                    app=get_app("inverted_index"), corpus=ctx["ii_dir"],
                    host_accum_budget_mb=16, dictionary_budget_words=1 << 19)
    check(run["accum_spill_runs"] > 0 and run["dict_spill_runs"] > 0,
          f"spill-ii: a tier wrote no run ({run['accum_spill_runs']} accumulator, "
          f"{run['dict_spill_runs']} dictionary)")
    runs.append(run)
    spill_sort_dir = work / "zipf-sort-48"
    spill_sort_dir.mkdir()
    sort_truth = write_zipf_corpus(spill_sort_dir, SPILL_SORT_BYTES, 1)
    run = drive_job("spill-sort", work, sort_check(sort_truth), app=get_app("sort"),
                    corpus=spill_sort_dir, **{**ZIPF_CFG, "spill_async": False})
    check(run["dict_spill_runs"] > 0, "spill-sort: the dictionary wrote no run")
    runs.append(run)
    run = drive_job("spill-topk", work, topk_check(ctx["counts01"], 20),
                    app=get_app("top_k", k=20), corpus=ctx["top_dir"],
                    dictionary_budget_words=1 << 17)
    check(run["dict_spill_runs"] > 0 and run["merge_fanin"] == 0,
          "spill-topk: the dictionary wrote no run, or the streaming egress ran")
    runs.append(run)
    return runs


#: The mesh phases' shard count: four shards, all on the one card.
MESH_SHARDS = 4
#: mesh-replay's chunk size: 1 MiB makes 17 groups of documents 0-1.
REPLAY_CHUNK = 1 << 20


def _replay_capacity(corpus: pathlib.Path, chunk_bytes: int) -> tuple[int, list[int]]:
    """A partial capacity that some groups of MESH_SHARDS chunks pass and
    others fit: the median of the groups' largest per-chunk distinct-word
    counts (the native scan's, on the chunker's chunks). With a bucket
    slack of 0.5 a group that fits still overflows a bucket, so both
    replay tiers run."""
    from mapreduce_rust_tpu_torch.native.host import scan_unique_raw
    from mapreduce_rust_tpu_torch.runtime.chunker import chunk_stream

    distinct = []
    for doc, path in enumerate(sorted(corpus.glob("*.txt"))):
        with open(path, "rb") as f:
            for chunk in chunk_stream(f, doc, chunk_bytes):
                distinct.append(len(scan_unique_raw(bytes(chunk.data[: chunk.nbytes]))[1]))
    maxes = sorted(max(distinct[i: i + MESH_SHARDS])
                   for i in range(0, len(distinct), MESH_SHARDS))
    return maxes[(len(maxes) - 1) // 2], maxes


class _LogRecords(logging.Handler):
    """The messages the port's logger emits while attached."""

    def __init__(self) -> None:
        super().__init__(logging.INFO)
        self.messages: list[str] = []

    def emit(self, record) -> None:
        self.messages.append(record.getMessage())


def phase_mesh(work: pathlib.Path, corpus: pathlib.Path, truth, ctx: dict) -> list[dict]:
    """The single-process mesh (parallel/shuffle.py), MESH_SHARDS shards on
    the one card: zipf-128M through the chunked mesh and the halo-sharded
    stream, each exact and byte-identical to the main phase's files;
    inverted_index on zipf-ii-256M; both replay tiers and the top-k
    selection on documents 0-1. Each launches tokenize_hash once per shard
    per round."""
    from mapreduce_rust_tpu_torch.apps import get_app
    from mapreduce_rust_tpu_torch.runtime.metrics import log as port_log

    main_digests = _digests(work / "main-out")

    def identical(name: str):
        def run(res):
            fields = zipf_check(truth)(res)
            check(_digests(work / f"{name}-out") == main_digests,
                  f"{name}: mr-{{r}}.txt differ from the main phase's")
            return {**fields, "identical_to_main": True}

        return run

    runs = [drive_job("mesh", work, identical("mesh"), corpus=corpus,
                      mesh_shape=MESH_SHARDS)]
    sharded = drive_job("sharded", work, identical("sharded"), corpus=corpus,
                        mesh_shape=MESH_SHARDS, sharded_stream=True)
    runs.append(sharded)
    runs.append(drive_job("mesh-ii", work, ii_check(ctx["presence"][:, :2]),
                          app=get_app("inverted_index"), corpus=ctx["top_dir"],
                          mesh_shape=MESH_SHARDS))
    t0 = time.perf_counter()
    cap, maxes = _replay_capacity(ctx["top_dir"], REPLAY_CHUNK)
    probe_s = time.perf_counter() - t0
    replay = drive_job("mesh-replay", work, zipf_check(ctx["counts01"]),
                       corpus=ctx["top_dir"], mesh_shape=MESH_SHARDS,
                       chunk_bytes=REPLAY_CHUNK, partial_capacity=cap,
                       bucket_capacity_factor=0.5)
    check(replay["partial_overflow_replays"] > 0 and replay["bucket_skew_replays"] > 0,
          f"mesh-replay: replays {replay['partial_overflow_replays']} partial, "
          f"{replay['bucket_skew_replays']} skew")
    runs.append(replay)
    records = _LogRecords()
    port_log.addHandler(records)
    level = port_log.level
    port_log.setLevel(logging.INFO)
    try:
        topk = drive_job("mesh-topk", work, topk_check(ctx["counts01"], 20),
                         app=get_app("top_k", k=20), corpus=ctx["top_dir"],
                         mesh_shape=MESH_SHARDS)
    finally:
        port_log.removeHandler(records)
        port_log.setLevel(level)
    taken = [m for m in records.messages if m.startswith("device top-20 selection:")]
    check(taken, f"mesh-topk: no device selection in the driver's log: {records.messages}")
    runs.append(topk)
    # What the two phases' own lines do not show: how mesh-replay's
    # capacity was chosen and mesh-topk's log record.
    emit({"phase": "mesh-checks", "replay_partial_capacity": cap,
          "replay_group_max_distinct": maxes, "replay_probe_s": probe_s,
          "topk_selection": taken[0]})
    return runs


def phase_mesh_ckpt(work: pathlib.Path, corpus: pathlib.Path, truth) -> dict:
    """The CLI's ``run --mesh 4 --checkpoint-every 1`` on document 0 of
    zipf-ii-256M (two groups), SIGKILLed as soon as its first checkpoint is on disk,
    then ``--resume``: exact, and the resumed process's manifest counts one
    tokenize_hash launch per shard per round it ran, the rounds of the
    groups after the checkpoint."""
    import signal

    import numpy as np
    import torch

    from mapreduce_rust_tpu_torch.config import Config
    from mapreduce_rust_tpu_torch.parallel.shuffle import make_mesh

    out_dir, work_dir = work / "ckpt-out", work / "ckpt-work"
    manifest = work / "ckpt-manifest.json"
    cmd = [sys.executable, "-m", "mapreduce_rust_tpu_torch", "run", "--input", str(corpus),
           "--output", str(out_dir), "--work", str(work_dir), "--reduce-n", "8",
           "--mesh", str(MESH_SHARDS), "--checkpoint-every", "1"]
    ckpt = work_dir / "driver.ckpt.npz"
    t0 = time.perf_counter()
    with open(work / "ckpt-first.log", "wb") as log:
        first = subprocess.Popen(cmd, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 300
        while not ckpt.exists() and first.poll() is None and time.monotonic() < deadline:
            time.sleep(0.005)
        first.send_signal(signal.SIGKILL)
        rc_first = first.wait(timeout=60)
    finally:
        if first.poll() is None:
            first.kill()
            first.wait()
    killed_s = time.perf_counter() - t0
    if rc_first != -signal.SIGKILL:
        print((work / "ckpt-first.log").read_bytes()[-3000:].decode(errors="replace"),
              file=sys.stderr)
    check(rc_first == -signal.SIGKILL, f"mesh-ckpt: the first run exited {rc_first}, "
          "not by SIGKILL after a checkpoint")
    with np.load(ckpt) as z:
        groups_done = int(z["groups_done"])
    t1 = time.perf_counter()
    r = subprocess.run([*cmd, "--resume", "--manifest", str(manifest)], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    resumed_s = time.perf_counter() - t1
    check(r.returncode == 0, f"mesh-ckpt: the resumed run failed ({r.returncode}):\n"
          f"{r.stderr[-3000:]}")
    files = sorted(str(p) for p in out_dir.glob("mr-*.txt"))
    lines = check_zipf_outputs(files, truth)
    m = json.loads(manifest.read_text())
    s = m["stats"]
    launches = m["kernel_launches"]["tokenize_hash"]
    groups = -(-_map_chunks(sorted(corpus.glob("*.txt")), Config.chunk_bytes) // MESH_SHARDS)
    ran = s["mesh_rounds"] - s["partial_overflow_replays"] - s["bucket_skew_replays"]
    check(0 < groups_done < groups, f"mesh-ckpt: killed after {groups_done} of {groups} groups")
    check(ran == groups - groups_done, f"mesh-ckpt: the resumed run ran {ran} groups, "
          f"{groups - groups_done} were left")
    check(launches == MESH_SHARDS * s["mesh_rounds"] > 0,
          f"mesh-ckpt: {launches} launches in {s['mesh_rounds']} rounds")
    check(m["platform"].get("device_name") == torch.cuda.get_device_name(0),
          f"mesh-ckpt: the manifest names no card: {m['platform']}")
    mesh = make_mesh(MESH_SHARDS, "cuda")
    out = {"phase": "mesh-ckpt", "exact": True, "map_engine": "device",
           "first_run_killed_after_s": killed_s, "groups_done_at_kill": groups_done,
           "groups": groups, "resumed_wall_s": resumed_s,
           "resumed_stream_s": s["phase_seconds"]["stream"],
           "resumed_rounds": s["mesh_rounds"], "launches": {"tokenize_hash": launches},
           "output_lines": lines, "shard_devices": [str(dev) for dev in mesh.devices],
           "device_count": torch.cuda.device_count()}
    emit(out)
    return out


#: Ranks of the multi-process mesh phases: each owns MESH_SHARDS // MH_RANKS
#: shards, all on the one card, so NCCL (one rank per card) cannot carry
#: their collectives and gloo does.
MH_RANKS = 2


def phase_mh(work: pathlib.Path, name: str, corpus: pathlib.Path, check_outputs,
             app_args: tuple = ()) -> dict:
    """The multi-process mesh through the CLI: MH_RANKS processes of ``run
    --distributed --mesh 4 --dist-backend gloo`` on ``corpus``, one
    document per rank. Every rank's scan kernel runs on the card; gloo
    carries the all_to_all and the round sums between the processes.
    ``check_outputs(files)`` holds every rank's mr-{r}.p{rank}.txt together
    to the generator's truth (a word in two ranks' files fails it). Each
    rank's manifest must count MESH_SHARDS // MH_RANKS launches per round,
    the ranks equal rounds, and the work dir only this job's dictionary
    shards and markers."""
    import torch

    out_dir, work_dir, logs = work / f"{name}-out", work / f"{name}-work", work / f"{name}-logs"
    logs.mkdir()
    port = _free_port()
    cmds = [[sys.executable, "-m", "mapreduce_rust_tpu_torch", "run", "--distributed",
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(MH_RANKS),
             "--process-id", str(rank), "--dist-backend", "gloo",
             "--mesh", str(MESH_SHARDS), "--input", str(corpus), "--output", str(out_dir),
             "--work", str(work_dir), "--reduce-n", "8",
             "--manifest", str(logs / "manifest.json"), *app_args]
            for rank in range(MH_RANKS)]
    procs = []
    t0 = time.perf_counter()
    try:
        for rank, cmd in enumerate(cmds):
            with open(logs / f"rank{rank}.log", "wb") as log:
                procs.append(subprocess.Popen(cmd, cwd=ROOT, stdout=log,
                                              stderr=subprocess.STDOUT))
        rcs = []
        for p in procs:
            try:
                rcs.append(p.wait(timeout=600))
            except subprocess.TimeoutExpired:
                rcs.append(None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    if rcs != [0] * MH_RANKS:
        for rank in range(MH_RANKS):
            tail = (logs / f"rank{rank}.log").read_bytes()[-3000:].decode(errors="replace")
            print(f"--- {name} rank {rank} (rc {rcs[rank]}):\n{tail}", file=sys.stderr)
    check(rcs == [0] * MH_RANKS, f"{name}: the ranks exited {rcs}")
    files = sorted(str(p) for p in out_dir.glob("mr-*.txt"))
    check(len(files) == 8 * MH_RANKS, f"{name}: {len(files)} output files")
    fields = check_outputs(files)
    ranks = []
    d_local = MESH_SHARDS // MH_RANKS
    for rank in range(MH_RANKS):
        m = json.loads((logs / f"manifest-p{rank}.json").read_text())
        s = m["stats"]
        launches = m["kernel_launches"]["tokenize_hash"]
        check(s["unknown_keys"] == 0 and s["hash_collisions"] == 0,
              f"{name} rank {rank}: {s['unknown_keys']} unknown keys, "
              f"{s['hash_collisions']} hash collisions")
        check(launches == d_local * s["mesh_rounds"] > 0,
              f"{name} rank {rank}: tokenize_hash launched {launches} times in "
              f"{s['mesh_rounds']} rounds of {d_local} shards")
        check(m["platform"].get("device_name") == torch.cuda.get_device_name(0),
              f"{name} rank {rank}: the manifest names no card: {m['platform']}")
        check(m["cluster"]["process_count"] == MH_RANKS
              and m["cluster"]["process_index"] == rank,
              f"{name} rank {rank}: cluster {m['cluster']}")
        check(s["device_mem_high_bytes"] > 0, f"{name} rank {rank}: no device memory")
        ranks.append({"rank": rank, "launches": {"tokenize_hash": launches},
                      "wall_s": s["wall_seconds"], "stream_s": s["phase_seconds"]["stream"],
                      "finalize_s": s["phase_seconds"].get("finalize"),
                      "egress_s": s["phase_seconds"].get("egress"),
                      "all_to_all_s": s["all_to_all_s"],
                      "device_wait_s": s["device_wait_s"], "mesh_rounds": s["mesh_rounds"],
                      "shuffle_wire_bytes": s["shuffle_wire_bytes"], "chunks": s["chunks"],
                      "bytes_in": s["bytes_in"], "distinct_keys": s["distinct_keys"],
                      "dictionary_words": s["dictionary_words"],
                      "partial_overflow_replays": s["partial_overflow_replays"],
                      "bucket_skew_replays": s["bucket_skew_replays"],
                      "device_mem_high_bytes": s["device_mem_high_bytes"]})
    rounds = {r["mesh_rounds"] for r in ranks}
    check(len(rounds) == 1, f"{name}: the ranks ran {sorted(rounds)} rounds")
    left = [p.name for p in work_dir.glob("*run-*")]
    check(not left, f"{name}: spill run files left in the work dir: {left[:4]}")
    shards = sorted(p.name for p in work_dir.glob("dict-proc-*"))
    fps = {n.split("-", 3)[3].split(".")[0] for n in shards}
    check(len(shards) == 2 * MH_RANKS and len(fps) == 1,
          f"{name}: dictionary shards and markers in the work dir: {shards}")
    out = {"phase": name, "exact": True, "map_engine": "device", "ranks": ranks,
           "wall_s": wall, "processes": MH_RANKS, "mesh_shape": MESH_SHARDS,
           "dist_backend": "gloo", "device_count": torch.cuda.device_count(),
           "mesh_rounds": ranks[0]["mesh_rounds"], **fields}
    emit(out)
    return out


def phase_multihost(work: pathlib.Path, ctx: dict) -> list[dict]:
    """word_count (``mh``) and grep (``mh-grep``) over documents 0-1 of
    zipf-ii-256M on two ranks: rank r reads document r. The grep query
    holds a word only document 0 has and one only document 1 has, so
    each is printed by whichever rank owns its hash class whether or not
    that rank read it (the dictionary exchange)."""
    import numpy as np

    presence = ctx["presence"][:, :2]
    only = [int(np.flatnonzero(presence[:, d] & ~presence[:, 1 - d])[0]) for d in (0, 1)]
    ranks = (0, 7, *only)
    query = ",".join(["w%06x" % r for r in ranks] + [GREP_ABSENT.decode()])

    def words(files):
        return {"output_lines": check_zipf_outputs(files, ctx["counts01"])}

    def grep(files):
        return grep_check(presence, ranks, GREP_ABSENT)(
            types.SimpleNamespace(output_files=files))

    runs = [phase_mh(work, "mh", ctx["top_dir"], words)]
    runs.append(phase_mh(work, "mh-grep", ctx["top_dir"], grep,
                         ("--app", "grep", "--query", query)))
    runs[-1]["only_in_one_document"] = only
    return runs


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cluster_checks(name: str, out_dir: pathlib.Path, work_dir: pathlib.Path,
                    truth, map_n: int, reduce_n: int) -> dict:
    """Exact outputs, every intermediate shard present, no spill run left;
    returns the output lines and the job report's task durations."""
    files = [str(out_dir / f"mr-{r}.txt") for r in range(reduce_n)]
    lines = check_zipf_outputs(files, truth)
    missing = [f"{kind}-{m}-{r}.{ext}" for m in range(map_n) for r in range(reduce_n)
               for kind, ext in (("mr", "npz"), ("dict", "txt"))
               if not (work_dir / f"{kind}-{m}-{r}.{ext}").exists()]
    check(not missing, f"{name}: intermediate shards missing: {missing[:4]}")
    left = [p.name for p in work_dir.glob("*run-*")]
    check(not left, f"{name}: spill run files left in the work dir: {left[:4]}")
    report = json.loads((work_dir / "job_report.json").read_text())["report"]
    durations = {ph: {tid: t["duration_s"] for tid, t in sorted(tasks.items())}
                 for ph, tasks in report["tasks"].items()}
    for ph in ("map", "reduce"):
        check(report["totals"][ph]["completed"] == (map_n if ph == "map" else reduce_n),
              f"{name}: {report['totals'][ph]['completed']} {ph} tasks completed")
    return {"output_lines": lines, "task_s": durations, "totals": {
        ph: {k: t[k] for k in ("completed", "expiries", "re_executions", "late_reports")}
        for ph, t in report["totals"].items()}}


def _map_chunks(inputs, chunk_bytes: int) -> int:
    """The chunks the device engine streams for these map tasks, one
    ``tokenize_hash`` launch each."""
    from mapreduce_rust_tpu_torch.runtime.chunker import chunk_stream

    chunks = 0
    for path in inputs:
        with open(path, "rb") as f:
            chunks += sum(1 for _ in chunk_stream(f, 0, chunk_bytes))
    return chunks


def phase_cluster(work: pathlib.Path, corpus: pathlib.Path, truth) -> dict:
    """The coordinator and two device-engine workers as asyncio tasks in
    this process, over TCP, on ``corpus`` (one map task per file) with the
    default Config."""
    import asyncio

    import torch

    from mapreduce_rust_tpu_torch.config import Config
    from mapreduce_rust_tpu_torch.coordinator.server import Coordinator
    from mapreduce_rust_tpu_torch.ops.tokenize_cuda import hash_scan, tokenize_hash
    from mapreduce_rust_tpu_torch.worker.runtime import Worker

    out_dir, work_dir = work / "cluster-out", work / "cluster-work"
    inputs = sorted(corpus.glob("*.txt"))
    cfg = Config(map_n=len(inputs), reduce_n=8, worker_n=2, port=_free_port(),
                 input_dir=str(corpus), output_dir=str(out_dir), work_dir=str(work_dir))

    async def cluster():
        serve = asyncio.create_task(Coordinator(cfg).serve())
        await asyncio.sleep(0.2)
        workers = [asyncio.create_task(Worker(cfg, engine="device").run())
                   for _ in range(2)]
        await asyncio.wait_for(asyncio.gather(*workers), timeout=600)
        await asyncio.wait_for(serve, timeout=60)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hash_scan.launches = tokenize_hash.launches = 0
    t0 = time.perf_counter()
    asyncio.run(cluster())
    wall = time.perf_counter() - t0
    launches = {"hash_scan": hash_scan.launches, "tokenize_hash": tokenize_hash.launches}
    peak = torch.cuda.max_memory_allocated()
    chunks = _map_chunks(inputs, cfg.chunk_bytes)
    fields = _cluster_checks("cluster", out_dir, work_dir, truth, len(inputs), cfg.reduce_n)
    # No fault is injected here, so every map task runs once: one launch
    # per chunk, no more.
    reexec = sum(t["re_executions"] for t in fields["totals"].values())
    check(reexec == 0, f"cluster: {reexec} re-executions without an injected fault")
    check(launches["tokenize_hash"] == chunks > 0, f"cluster: tokenize_hash launched "
          f"{launches['tokenize_hash']} times for {chunks} map-task chunks")
    out = {"phase": "cluster", "exact": True, "map_engine": "device", "workers": 2,
           "map_n": len(inputs), "reduce_n": cfg.reduce_n, "wall_s": wall,
           "launches": launches, "chunks": chunks, "device_mem_peak_bytes": peak,
           **fields}
    emit(out)
    return out


def phase_cluster_kill(work: pathlib.Path, corpus: pathlib.Path, truth) -> dict:
    """The CLI: a coordinator and two device-engine worker processes, one
    of which SIGKILLs itself on its first map task. The survivor's
    manifest shows that it ran every map task on the card."""
    import signal

    import torch

    from mapreduce_rust_tpu_torch.config import Config

    out_dir, work_dir = work / "kill-out", work / "kill-work"
    logs = work / "kill-logs"
    logs.mkdir()
    # A 2 s lease checked every 0.3 s: the victim's task expires in
    # seconds, not the default's 5 + 5.
    common = ["--input", str(corpus), "--output", str(out_dir), "--work", str(work_dir),
              "--port", str(_free_port()), "--reduce-n", "8", "--lease-timeout", "2.0",
              "--lease-check-period", "0.3", "--renew-period", "0.3"]
    manifest = ["--manifest", str(logs / "manifest.json")]
    cli = [sys.executable, "-m", "mapreduce_rust_tpu_torch"]
    cmds = {"coordinator": [*cli, "coordinator", "--worker-n", "2", *common],
            "victim": [*cli, "worker", "--engine", "device", "--chaos", "kill:map:*",
                       *manifest, *common],
            "survivor": [*cli, "worker", "--engine", "device", *manifest, *common]}
    timeouts = {"victim": 300, "survivor": 900, "coordinator": 60}
    procs: dict = {}
    rcs: dict = {}
    t0 = time.perf_counter()
    try:
        for name, cmd in cmds.items():
            with open(logs / f"{name}.log", "wb") as log:
                procs[name] = subprocess.Popen(cmd, cwd=ROOT, stdout=log,
                                               stderr=subprocess.STDOUT)
            if name == "coordinator":
                time.sleep(1.0)
        for name in ("victim", "survivor", "coordinator"):
            try:
                rcs[name] = procs[name].wait(timeout=timeouts[name])
            except subprocess.TimeoutExpired:
                rcs[name] = None
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    if rcs != {"victim": -signal.SIGKILL, "survivor": 0, "coordinator": 0}:
        for name in cmds:
            tail = (logs / f"{name}.log").read_bytes()[-3000:].decode(errors="replace")
            print(f"--- cluster-kill {name} (rc {rcs.get(name)}):\n{tail}", file=sys.stderr)
    check(rcs["victim"] == -signal.SIGKILL,
          f"cluster-kill: the victim exited {rcs['victim']}, not by SIGKILL")
    check(rcs["survivor"] == 0, f"cluster-kill: the survivor exited {rcs['survivor']}")
    check(rcs["coordinator"] == 0, f"cluster-kill: the coordinator exited {rcs['coordinator']}")
    fields = _cluster_checks("cluster-kill", out_dir, work_dir, truth,
                             len(list(corpus.glob("*.txt"))), 8)
    expiries = sum(t["expiries"] for t in fields["totals"].values())
    reexec = sum(t["re_executions"] for t in fields["totals"].values())
    check(expiries >= 1 and reexec >= 1, f"cluster-kill: {expiries} lease expiries and "
          f"{reexec} re-executions in job_report.json")
    # The victim dies before its first map task computes, so the survivor
    # ran all of them: one scan launch per chunk of the corpus, on the card.
    survivor = json.loads(
        (logs / f"manifest-w{procs['survivor'].pid}.json").read_text())
    platform = survivor["platform"]
    launches = survivor["kernel_launches"]["tokenize_hash"]
    chunks = _map_chunks(sorted(corpus.glob("*.txt")), Config.chunk_bytes)
    check(platform.get("device_name") == torch.cuda.get_device_name(0),
          f"cluster-kill: the survivor's manifest names no card: {platform}")
    check(survivor["device_mem_high_bytes"] > 0,
          "cluster-kill: the survivor allocated no device memory")
    check(launches == chunks > 0, f"cluster-kill: the survivor launched tokenize_hash "
          f"{launches} times for {chunks} map-task chunks")
    out = {"phase": "cluster-kill", "exact": True, "map_engine": "device",
           "wall_s": wall, "exit_codes": rcs, "expiries": expiries,
           "re_executions": reexec, "survivor_launches": {"tokenize_hash": launches},
           "chunks": chunks, "survivor_device": platform.get("device_name"),
           "survivor_device_mem_high_bytes": survivor["device_mem_high_bytes"],
           **fields}
    emit(out)
    return out


def _job_totals(work_dir: pathlib.Path, jid: str) -> dict:
    report = json.loads((work_dir / f"job-{jid}" / "job_report.json").read_text())["report"]
    return {ph: {k: t[k] for k in ("completed", "expiries", "re_executions", "late_reports")}
            for ph, t in report["totals"].items()}


def phase_service(work: pathlib.Path, ctx: dict) -> dict:
    """The multi-tenant job service in this process: a port JobService.serve()
    and two ServiceWorker(engine="device") as asyncio tasks, three jobs at
    once on document 0 of zipf-ii-256M (word_count, inverted_index and
    grep), each exact against its generator's truth; then
    the word_count spec again, which the result cache must serve with zero
    new grants."""
    import asyncio
    import types

    import torch

    from mapreduce_rust_tpu_torch.config import Config
    from mapreduce_rust_tpu_torch.coordinator.server import CoordinatorClient
    from mapreduce_rust_tpu_torch.ops.tokenize_cuda import hash_scan, tokenize_hash
    from mapreduce_rust_tpu_torch.service.server import JobService
    from mapreduce_rust_tpu_torch.worker.runtime import ServiceWorker

    out_dir, work_dir = work / "service-out", work / "service-work"
    cfg = Config(port=_free_port(), service_max_jobs=3, service_inflight_budget_mb=1024,
                 input_dir=str(ctx["d0_dir"]), output_dir=str(out_dir),
                 work_dir=str(work_dir))
    presence = ctx["presence"]
    jobs = {
        "word_count": ({"app": "word_count", "input_dir": str(ctx["d0_dir"]), "reduce_n": 8},
                       lambda files: {"output_lines": check_zipf_outputs(
                           files, ctx["counts0"])}),
        "inverted_index": ({"app": "inverted_index", "input_dir": str(ctx["d0_dir"]),
                            "reduce_n": 8},
                           lambda files: ii_check(presence[:, :1])(
                               types.SimpleNamespace(output_files=files))),
        "grep": ({"app": "grep", "input_dir": str(ctx["d0_dir"]), "reduce_n": 8,
                  "app_args": {"query": list(GREP_QUERY)}},
                 lambda files: grep_check(presence[:, :1], GREP_RANKS, GREP_ABSENT)(
                     types.SimpleNamespace(output_files=files))),
    }
    svc = JobService(cfg)
    seen: dict = {}

    async def drive():
        serve = asyncio.create_task(svc.serve())
        await asyncio.sleep(0.2)
        client = CoordinatorClient(cfg.host, cfg.port, timeout_s=30.0)
        await client.connect()
        t0 = time.perf_counter()
        jids = {}
        for name, (spec, _check) in jobs.items():
            res = await client.call("submit_job", spec)
            check(res.get("ok") and res["state"] == "running",
                  f"service: {name} was not admitted at once: {res}")
            jids[name] = res["job"]
        workers = [asyncio.create_task(ServiceWorker(cfg, engine="device").run())
                   for _ in range(2)]
        deadline = time.perf_counter() + 600
        while True:
            states = {j["job"]: j["state"] for j in (await client.call("list_jobs"))["jobs"]}
            if all(states.get(jid) == "done" for jid in jids.values()):
                break
            bad = {jid: st for jid, st in states.items() if st in ("failed", "cancelled")}
            check(not bad, f"service: jobs ended {bad}")
            for w in workers:
                if w.done():
                    w.result()  # a worker that died raises its error here
                    check(False, "service: a worker exited before the jobs were done")
            check(time.perf_counter() < deadline, f"service: jobs not done in 600 s: {states}")
            await asyncio.sleep(0.25)
        seen["wall_s"] = time.perf_counter() - t0
        seen["launches"] = {"hash_scan": hash_scan.launches,
                            "tokenize_hash": tokenize_hash.launches}
        seen["status"] = {name: await client.call("job_status", jid)
                          for name, jid in jids.items()}
        before = (await client.call("list_jobs"))["service"]
        repeat = await client.call("submit_job", jobs["word_count"][0])
        seen["repeat"] = repeat
        seen["repeat_status"] = await client.call("job_status", repeat.get("job"))
        seen["after"] = (await client.call("list_jobs"))["service"]
        seen["before"] = before
        seen["launches_after_repeat"] = tokenize_hash.launches
        seen["jids"] = jids
        await client.call("shutdown")
        await client.close()
        await asyncio.wait_for(asyncio.gather(*workers), timeout=120)
        await asyncio.wait_for(serve, timeout=60)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hash_scan.launches = tokenize_hash.launches = 0
    asyncio.run(drive())
    peak = torch.cuda.max_memory_allocated()
    launches, jids = seen["launches"], seen["jids"]
    per_job = {}
    chunks = 0
    for name, (spec, check_files) in jobs.items():
        jid = jids[name]
        files = [str(out_dir / f"job-{jid}" / f"mr-{r}.txt") for r in range(spec["reduce_n"])]
        fields = check_files(files)
        totals = _job_totals(work_dir, jid)
        reexec = sum(t["re_executions"] for t in totals.values())
        check(reexec == 0, f"service: {name} re-executed {reexec} tasks without a fault")
        inputs = sorted(pathlib.Path(spec["input_dir"]).glob("*.txt"))
        check(totals["map"]["completed"] == len(inputs),
              f"service: {name} completed {totals['map']['completed']} map tasks")
        job_chunks = _map_chunks(inputs, cfg.chunk_bytes)
        chunks += job_chunks
        st = seen["status"][name]
        per_job[name] = {"job": jid, "exact": True, "queue_wait_s": st["queue_wait_s"],
                         "exec_s": st.get("run_s"), "map_tasks": len(inputs),
                         "chunks": job_chunks, "grants": seen["before"]["tenants"][jid]["grants"],
                         "totals": totals, **fields}
    check(launches["tokenize_hash"] == chunks > 0, f"service: tokenize_hash launched "
          f"{launches['tokenize_hash']} times for {chunks} map-task chunks")
    repeat, rst = seen["repeat"], seen["repeat_status"]
    check(repeat.get("ok") and repeat.get("cached") is True and repeat["state"] == "done",
          f"service: the repeated word_count was not served from the cache: {repeat}")
    grants_before = sum(t["grants"] for t in seen["before"]["tenants"].values())
    grants_after = sum(t["grants"] for t in seen["after"]["tenants"].values())
    check(grants_after == grants_before and rst.get("totals") is None
          and seen["after"]["tenants"][repeat["job"]]["grants"] == 0,
          f"service: the cached repeat was granted tasks ({grants_before} → {grants_after})")
    check(seen["launches_after_repeat"] == launches["tokenize_hash"],
          "service: the cached repeat launched the scan kernel")
    check(rst["outputs"] == sorted(str(out_dir / f"job-{jids['word_count']}" / f"mr-{r}.txt")
                                   for r in range(8)),
          f"service: the cache served other outputs: {rst.get('outputs')}")
    out = {"phase": "service", "exact": True, "map_engine": "device", "workers": 2,
           "max_jobs": cfg.service_max_jobs,
           "inflight_budget_mb": cfg.service_inflight_budget_mb, "wall_s": seen["wall_s"],
           "launches": launches, "chunks": chunks, "device_mem_peak_bytes": peak,
           "jobs": per_job, "repeat": {"job": repeat["job"], "cached": True,
                                       "new_grants": grants_after - grants_before},
           "cache": seen["after"]["cache"], "fleet_util": seen["after"]["fleet_util"]}
    emit(out)
    return out


def phase_service_drain(work: pathlib.Path, corpus: pathlib.Path, blobs: list[bytes]) -> dict:
    """The job service through the CLI in subprocesses: ``service
    --max-jobs 1``, two word_count jobs submitted (one queues), SIGTERM
    while the second is queued, two ``worker --service --engine device``:
    the service finishes the first job and exits 0; a restarted service
    and fleet complete the second from the service journal. Both exact
    against reference_word_counts; each worker that launched the kernel
    names the card in its manifest."""
    import signal

    import torch

    from mapreduce_rust_tpu_torch.config import Config
    from mapreduce_rust_tpu_torch.core.normalize import reference_word_counts

    want: dict = {}
    for blob in blobs:
        for w, c in reference_word_counts(blob).items():
            want[w.encode()] = want.get(w.encode(), 0) + c
    root = work / "drain"
    logs = root / "logs"
    logs.mkdir(parents=True)
    cli = [sys.executable, "-m", "mapreduce_rust_tpu_torch"]
    procs: dict = {}
    t0 = time.perf_counter()

    def common(port: int) -> list:
        return ["--input", str(corpus), "--output", str(root / "out"),
                "--work", str(root / "work"), "--port", str(port)]

    def start(name: str, cmd: list) -> None:
        with open(logs / f"{name}.log", "wb") as log:
            procs[name] = subprocess.Popen(cmd, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)

    def run(args: list, what: str) -> str:
        r = subprocess.run([*cli, *args], cwd=ROOT, capture_output=True, text=True,
                           timeout=120)
        check(r.returncode == 0, f"service-drain: {what} exited {r.returncode}:\n"
              f"{r.stdout[-2000:]}{r.stderr[-2000:]}")
        return r.stdout

    def jobs_view(port: int) -> dict:
        return json.loads(run(["jobs", "--port", str(port), "--json",
                               "--connect-retries", "50"], "jobs"))

    def wait_all(names, timeout: float) -> dict:
        rcs = {}
        for name in names:
            try:
                rcs[name] = procs[name].wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                rcs[name] = None
        return rcs

    def tails() -> str:
        return "".join(f"--- {p.name}:\n"
                       + p.read_bytes()[-2000:].decode(errors="replace")
                       for p in sorted(logs.glob("*.log")))

    def kill_all() -> None:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()

    try:
        port = _free_port()
        start("service-1", [*cli, "service", *common(port), "--max-jobs", "1"])
        submitted = [json.loads(run(["submit", *common(port), "--reduce-n", str(n),
                                     "--connect-retries", "50"], "submit").splitlines()[0])
                     for n in (4, 3)]
        j1, j2 = (r["job"] for r in submitted)
        states = {j["job"]: j["state"] for j in jobs_view(port)["jobs"]}
        check(states == {j1: "running", j2: "queued"}, f"service-drain: before SIGTERM {states}")
        procs["service-1"].send_signal(signal.SIGTERM)
        view = jobs_view(port)
        check(view["service"]["draining"] and view["service"]["queued"] == 1,
              f"service-drain: after SIGTERM {view['service']}")
        for i in range(2):
            start(f"worker-1{i}", [*cli, "worker", "--service", "--engine", "device",
                                   "--manifest", str(logs / "manifest-1.json"), *common(port)])
        rcs1 = wait_all(["service-1", "worker-10", "worker-11"], 600)
        check(rcs1 == {"service-1": 0, "worker-10": 0, "worker-11": 0},
              f"service-drain: first incarnation exited {rcs1}\n{tails()}")
        drained_s = time.perf_counter() - t0
        check(not (root / "out" / f"job-{j2}").exists(),
              "service-drain: the queued job ran during the drain")

        port = _free_port()
        start("service-2", [*cli, "service", *common(port)])
        for i in range(2):
            start(f"worker-2{i}", [*cli, "worker", "--service", "--engine", "device",
                                   "--manifest", str(logs / "manifest-2.json"), *common(port)])
        deadline = time.perf_counter() + 600
        while True:
            states = {j["job"]: j["state"] for j in jobs_view(port)["jobs"]}
            if states.get(j2) == "done":
                break
            check(states.get(j2) in ("queued", "running"), f"service-drain: {states}")
            check(time.perf_counter() < deadline, f"service-drain: {j2} not done: {states}")
            time.sleep(0.5)
        check(states.get(j1) == "done", f"service-drain: the restart lost {j1}: {states}")
        procs["service-2"].send_signal(signal.SIGTERM)
        rcs2 = wait_all(["service-2", "worker-20", "worker-21"], 120)
        check(rcs2 == {"service-2": 0, "worker-20": 0, "worker-21": 0},
              f"service-drain: second incarnation exited {rcs2}\n{tails()}")
    finally:
        kill_all()
    wall = time.perf_counter() - t0
    for jid in (j1, j2):
        got: dict = {}
        for path in sorted((root / "out" / f"job-{jid}").glob("mr-*.txt")):
            for line in path.read_bytes().splitlines():
                w, v = line.rsplit(b" ", 1)
                check(w not in got, f"service-drain: {jid} emitted {w!r} twice")
                got[w] = int(v)
        check(got == want, f"service-drain: {jid} differs from reference_word_counts "
              f"({len(got)} vs {len(want)} words)")
    journal = [json.loads(line)["op"] for line in
               (root / "work" / "service.journal").read_text().splitlines()]
    chunks = _map_chunks(sorted(corpus.glob("*.txt")), Config.chunk_bytes)
    incarnations = {}
    for inc in ("1", "2"):
        rows = []
        for i in range(2):
            m = json.loads((logs / f"manifest-{inc}-w{procs[f'worker-{inc}{i}'].pid}.json")
                           .read_text())
            n = m["kernel_launches"]["tokenize_hash"]
            if n:
                check(m["platform"].get("device_name") == torch.cuda.get_device_name(0),
                      f"service-drain: a worker's manifest names no card: {m['platform']}")
                check(m["device_mem_high_bytes"] > 0,
                      "service-drain: a worker launched the kernel but allocated nothing")
            rows.append({"tokenize_hash": n, "device": m["platform"].get("device_name"),
                         "device_mem_high_bytes": m["device_mem_high_bytes"]})
        launched = sum(r["tokenize_hash"] for r in rows)
        check(launched == chunks, f"service-drain: incarnation {inc}'s workers launched "
              f"tokenize_hash {launched} times for {chunks} map-task chunks")
        incarnations[inc] = rows
    out = {"phase": "service-drain", "exact": True, "map_engine": "device", "wall_s": wall,
           "first_incarnation_s": drained_s, "jobs": [j1, j2], "exit_codes": {**rcs1, **rcs2},
           "journal_ops": journal, "chunks_per_job": chunks,
           "launches": {"tokenize_hash": 2 * chunks}, "workers": incarnations,
           "totals": {jid: _job_totals(root / "work", jid) for jid in (j1, j2)}}
    emit(out)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs on a card",
              file=sys.stderr)
        return 2
    if not (ROOT / "mapreduce_rust_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: run it from the root of a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()

    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    phase_build()
    rows = phase_kernel()

    work = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-"))
    try:
        bench = phase_bench(work)
        bench_modes = phase_bench_modes(work)
        corpus = work / "zipf"
        corpus.mkdir()
        t0 = time.perf_counter()
        truth = write_zipf_corpus(corpus)
        emit({"phase": "corpus", "bytes": sum(p.stat().st_size for p in corpus.iterdir()),
              "files": ZIPF_FILES, "distinct_words": int((truth > 0).sum()),
              "tokens": int(truth.sum()), "vocab": ZIPF_VOCAB, "s": ZIPF_S,
              "seconds": time.perf_counter() - t0})
        text = work / "text"
        text.mkdir()
        blobs = write_text_corpus(text)
        phase_native(corpus, b"".join(blobs))
        main_run = drive_job("main", work, zipf_check(truth), corpus=corpus,
                             manifest_path=str(work / "main-manifest.json"))
        phase_step("step", corpus / "part-0.txt", main_run)
        prof_run = phase_prof(work, corpus, truth, main_run)
        drive_job("host", work, zipf_check(truth), corpus=corpus, map_engine="host")
        app_runs, ctx = phase_apps(work)
        # The eviction cells run on documents 0-1 of zipf-ii-256M (64 MiB,
        # 0.86 M distinct words against a 2^18 state) to leave the script
        # room for the mesh phases.
        evict = drive_job("evict", work, zipf_check(ctx["counts01"]), corpus=ctx["top_dir"],
                          merge_capacity=1 << 18)
        check(evict["spilled_keys"] > 0, "evict: no keys were evicted")
        host_evict = drive_job("host-evict", work, zipf_check(ctx["counts01"]),
                               corpus=ctx["top_dir"], map_engine="host",
                               merge_capacity=1 << 18, dispatch_coalesce=False,
                               dispatch_async=False)
        check(host_evict["spilled_keys"] > 0, "host-evict: no keys were evicted")
        prof_host_run = phase_prof_host(work, ctx["top_dir"], ctx["counts01"])
        phase_prof_cli(work, phase_calibrate(work))
        spill_runs = phase_spill(work, corpus, truth, ctx)
        mesh_runs = phase_mesh(work, corpus, truth, ctx)
        ckpt_run = phase_mesh_ckpt(work, ctx["d0_dir"], ctx["counts0"])
        mh_runs = phase_multihost(work, ctx)
        cluster_run = phase_cluster(work, ctx["top_dir"], ctx["counts01"])
        phase_cluster_kill(work, ctx["top_dir"], ctx["counts01"])
        phase_control_cli(work)
        service_run = phase_service(work, ctx)
        phase_fleet_cli(work)
        phase_cli(work, text, blobs)
        drain_run = phase_service_drain(work, text, blobs)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # The main path runs the fused entry; hash_scan is held and timed above
    # but no longer launched there.
    for row in rows:
        row["launches"] = main_run["launches"][row["name"]]
    check(main_run["launches"]["tokenize_hash"] > 0,
          "the main path never launched tokenize_hash")
    runs = [main_run, prof_run, evict, *app_runs, prof_host_run, *spill_runs, *mesh_runs]
    for run in app_runs + [prof_host_run] + spill_runs + mesh_runs:
        check((run["launches"]["tokenize_hash"] > 0) == (run["map_engine"] == "device"),
              f"{run['phase']}: tokenize_hash launches {run['launches']}")
    runs += [cluster_run, service_run]
    emit({"phase": "launches", "tokenize_hash": {
        run["phase"]: run["launches"]["tokenize_hash"] for run in runs
        if run["map_engine"] == "device"}, "chunks": {
        run["phase"]: run["chunks"] for run in runs if run["map_engine"] == "device"},
        "mesh_rounds": {run["phase"]: run["mesh_rounds"] for run in mesh_runs},
        "mesh-ckpt": {"tokenize_hash": ckpt_run["launches"]["tokenize_hash"],
                      "rounds": ckpt_run["resumed_rounds"],
                      "counted_in": "the resumed process's manifest"},
        **{run["phase"]: {"tokenize_hash": [r["launches"]["tokenize_hash"]
                                            for r in run["ranks"]],
                          "rounds": run["mesh_rounds"], "chunks": [r["chunks"]
                                                                   for r in run["ranks"]],
                          "counted_in": "each rank's manifest"} for run in mh_runs},
        "service-drain": {"tokenize_hash": drain_run["launches"]["tokenize_hash"],
                          "chunks": 2 * drain_run["chunks_per_job"],
                          "counted_in": "the workers' manifests"},
        "bench": {"tokenize_hash": bench["launches"], "chunks": bench["chunks"],
                  "counted_in": "each bench leg's process"},
        "bench-modes": {"fleets": bench_modes["launches"], "sweeps": {
            k: v["launches"] for k, v in bench_modes["sweeps"].items()},
            "counted_in": "each worker's manifest (= its one-chunk map tasks) and "
                          "each sweep leg's run manifest"}})
    print(f"total {time.perf_counter() - t_start:.1f}s", file=sys.stderr)
    print(nvidia_smi_line(), flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""``doctor``: automated run diagnosis over the telemetry the framework
already emits.

The port of ``mapreduce_rust_tpu/analysis/doctor.py``, whole: ``diagnose``
and its helpers, the live doctor the coordinator runs (``diagnose_live``,
``fold_live_findings``, ``deactivate_stale_findings``), the job service's
plane findings (``service_findings``), the streaming view
(``format_live``, ``run_live_cli``), trend analysis over a bench history
and the ``doctor`` CLI.

A run manifest (and optionally its job report and trace) goes in; a ranked
diagnosis comes out:

- **Bottleneck attribution** — the same scan/stall/glue/device split the
  manifest's ``bottleneck`` field encodes, extended with the two
  components JobStats.bottleneck cannot see: interconnect time
  (``all_to_all_s``) and XLA compile time. The primary name is computed
  with JobStats' exact formula, so doctor and manifest always agree on the
  legacy four; compile/ICI dominance is reported as a finding on top.
- **Percentiles** — the histogram blocks (host-map windows, a2a rounds,
  drains, RPC latencies, task attempts) rendered as p50/p95/p99/max.
- **Skew** — reduce-partition output bytes and mesh shard fill counts
  scored as max/mean; reduce-task duration imbalance from the job report.
- **Stragglers** — per-worker attempt-duration histograms (the ``wid``
  attribution satellite): a worker whose p50 exceeds the fleet median by
  ``straggler_factor`` is flagged.
- **Lease tuning** — observed task p99 vs the configured lease timeout.
- **Crash forensics** — incomplete attempt chains (granted, never
  finished) from the job report and from unterminated trace flow chains;
  a crashed run's partial telemetry yields a diagnosis, never a stack
  trace.
- **Regression gate** — ``--baseline`` compares watched metrics against a
  prior run's manifest with per-metric thresholds and exits non-zero, so
  CI can gate on it. The same watched table backs ``stats <a> <b>``'s
  new exit code.

Pure stdlib, no torch (analysis tools run in any process in
milliseconds).
"""

from __future__ import annotations

import json

from mapreduce_rust_tpu_torch.runtime.histogram import Histogram
# One flattener for both consumers of manifest paths: diff_manifests
# (stats CLI) and the regression gate here must agree on metric naming.
from mapreduce_rust_tpu_torch.runtime.telemetry import _flatten

DOCTOR_SCHEMA = 1

_SEV_RANK = {"error": 0, "warn": 1, "info": 2}

#: The regression gate's watched metrics: flattened manifest path →
#: (direction, relative threshold). "up" = an increase beyond the
#: threshold is a regression, "down" = a decrease is. Thresholds are
#: deliberately loose (these gate CI on real, noisy timings); scale them
#: with --threshold-scale.
WATCHED_METRICS: dict = {
    "stats.gb_per_s": ("down", 0.10),
    "stats.wall_seconds": ("up", 0.25),
    "stats.ingest_wait_s": ("up", 0.50),
    "stats.device_wait_s": ("up", 0.50),
    "stats.host_glue_s": ("up", 0.50),
    "stats.fold_stall_s": ("up", 0.50),
    "stats.spill_stall_s": ("up", 0.50),
    "stats.dispatch_stall_s": ("up", 0.50),
    "stats.scan_wait_s": ("up", 0.50),
    "stats.all_to_all_s": ("up", 0.50),
    "stats.compile.total_s": ("up", 1.00),
    "stats.partial_overflow_replays": ("up", 0.00),
    "stats.bucket_skew_replays": ("up", 0.00),
    "stats.spilled_keys": ("up", 1.00),
    "stats.histograms.host_map.scan_s.p95": ("up", 0.50),
    "stats.histograms.host_map.glue_s.p95": ("up", 0.50),
    "stats.histograms.host_map.fold_s.p95": ("up", 0.50),
    "stats.histograms.spill.write_s.p95": ("up", 0.50),
    "stats.histograms.dispatch.submit_s.p95": ("up", 0.50),
    "stats.histograms.a2a.round_s.p95": ("up", 0.50),
    "stats.histograms.device.drain_s.p95": ("up", 0.50),
}


def compare_manifests(baseline: dict, current: dict,
                      threshold_scale: float = 1.0) -> list[dict]:
    """Watched-metric regressions of ``current`` vs ``baseline`` — the
    ``--baseline`` CI gate's engine, shared with ``stats <a> <b>``.
    Returns one entry per tripped metric; [] = no regression. A metric
    absent from either side is skipped (older manifests predate the
    histogram fields); zero baselines gate on any increase for count
    metrics (threshold 0) and are skipped for ratio metrics."""
    fb, fc = _flatten(baseline), _flatten(current)
    regressions: list[dict] = []
    for metric, (direction, rel) in sorted(WATCHED_METRICS.items()):
        b, c = fb.get(metric), fc.get(metric)
        if not isinstance(b, (int, float)) or not isinstance(c, (int, float)) \
                or isinstance(b, bool) or isinstance(c, bool):
            continue
        threshold = rel * threshold_scale
        if b == 0:
            # No baseline signal to scale by: only the exact count metrics
            # (threshold 0: "any increase regresses") stay armed.
            if threshold == 0 and c > b:
                delta = float("inf")
            else:
                continue
        else:
            change = (c - b) / abs(b)
            worse = change > threshold if direction == "up" \
                else change < -threshold
            if not worse:
                continue
            delta = change
        regressions.append({
            "metric": metric,
            "baseline": b,
            "current": c,
            "change": None if delta == float("inf") else round(delta, 4),
            "direction": direction,
            "threshold": threshold,
        })
    return regressions


# ---------------------------------------------------------------------------
# Diagnosis
# ---------------------------------------------------------------------------

def _hist(d: "dict | None") -> "Histogram | None":
    if not d or not d.get("count"):
        return None
    return Histogram.from_dict(d)


def _skew_score(values: "list | None") -> "dict | None":
    vals = [v for v in (values or []) if isinstance(v, (int, float))]
    if len(vals) < 2 or sum(vals) <= 0:
        return None
    mean = sum(vals) / len(vals)
    return {
        "n": len(vals),
        "max": max(vals),
        "mean": round(mean, 3),
        # 1.0 = perfectly balanced; 2.0 = the hottest slot carries twice
        # its fair share.
        "score": round(max(vals) / mean, 3) if mean else None,
    }


def _bottleneck_attribution(stats: dict) -> dict:
    """JobStats.bottleneck's exact formula over the manifest's stats dict,
    extended with the ICI and compile components it cannot express."""
    workers = stats.get("host_map_workers") or 0
    scan = stats.get("host_map_s", 0.0) if workers <= 1 \
        else stats.get("scan_wait_s", 0.0)
    legacy = {
        "host-ingest": stats.get("ingest_wait_s", 0.0) or 0.0,
        "device": stats.get("device_wait_s", 0.0) or 0.0,
        "host-map": scan or 0.0,
        "host-glue": stats.get("host_glue_s", 0.0) or 0.0,
    }
    # Sharded fold: with S > 1 fold threads own the dictionary
    # fold, so "the fold is the ceiling" reads as router backpressure
    # (fold_stall_s), exactly mirroring JobStats.bottleneck. Live
    # fleet-aggregated stats carry no fold_shards field — there the mere
    # presence of fold stall arms the component.
    if (stats.get("fold_shards") or 0) > 1 or (
        "fold_shards" not in stats and (stats.get("fold_stall_s") or 0) > 0
    ):
        legacy["host-fold"] = stats.get("fold_stall_s", 0.0) or 0.0
    # Async spill plane: writes run off the hot threads, so the
    # disk component reads as owner-side writer backpressure — mirrors
    # JobStats.bottleneck's arm exactly. Live fleet aggregates carry the
    # fields only when a worker actually spilled, which is the same
    # engagement test.
    if (stats.get("spill_s") or 0) > 0 or (stats.get("spill_stall_s") or 0) > 0:
        legacy["spill"] = stats.get("spill_stall_s", 0.0) or 0.0
    # Async dispatch plane: the device hop runs off the router,
    # so "the dispatch is the ceiling" reads as router backpressure —
    # mirrors JobStats.bottleneck's arm exactly. Sync mode keeps the hop
    # in glue, so the arm stays off there. Live
    # fleet aggregates carry no dispatch_mode — the mere presence of
    # dispatch stall arms the component, the fold/spill pattern.
    mode = stats.get("dispatch_mode")
    if (isinstance(mode, str) and mode.startswith("async")) or (
        mode is None and (stats.get("dispatch_stall_s") or 0) > 0
    ):
        legacy["merge-dispatch"] = stats.get("dispatch_stall_s", 0.0) or 0.0
    name, val = max(legacy.items(), key=lambda kv: kv[1])
    primary = name if val > 0 else "balanced"
    extended = dict(legacy)
    extended["ici"] = stats.get("all_to_all_s", 0.0) or 0.0
    extended["compile"] = (stats.get("compile") or {}).get("total_s", 0.0)
    total = sum(extended.values())
    ranked = [
        {
            "component": comp,
            "seconds": round(secs, 6),
            "share": round(secs / total, 4) if total else None,
        }
        for comp, secs in sorted(
            extended.items(), key=lambda kv: kv[1], reverse=True
        )
    ]
    return {
        "name": primary,
        "recorded": stats.get("bottleneck"),
        "agrees_with_stats": (
            stats.get("bottleneck") is None or primary == stats.get("bottleneck")
        ),
        "attribution": ranked,
    }


def _flow_chains(events: list) -> dict:
    chains: dict = {}
    for e in events:
        if e.get("ph") in ("s", "t", "f"):
            chains.setdefault(e.get("id"), set()).add(e["ph"])
    return chains


def _load_trace_events(path: str) -> list:
    from mapreduce_rust_tpu_torch.runtime.trace import load_trace

    events, _md = load_trace(path)
    return events


def diagnose(manifest: dict, job_report: "dict | None" = None,
             trace_events: "list | None" = None,
             straggler_factor: float = 2.0) -> dict:
    """The diagnosis pass. ``manifest`` is a loaded run/coordinator/bench
    manifest (stats optional — a control-plane manifest diagnoses from its
    embedded job report); ``job_report`` overrides/augments the manifest's
    embedded report; ``trace_events`` enables flow-chain forensics.
    Total-function by design: partial telemetry from a crashed run yields
    a partial diagnosis plus findings, never an exception."""
    findings: list[dict] = []

    def find(severity: str, code: str, message: str,
             key: "str | None" = None) -> None:
        """``key`` is the finding's stable identity across re-evaluations
        (defaults to the code): the streaming doctor dedups on it, so a
        straggler's p50 drifting between ticks updates ONE finding with
        one first-seen timestamp instead of minting a new row per tick."""
        f = {"severity": severity, "code": code, "message": message}
        if key is not None:
            f["key"] = key
        findings.append(f)

    stats = manifest.get("stats") or {}
    report = job_report if job_report is not None \
        else manifest.get("job_report") or manifest.get("report")
    diag: dict = {"schema": DOCTOR_SCHEMA, "kind": manifest.get("kind")}

    if manifest.get("error"):
        find("error", "run-error",
             f"run recorded an error: {manifest['error']} — diagnosis is of "
             "the partial telemetry a crashed run left behind")

    # ---- bottleneck ----
    if stats:
        bn = _bottleneck_attribution(stats)
        diag["bottleneck"] = bn
        if not bn["agrees_with_stats"]:
            find("warn", "bottleneck-mismatch",
                 f"doctor attributes the run to {bn['name']!r} but the "
                 f"manifest recorded {bn['recorded']!r} — the manifest was "
                 "written by a different stats formula; trust the raw parts")
        top = bn["attribution"][0] if bn["attribution"] else None
        if top and top["component"] in ("ici", "compile") and top["seconds"] > 0:
            find("warn", f"{top['component']}-bound",
                 f"{top['component']} time ({top['seconds']:.3f}s) exceeds "
                 f"every host/device wait component — the legacy bottleneck "
                 f"field ({bn['name']!r}) cannot express this; "
                 + ("a persistent compilation cache or longer run amortizes it"
                    if top["component"] == "compile"
                    else "fewer/fatter all_to_all rounds would"))
        if bn["name"] == "spill":
            sp = stats.get("spill_split") or {}
            find("warn", "spill-bound",
                 f"spill-writer backpressure ({stats.get('spill_stall_s', 0):.3f}s "
                 "blocked on full writer queues) exceeds every other wait "
                 "component — the disk tier is the ceiling: raise "
                 "dictionary_budget_words / host_accum_budget_mb (fewer, "
                 "larger runs), add fold_shards (one spill writer per "
                 "shard), or move work_dir to faster storage"
                 + (f" [{sp.get('bytes', 0) / 1e6:.0f} MB over "
                    f"{sp.get('dict_runs', 0)}+{sp.get('accum_runs', 0)} "
                    "runs]" if sp else ""))
        if bn["name"] == "merge-dispatch":
            dp = stats.get("dispatch_split") or {}
            find("warn", "merge-dispatch-bound",
                 f"dispatch backpressure ({stats.get('dispatch_stall_s', 0):.3f}s "
                 "blocked on the full dispatch queue) exceeds every other "
                 "wait component — the per-merge device hop is the "
                 "ceiling: raise dispatch_fill_frac (more cross-window "
                 "coalescing per dispatch), raise host_update_cap (fewer, "
                 "fatter merges), or check the device link"
                 + (f" [{dp.get('dispatches', 0)} dispatches at mean fill "
                    f"{dp.get('fill_frac', 0):.2f}]" if dp else ""))
        dp = stats.get("dispatch_split") or {}
        if (
            dp.get("dispatches", 0) >= 8
            and (dp.get("fill_frac") or 0) < 0.10
            and (dp.get("dispatch_s") or 0) > 0.2
        ):
            # Raise-cap-vs-threshold guidance: mostly-empty
            # fixed-shape updates mean the 1+3·cap transfer is sentinel
            # padding and the per-dispatch fixed cost dominates.
            find("info", "dispatch-low-fill",
                 f"merge dispatches ran {dp.get('fill_frac', 0):.0%} full "
                 f"on average over {dp.get('dispatches')} dispatches — the "
                 "fixed-shape update is mostly sentinel padding: raise "
                 "dispatch_fill_frac (coalesce more windows per dispatch) "
                 "if latency allows, or lower host_update_cap so the "
                 "compiled merge shape matches the real update size "
                 "(one-time recompile, smaller transfers thereafter)")
        wall = stats.get("wall_seconds") or 0.0
        comp = stats.get("compile") or {}
        if comp and wall and comp.get("total_s", 0.0) > 0.5 * wall:
            find("warn", "compile-dominates",
                 f"XLA compiles took {comp['total_s']:.2f}s of a "
                 f"{wall:.2f}s run ({comp.get('cache_hits', 0)} cache hits, "
                 f"{comp.get('cache_misses', 0)} misses) — warm the "
                 "persistent cache or measure a longer run")

        # ---- roofline attribution ----
        # "The scan is slow" gets a headroom number: achieved GB/s vs the
        # calibrated machine roof for the host-map scan. Uses the cached
        # .bench/machine.json when one exists; otherwise a quick in-memory
        # memcpy probe (no file written — the doctor is read-only).
        if stats.get("host_map_split") and stats.get("bytes_in"):
            try:
                from mapreduce_rust_tpu_torch.analysis import roofline as _roofline

                machine = _roofline.load_machine() or _roofline.calibrate(
                    persist=False, size_mb=16)
                rl = _roofline.roofline_report(manifest, machine)
            except Exception:
                rl = None
            if rl and rl.get("roofline_frac"):
                diag["roofline"] = rl
                frac = rl["roofline_frac"]
                ach = rl["scan_achieved_gbs"]
                roof = rl["machine"]["host_memcpy_gbs"]
                proj = rl.get("device_map_projection_x")
                if frac >= 0.6:
                    find("warn", "bandwidth-bound",
                         f"host-map scan runs at {ach:.2f} GB/s = {frac:.0%} "
                         f"of the {roof:.2f} GB/s host memcpy roof — the "
                         "host wire is nearly saturated; no same-engine "
                         "tuning buys much, only the device-resident map "
                         "(ROADMAP item 2) takes these bytes off the host "
                         "path"
                         + (f" (projected ~{proj:g}× at half the device "
                            "roof)" if proj else ""))
                else:
                    find("info", "compute-headroom",
                         f"host-map scan achieves {ach:.2f} GB/s = {frac:.0%} "
                         f"of the {roof:.2f} GB/s host memcpy roof — the "
                         f"scan is compute-limited with ~{1.0 / frac:.1f}× "
                         "bandwidth headroom on this wire; a device-resident "
                         "map (ROADMAP item 2) is the lever"
                         + (f" (projected ~{proj:g}× at half the target "
                            "roof)" if proj else ""))

        # ---- lineage / incremental opportunity ----
        # A stamped blast-radius diff turns "rerun everything" into a
        # measured number: memo_hit_frac of bytes whose chunk digests are
        # unchanged — exactly the fraction a memoizing re-run (ROADMAP
        # item 4) would skip.
        lin = stats.get("lineage") or {}
        if lin.get("chunks"):
            diag["lineage"] = lin
            hit = lin.get("memo_hit_frac")
            if hit is not None:
                find("info", "incremental-opportunity",
                     f"provenance ledger covers {lin['chunks']} chunks "
                     f"({lin.get('bytes', 0)} bytes) and the stamped diff "
                     f"shows {hit:.1%} of input bytes unchanged since the "
                     f"baseline ({lin.get('changed_chunks', 0)} chunks "
                     "changed) — incremental re-execution (ROADMAP item 4) "
                     f"could memo-skip ~{hit:.0%} of the map work")
            else:
                find("info", "incremental-opportunity",
                     f"provenance ledger covers {lin['chunks']} chunks "
                     f"({lin.get('bytes', 0)} bytes); run `mapreduce_rust_tpu_torch "
                     "lineage diff <old> <new> --stamp` against a prior run "
                     "to measure the recompute blast radius incremental "
                     "re-execution (ROADMAP item 4) would avoid")

    # ---- percentiles ----
    hists = {
        name: h.summary(scale=1e3, digits=3)  # seconds → ms
        for name, hd in sorted((stats.get("histograms") or {}).items())
        if name.endswith("_s") and (h := _hist(hd)) is not None
    }
    for name, hd in sorted((stats.get("histograms") or {}).items()):
        if not name.endswith("_s") and (h := _hist(hd)) is not None:
            hists[name] = h.summary(scale=1.0, digits=1)
    if hists:
        diag["histograms_ms"] = hists
    if report and report.get("rpc"):
        diag["rpc_ms"] = {
            m: {k: r.get(k) for k in
                ("count", "p50_ms", "p95_ms", "p99_ms", "max_ms")}
            for m, r in sorted(report["rpc"].items())
        }

    # ---- skew ----
    skew = {}
    parts = _skew_score(stats.get("partition_bytes"))
    if parts is not None:
        skew["reduce_partition_bytes"] = parts
        if stats.get("partition_mode") == "range":
            # Range-partitioned run (sort): partition_bytes
            # measures SPLITTER quality, not hash mixing — the realized
            # per-partition bytes vs the ideal R-way split. The fix is
            # the sampler's knob, not reduce_n: more samples per file
            # flatten the quantile estimate on skewed corpora.
            if parts["score"] and parts["score"] > 1.5 and parts["n"] >= 2:
                n_samp = stats.get("splitter_samples") or 0
                find("warn", "splitter-quality",
                     f"hottest range partition holds {parts['score']:.1f}x "
                     f"its fair share of output bytes ({parts['max']} of "
                     f"ideal {parts['mean']:.0f}) — the {n_samp} sampled "
                     "keys under-resolved the key distribution; raise "
                     "--split-samples (Config.split_samples) so the "
                     "derived splitters track the real quantiles")
        elif parts["score"] and parts["score"] > 2.0 and parts["n"] >= 4:
            find("warn", "reduce-skew",
                 f"hottest reduce partition holds {parts['score']:.1f}x its "
                 f"fair share of output bytes ({parts['max']} of mean "
                 f"{parts['mean']:.0f}) — keys hash-route unevenly; raise "
                 "reduce_n or revisit the partition key")
    fold_split = stats.get("fold_split") or {}
    fsk = _skew_score(fold_split.get("per_shard_s"))
    if fsk is not None:
        skew["fold_shard_s"] = fsk
        if (
            fsk["score"] and fsk["score"] > 1.75
            and (fold_split.get("fold_s") or 0.0) > 0.2
        ):
            find("warn", "fold-shard-skew",
                 f"hottest fold shard spent {fsk['score']:.1f}x the mean "
                 f"fold time ({fsk['max']:.2f}s of mean {fsk['mean']:.2f}s "
                 f"across {fold_split.get('shards')} shards) — the key-hash "
                 "load is imbalanced, so one fold thread carries the egress "
                 "fold serially; more fold_shards won't help until the hot "
                 "keys spread (check for a dominant window or a skewed "
                 "vocabulary)")
    shards = _skew_score(stats.get("mesh_shard_rows"))
    if shards is not None:
        skew["mesh_shard_rows"] = shards
        if shards["score"] and shards["score"] > 2.0:
            find("warn", "shard-skew",
                 f"hottest mesh shard holds {shards['score']:.1f}x the mean "
                 "distinct-key load — one chip's merge/egress carries the "
                 "job (hash-class imbalance)")
    if report:
        durs = [
            t.get("duration_s")
            for t in (report.get("tasks") or {}).get("reduce", {}).values()
            if t.get("duration_s")
        ]
        rd = _skew_score(durs)
        if rd is not None:
            skew["reduce_task_duration_s"] = rd
            if rd["score"] and rd["score"] > 2.0 and rd["n"] >= 3:
                find("warn", "reduce-duration-skew",
                     f"slowest reduce task ran {rd['score']:.1f}x the mean "
                     "duration — partition skew or a straggling worker")
    if skew:
        diag["skew"] = skew

    # ---- stragglers ----
    if report and report.get("workers"):
        per_worker = {}
        p50s = {}
        for wid, w in report["workers"].items():
            h = _hist(w.get("task_s"))
            per_worker[wid] = {
                "reports": w.get("reports", 0),
                "grants": w.get("grants", 0),
                "task_p50_s": h.percentile(0.5) if h else None,
                "task_p99_s": h.percentile(0.99) if h else None,
            }
            if h is not None:
                p50s[wid] = h.percentile(0.5)
        flagged = []
        if len(p50s) >= 2:
            # LOWER median: with two workers the reference must be the
            # faster one, or the slow worker would be its own yardstick
            # and a 2-fleet straggler could never be flagged.
            med = sorted(p50s.values())[(len(p50s) - 1) // 2]
            if med > 0:
                flagged = sorted(
                    wid for wid, p in p50s.items()
                    if p > straggler_factor * med
                )
        diag["stragglers"] = {
            "factor": straggler_factor,
            "workers": per_worker,
            "flagged": flagged,
        }
        for wid in flagged:
            find("warn", "straggler",
                 f"worker {wid}: task p50 {p50s[wid]:.3f}s exceeds "
                 f"{straggler_factor:.1f}x the fleet median — a slow host, "
                 "an oversubscribed core, or skewed inputs",
                 key=f"straggler:w{wid}")

    # ---- speculation effectiveness ----
    if report:
        spec_tot = {"attempts": 0, "won": 0, "wasted": 0, "time_saved_s": 0.0}
        for tot in (report.get("totals") or {}).values():
            s = tot.get("speculation")
            if s:
                for k in spec_tot:
                    spec_tot[k] += s.get(k, 0) or 0
        if spec_tot["attempts"]:
            spec_tot["time_saved_s"] = round(spec_tot["time_saved_s"], 4)
            diag["speculation"] = spec_tot
            find("info", "speculation-effectiveness",
                 f"{spec_tot['won']} of {spec_tot['attempts']} speculative "
                 f"attempt(s) won the race ({spec_tot['wasted']} wasted), "
                 f"~{spec_tot['time_saved_s']:.2f}s saved vs lease-expiry-"
                 "only recovery")
            if spec_tot["attempts"] >= 3 and spec_tot["won"] == 0:
                find("warn", "speculation-wasteful",
                     f"all {spec_tot['attempts']} speculative attempts lost "
                     "their race — the originals finish first; raise "
                     "--speculate-after-frac or the slow factor so only "
                     "genuine stragglers get duplicated")

    # ---- lease tuning ----
    lease_s = (manifest.get("config") or {}).get("lease_timeout_s")
    if report and lease_s:
        p99s = [
            h.percentile(0.99)
            for tot in (report.get("totals") or {}).values()
            if (h := _hist(tot.get("task_s"))) is not None
        ]
        expiries = sum(
            tot.get("expiries", 0)
            for tot in (report.get("totals") or {}).values()
        )
        if p99s:
            p99 = max(p99s)
            advice = None
            if p99 >= 0.8 * lease_s:
                advice = (
                    f"task p99 ({p99:.2f}s) crowds the {lease_s:.1f}s lease "
                    "timeout — healthy tasks risk expiry; raise "
                    "--lease-timeout or shrink tasks"
                )
                find("warn" if expiries else "info", "lease-tight", advice)
            elif lease_s > 20 * p99:
                advice = (
                    f"lease timeout ({lease_s:.1f}s) is {lease_s / p99:.0f}x "
                    f"the task p99 ({p99:.2f}s) — a dead worker blocks its "
                    "task that long; a lower --lease-timeout recovers faster"
                )
                find("info", "lease-loose", advice)
            diag["lease"] = {
                "timeout_s": lease_s,
                "task_p99_s": round(p99, 4),
                "expiries": expiries,
                "advice": advice,
            }

    # ---- compile / device memory ----
    comp = stats.get("compile")
    if comp:
        diag["compile"] = comp
    if stats.get("device_mem_high_bytes"):
        diag["device_memory"] = {
            "high_water_bytes": stats["device_mem_high_bytes"]
        }

    # ---- crash forensics: incomplete attempt chains ----
    incomplete_tasks = []
    if report:
        for phase, tasks in (report.get("tasks") or {}).items():
            for tid, t in tasks.items():
                if t.get("grants", 0) > 0 and not t.get("completed"):
                    incomplete_tasks.append(f"{phase}:{tid}")
        expiries = sum(
            tot.get("expiries", 0)
            for tot in (report.get("totals") or {}).values()
        )
        reexecs = sum(
            tot.get("re_executions", 0)
            for tot in (report.get("totals") or {}).values()
        )
        if expiries or reexecs:
            find("info", "re-execution",
                 f"{expiries} lease expirie(s), {reexecs} re-execution(s) — "
                 "a worker died or stalled mid-task; the timeline's forked "
                 "attempt chains name which")
    incomplete_flows = []
    if trace_events:
        chains = _flow_chains(trace_events)
        incomplete_flows = sorted(
            fid for fid, phs in chains.items() if fid and "f" not in phs
        )
    if incomplete_tasks or incomplete_flows:
        diag["incomplete"] = {
            "tasks": sorted(incomplete_tasks),
            "flows": incomplete_flows,
        }
        for label, items in (("task", incomplete_tasks),
                             ("attempt chain", incomplete_flows)):
            if items:
                find("error" if label == "task" else "warn",
                     "incomplete-" + ("task" if label == "task" else "chain"),
                     f"{len(items)} {label}(s) started but never finished "
                     f"({', '.join(items[:6])}"
                     + (", …" if len(items) > 6 else "") + ") — a crashed "
                     "or SIGKILLed attempt; the flight-recorder partial "
                     "holds its last events")

    if not stats and not report:
        find("error", "no-telemetry",
             "manifest carries neither stats nor a job report — nothing to "
             "diagnose (was this a bench-harness or sweep manifest?)")

    findings.sort(key=lambda f: _SEV_RANK.get(f["severity"], 9))
    diag["findings"] = findings
    return diag


# ---------------------------------------------------------------------------
# Streaming doctor: the same finding catalog, evaluated against
# a RUNNING job's live telemetry instead of its corpse.
# ---------------------------------------------------------------------------

#: Finding codes that only make sense post-mortem: mid-run, every
#: in-flight task is "granted but not completed" by construction and
#: every open flow chain is unterminated — those are a live job's normal
#: state, not a diagnosis.
_POST_MORTEM_CODES = frozenset({
    "incomplete-task", "incomplete-chain", "no-telemetry", "run-error",
})

#: Renewal-envelope series that sum fleet-wide into the wait-split fields
#: _bottleneck_attribution understands (worker series are prefixed;
#: strip to the JobStats field name).
_WAIT_FIELDS = ("ingest_wait_s", "device_wait_s", "host_map_s",
                "host_glue_s", "fold_s", "fold_stall_s", "spill_s",
                "spill_stall_s", "dispatch_s", "dispatch_stall_s",
                "scan_wait_s", "all_to_all_s")


def diagnose_live(stats_rpc: dict, lease_timeout_s: "float | None" = None,
                  straggler_factor: float = 2.0,
                  fleet: "dict | None" = None) -> dict:
    """One streaming-doctor evaluation over a coordinator ``stats`` RPC
    response (which IS a job-report dict plus ``progress``) and the
    fleet's latest renewal-envelope samples. Reuses :func:`diagnose` —
    the catalog is shared, not forked — then drops the post-mortem-only
    codes and adds the live host-glue/stall bottleneck attribution when
    the fleet samples carry wait-split series. Pure function: the
    coordinator's tick and ``doctor --live`` both call it."""
    manifest: dict = {"kind": "live"}
    if lease_timeout_s:
        manifest["config"] = {"lease_timeout_s": lease_timeout_s}
    agg: dict = {}
    for s in (fleet or {}).values():
        for k, v in (s.get("v") or {}).items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            for field in _WAIT_FIELDS:
                if str(k).endswith(field):
                    agg[field] = agg.get(field, 0.0) + v
    if any(agg.values()):
        manifest["stats"] = agg
    diag = diagnose(manifest, job_report=stats_rpc,
                    straggler_factor=straggler_factor)
    diag["kind"] = "live"
    findings = [
        f for f in diag["findings"] if f["code"] not in _POST_MORTEM_CODES
    ]
    bn = diag.get("bottleneck")
    if bn and bn.get("name") not in (None, "balanced"):
        top = (bn.get("attribution") or [{}])[0]
        findings.append({
            "severity": "info", "code": "live-bottleneck",
            "key": "live-bottleneck",
            "message": (
                f"fleet-aggregated wait split currently names "
                f"{bn['name']!r} ({top.get('seconds', 0):.3f}s, "
                f"{(top.get('share') or 0):.0%} of attributed time)"
            ),
        })
    diag["findings"] = findings
    return diag


def fold_live_findings(registry: dict, findings: list, now: float,
                       prefix: str = "", on_new=None) -> set:
    """Fold one tick's findings into a live-findings registry (key →
    finding with first/last-seen stamps + active flag) — the streaming
    doctor's dedup, shared by the Coordinator's tick and the
    JobService's (which prefixes per-job keys). ``on_new(key, finding)``
    fires exactly once per key's first appearance (the callers' log +
    trace-instant hook). Returns the keys seen THIS tick; after folding
    every source, pass their union to :func:`deactivate_stale_findings`
    — a finding kept with its first_seen is history, not a gauge: a
    straggler that recovered still happened."""
    current: set = set()
    for f in findings or []:
        key = prefix + (f.get("key") or f["code"])
        current.add(key)
        known = registry.get(key)
        if known is None:
            registry[key] = {
                **f, "key": key,
                "first_seen_s": now, "last_seen_s": now, "active": True,
            }
            if on_new is not None:
                on_new(key, f)
        else:
            known.update({
                "message": f["message"], "severity": f["severity"],
                "last_seen_s": now, "active": True,
            })
    return current


def deactivate_stale_findings(registry: dict, current: set) -> None:
    for key, f in registry.items():
        if key not in current:
            f["active"] = False


def service_findings(service: "dict | None") -> list:
    """Live findings of the multi-tenant service plane over a
    JobService ``service_summary()`` dict — evaluated by the service's
    doctor tick beside the per-job diagnose_live passes. The headline
    finding is ``service-saturated``: the admission budget is holding
    queued jobs back while jobs already run — by design (backpressure,
    not a fault), but an operator watching the queue back up needs the
    doctor to say WHY and which knob to turn."""
    if not isinstance(service, dict):
        return []
    findings: list[dict] = []
    queued = service.get("queued") or 0
    if queued and service.get("admission_blocked"):
        inflight = service.get("inflight_bytes") or 0
        budget = service.get("budget_bytes") or 0
        findings.append({
            "severity": "warn", "code": "service-saturated",
            "key": "service-saturated",
            "message": (
                # MiB, matching the service_inflight_budget_mb knob's
                # unit (budget_bytes = mb << 20) — an operator must be
                # able to copy the displayed number back into the flag.
                f"admission blocked: {inflight / (1 << 20):.1f} MB in "
                f"flight of a {budget / (1 << 20):.1f} MB budget with "
                f"{queued} job(s) queued "
                f"({service.get('running', 0)} running) — backpressure is "
                "working; raise service_inflight_budget_mb / "
                "service_max_jobs or add workers to drain faster"
            ),
        })
    elif queued and (service.get("running") or 0) \
            >= (service.get("max_jobs") or 1):
        findings.append({
            "severity": "info", "code": "service-queue",
            "key": "service-queue",
            "message": (
                f"{queued} job(s) queued behind the "
                f"service_max_jobs={service.get('max_jobs')} concurrency "
                "cap"
            ),
        })
    # ---- fleet profiler plane ----
    fl = service.get("fleet_util")
    if isinstance(fl, dict) and (fl.get("active_ws") or 0) >= 5.0:
        # ≥ 5 fleet worker-seconds observed: below that a single poll gap
        # reads as a 100% bubble. Thresholds are deliberately coarse —
        # these are operator prompts, not SLO breaches.
        bubble = fl.get("bubble_frac") or 0.0
        # Quiet on pipelined runs: the scheduler already
        # grants reduce per partition and fills barriers with other
        # jobs' map windows — the opportunity the advice names is
        # realized, and residual bubble is queue pressure the
        # service-saturated/service-queue findings already cover.
        if bubble > 0.25 and service.get("sched") != "pipeline":
            findings.append({
                "severity": "warn", "code": "barrier-bubble",
                "key": "barrier-bubble",
                "message": (
                    f"{bubble:.0%} of fleet worker-seconds idle while "
                    "reduce work was barrier-blocked or jobs sat queued "
                    f"({fl.get('bubble_ws', 0):.1f} worker-s) — rerun "
                    "the service and its workers with `--sched pipeline` "
                    "to release reduce per partition and fill barrier "
                    "bubbles with other jobs' map windows; see "
                    "`fleet <work-root>` for the per-job breakdown"
                ),
            })
        utils = [
            w.get("util_frac") for w in (fl.get("workers") or {}).values()
            if isinstance(w, dict) and not w.get("drained")
            and isinstance(w.get("util_frac"), (int, float))
        ]
        if len(utils) >= 2 and max(utils) > 0.2:
            mean = sum(utils) / len(utils)
            if mean > 0 and max(utils) / mean > 2.0:
                findings.append({
                    "severity": "warn", "code": "fleet-imbalance",
                    "key": "fleet-imbalance",
                    "message": (
                        f"worker utilization is imbalanced: max "
                        f"{max(utils):.0%} vs fleet mean {mean:.0%} — "
                        "admission-order granting is starving part of "
                        "the fleet (long map tasks on one worker, or a "
                        "worker polling a barrier-gated job)"
                    ),
                })
    slo = service.get("slo")
    if isinstance(slo, dict):
        lo = _hist((slo.get("low") or {}).get("queue_wait_s"))
        hi = _hist((slo.get("high") or {}).get("queue_wait_s"))
        if lo is not None and hi is not None:
            lo95 = lo.percentile(0.95) or 0.0
            hi95 = hi.percentile(0.95) or 0.0
            if lo95 > 1.0 and lo95 > 4.0 * max(hi95, 0.05):
                findings.append({
                    "severity": "warn", "code": "admission-starvation",
                    "key": "admission-starvation",
                    "message": (
                        f"low-priority queue-wait p95 {lo95:.2f}s vs "
                        f"high-priority {hi95:.2f}s — strict-priority "
                        "admission is starving the low class; consider "
                        "aging or a budget carve-out"
                    ),
                })
    return findings


def format_live(metrics_rpc: dict, stats_rpc: "dict | None" = None) -> str:
    """Plain-text view of the coordinator ``metrics`` RPC — the streaming
    findings (first-seen stamps, live/cleared state) and the fleet's
    freshest samples. ``watch --doctor`` appends this under the progress
    view; ``doctor --live`` prints it on its own."""
    lines: list[str] = []
    findings = metrics_rpc.get("findings") or []
    if findings:
        lines.append(f"  doctor[live]: {len(findings)} finding(s)")
        for f in findings:
            state = "live" if f.get("active", True) else "cleared"
            lines.append(
                f"    [{f['severity'].upper():<5}] {f['code']}"
                f" (first seen {f.get('first_seen_s', 0):.1f}s, {state}): "
                f"{f['message']}"
            )
    else:
        lines.append("  doctor[live]: no findings yet")
    fleet = metrics_rpc.get("fleet") or {}
    for wid, s in sorted(fleet.items(), key=lambda kv: str(kv[0])):
        v = s.get("v") or {}
        parts = [
            f"{k.split('.', 1)[-1]}={v[k]:g}" for k in sorted(v)
            if isinstance(v[k], (int, float)) and not isinstance(v[k], bool)
        ]
        lines.append(
            f"    w{wid} sample ({s.get('age_s', 0):.1f}s old): "
            + (" ".join(parts[:8]) or "empty")
        )
    return "\n".join(lines)


def run_live_cli(args) -> int:
    """``doctor --live HOST:PORT``: poll the coordinator's stats+metrics
    RPCs and stream findings as they appear, until the job completes (or
    --once). Exit 0 on a completed/observed job, 1 when no coordinator
    answers. Backend-free like every analysis tool."""
    import asyncio

    from mapreduce_rust_tpu_torch.coordinator.server import (
        CoordinatorClient,
        RpcTimeout,
    )

    addr = args.live
    host, _, port_s = addr.rpartition(":")
    host = host or "127.0.0.1"
    try:
        port = int(port_s)
    except ValueError:
        print(f"doctor --live: bad address {addr!r} (want HOST:PORT)")
        return 2
    interval = getattr(args, "interval", None) or 1.0
    once = bool(getattr(args, "once", False))
    # ``--job <id>``: against a JobService, stream ONE job's
    # view — its stats come from the job_status RPC and the service's
    # findings are filtered to that job's key prefix.
    job = getattr(args, "job", None)

    async def go() -> int:
        client = CoordinatorClient(host, port,
                                   timeout_s=max(interval * 5, 3.0))
        try:
            await client.connect(retries=5, delay=0.2)
        except (OSError, RpcTimeout) as e:
            print(f"doctor --live: no coordinator at {host}:{port} ({e})")
            return 1
        seen: set = set()
        try:
            while True:
                try:
                    rep = await client.call("job_status", job) if job \
                        else await client.call("stats")
                    live = await client.call("metrics")
                except RpcTimeout as e:
                    print(f"doctor --live: coordinator not answering ({e})")
                    return 1
                except (ConnectionError, RuntimeError) as e:
                    # Gone = job finished; RuntimeError = pre-metrics
                    # coordinator (unknown method) — say which.
                    if isinstance(e, RuntimeError) and "unknown method" in str(e):
                        print("doctor --live: coordinator predates the "
                              "metrics RPC — upgrade it or use post-run "
                              "`doctor <manifest>`")
                        return 2
                    print("doctor --live: coordinator gone — job finished")
                    return 0
                if job and isinstance(rep, dict) and rep.get("ok") is False:
                    print(f"doctor --live: {rep.get('error')}")
                    return 2
                if job:
                    # Per-job filter: the service prefixes per-job finding
                    # keys with "<jid>:" (service-plane findings like
                    # service-saturated stay visible — they affect every
                    # job).
                    live = dict(live)
                    live["findings"] = [
                        f for f in live.get("findings") or []
                        if f.get("job") == job
                        or str(f.get("key", "")).startswith(f"{job}:")
                        or str(f.get("code", "")).startswith("service-")
                    ]
                if getattr(args, "format", "text") == "json":
                    print(json.dumps({"stats": rep, "metrics": live},
                                     sort_keys=True), flush=True)
                else:
                    for f in live.get("findings") or []:
                        key = f.get("key") or f.get("code")
                        if key not in seen:
                            seen.add(key)
                            print(
                                f"[{f.get('first_seen_s', 0):>7.1f}s] "
                                f"[{f['severity'].upper():<5}] "
                                f"{f['code']}: {f['message']}", flush=True,
                            )
                done = rep.get("state") in ("done", "cancelled", "failed") \
                    if job else (rep.get("progress") or {}).get("done")
                if once or done:
                    if getattr(args, "format", "text") == "text":
                        print(format_live(live, rep))
                        if done:
                            print("doctor --live: job complete")
                    return 0
                await asyncio.sleep(interval)
        finally:
            await client.close()

    return asyncio.run(go())


# ---------------------------------------------------------------------------
# Trend: N-round drift detection over .bench/history.jsonl
# ---------------------------------------------------------------------------

#: History-line series the trend gate watches: field → the direction that
#: is BAD ("down": a decline regresses — these are GB/s-class metrics).
TREND_SERIES: dict[str, str] = {
    "value": "down",
    "zipf_gbs": "down",
    # Live-metrics sampler tax: bench measures a metrics-on vs
    # metrics-off pair each run; a creeping overhead fraction is exactly
    # the slow-boil regression class trend exists for.
    "metrics_overhead_frac": "up",
    # Dispatch-plane coalescing effectiveness: mean update
    # fill drifting DOWN means dispatches go out emptier round over round
    # — the coalesce factor eroding (a vocabulary shift, a threshold
    # regression) long before the wall number moves.
    "merge_fill_frac": "down",
    # Job-service throughput: the bench service leg's
    # jobs-per-minute over a fixed mixed-submission stream. Drifting DOWN
    # means the control plane itself (admission, dispatch, per-job
    # bookkeeping) got slower — the regression class a single-job wall
    # number can never see.
    "service_jobs_per_min": "down",
    # Workload plane: the bench sort leg's wall and its
    # realized partition-bytes skew ratio. Wall drifting UP is the
    # range-partitioned path slowing; skew drifting UP is the sampled
    # splitters degrading (sampler regression, corpus-generator drift) —
    # each invisible to the hash legs.
    "sort_wall_s": "up",
    "sort_skew": "up",
    # Fleet profiler: the bench service leg's cross-job
    # accounting. Bubble fraction drifting UP means more fleet
    # worker-seconds lost to the map barrier / admission queue; util
    # drifting DOWN is the same loss seen from the other side; the
    # pipelining opportunity drifting UP means the barrier is leaving
    # ever more reclaimable headroom on the table (ROADMAP item 1's
    # before/after number).
    "fleet_bubble_frac": "up",
    "fleet_util_frac": "down",
    "pipelining_opportunity_s": "up",
    # Model checker: mrmodel exploration throughput over the
    # fixed bench budget. Drifting DOWN means the real control plane (or
    # the invariant replay it runs per schedule) got slower — and since
    # CI explores under a fixed time box, a slower loop silently shrinks
    # the schedule space actually covered.
    "model_schedules_per_s": "down",
    # Roofline attribution: the zipf leg's host-map scan
    # achieved GB/s and its fraction of the calibrated memcpy roof.
    # Either drifting DOWN means the scan is moving AWAY from the
    # hardware — a native-scan regression or a machine/calibration shift
    # — exactly the efficiency erosion a wall-seconds series hides when
    # corpus size drifts with it.
    "scan_achieved_gbs": "down",
    "roofline_frac": "down",
    # Sampler tax: the --profile-overhead interleaved pair's
    # min-of-N estimate; creeping UP is the profiler outgrowing its ≤2%
    # budget (the metrics_overhead_frac twin).
    "profile_overhead_frac": "up",
    # Provenance plane: the --lineage-overhead pair's ledger
    # tax creeping UP is the digest/ledger path outgrowing its ≤2%
    # budget; the blast-radius leg's memo_hit_frac drifting DOWN on the
    # fixed +1% grown corpus means chunking stability eroded — a window
    # boundary shift silently shrinking what incremental re-execution
    # (ROADMAP item 4) could ever skip.
    "lineage_overhead_frac": "up",
    "lineage_memo_hit_frac": "down",
}


def _least_squares_slope(ys: list) -> float:
    """Slope of y over index 0..n-1 (ordinary least squares)."""
    n = len(ys)
    xbar = (n - 1) / 2.0
    ybar = sum(ys) / n
    num = sum((i - xbar) * (y - ybar) for i, y in enumerate(ys))
    den = sum((i - xbar) ** 2 for i in range(n))
    return num / den if den else 0.0


def analyze_trend(lines: list, window: int = 8,
                  drift_threshold: float = 0.10,
                  min_points: int = 4) -> dict:
    """Sustained-drift detection the pairwise ``--baseline`` gate misses:
    a metric that loses 3% every round never trips a 10% pair threshold
    but is down 27% after nine rounds. Over the last ``window`` points of
    each watched series: the least-squares slope (normalized to relative
    drift across the window) AND last-vs-median must both point the bad
    way beyond threshold — slope alone would flag an old, recovered dip;
    last-vs-median alone would flag a single noisy round."""
    series: dict[str, list] = {k: [] for k in TREND_SERIES}
    for ln in lines:
        if not isinstance(ln, dict):
            continue
        for key in TREND_SERIES:
            v = ln.get(key)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                series[key].append(float(v))
    out: dict = {
        "schema": DOCTOR_SCHEMA,
        "kind": "doctor_trend",
        "window": window,
        "threshold": drift_threshold,
        "rounds_seen": len(lines),
        "series": {},
        "drifts": [],
    }
    for key, ys in series.items():
        if len(ys) < min_points:
            out["series"][key] = {"points": len(ys), "status": "insufficient"}
            continue
        win = ys[-window:]
        med = sorted(win)[(len(win) - 1) // 2]
        slope = _least_squares_slope(win)
        scale = abs(med) or 1.0
        rel_drift = slope * (len(win) - 1) / scale  # over the whole window
        last_vs_median = (win[-1] - med) / scale
        bad = TREND_SERIES[key]
        sign = -1.0 if bad == "down" else 1.0
        drifting = (
            sign * rel_drift > drift_threshold
            and sign * last_vs_median > drift_threshold / 2
        )
        entry = {
            "points": len(win),
            "median": round(med, 6),
            "last": round(win[-1], 6),
            "slope_per_round": round(slope, 6),
            "rel_drift_over_window": round(rel_drift, 4),
            "last_vs_median": round(last_vs_median, 4),
            "bad_direction": bad,
            "status": "drifting" if drifting else "stable",
        }
        out["series"][key] = entry
        if drifting:
            out["drifts"].append({"metric": key, **entry})
    return out


def format_trend(t: dict) -> str:
    lines = [
        f"doctor trend — {t['rounds_seen']} round(s), window {t['window']}, "
        f"threshold {t['threshold']:.0%}"
    ]
    for key, s in sorted((t.get("series") or {}).items()):
        if s.get("status") == "insufficient":
            lines.append(f"  {key:<12} {s['points']} point(s) — insufficient "
                         "data (need more rounds)")
            continue
        lines.append(
            f"  {key:<12} [{s['status'].upper():<8}] last={s['last']:g} "
            f"median={s['median']:g} drift/window={s['rel_drift_over_window']:+.1%} "
            f"last-vs-median={s['last_vs_median']:+.1%}"
        )
    if t.get("drifts"):
        lines.append(f"  SUSTAINED DRIFT in {len(t['drifts'])} metric(s) — "
                     "the pairwise gate would have missed this")
    else:
        lines.append("  no sustained drift")
    return "\n".join(lines)


def run_trend_cli(args) -> int:
    """``doctor trend [history.jsonl]``: exit 0 = stable/insufficient,
    1 = sustained drift (the CI gate), 2 = unreadable history."""
    path = getattr(args, "history", None) or ".bench/history.jsonl"
    try:
        with open(path) as f:
            raw = f.read()
    except OSError as e:
        print(f"doctor trend: cannot read history {path!r}: {e}")
        return 2
    lines = []
    for ln in raw.splitlines():
        ln = ln.strip()
        if not ln:
            continue
        try:
            lines.append(json.loads(ln))
        except json.JSONDecodeError:
            continue  # a torn append must not invalidate the whole history
    t = analyze_trend(
        lines,
        window=getattr(args, "window", 8) or 8,
        drift_threshold=getattr(args, "drift_threshold", 0.10) or 0.10,
    )
    if getattr(args, "format", "text") == "json":
        print(json.dumps(t, indent=2, sort_keys=True))
    else:
        print(format_trend(t))
    return 1 if t["drifts"] else 0


# ---------------------------------------------------------------------------
# Rendering + CLI
# ---------------------------------------------------------------------------

def format_diagnosis(diag: dict, regressions: "list | None" = None) -> str:
    lines = [f"doctor diagnosis (schema {diag.get('schema')})"]
    bn = diag.get("bottleneck")
    if bn:
        agree = "" if bn.get("agrees_with_stats") else \
            f"  [manifest recorded {bn.get('recorded')!r}]"
        lines.append(f"  bottleneck: {bn['name']}{agree}")
        for a in bn.get("attribution") or []:
            share = f" ({a['share']:.0%})" if a.get("share") is not None else ""
            lines.append(
                f"    {a['component']:<12} {a['seconds']:9.3f}s{share}"
            )
    for name, h in sorted((diag.get("histograms_ms") or {}).items()):
        if not h.get("count"):
            continue
        unit = "ms" if name.endswith("_s") else ""
        lines.append(
            f"  hist {name:<20} n={h['count']:<6} p50={h['p50']:g} "
            f"p95={h['p95']:g} p99={h['p99']:g} max={h['max']:g} {unit}"
        )
    for m, r in sorted((diag.get("rpc_ms") or {}).items()):
        lines.append(
            f"  rpc  {m:<24} n={r.get('count', 0):<6} "
            f"p50={r.get('p50_ms', 0)}ms p99={r.get('p99_ms', 0)}ms "
            f"max={r.get('max_ms', 0)}ms"
        )
    for key, s in sorted((diag.get("skew") or {}).items()):
        lines.append(
            f"  skew {key}: score {s.get('score')} "
            f"(max {s.get('max')} / mean {s.get('mean')}, n={s.get('n')})"
        )
    spec = diag.get("speculation")
    if spec:
        lines.append(
            f"  speculation: {spec['won']} won / {spec['wasted']} wasted of "
            f"{spec['attempts']} attempts (~{spec['time_saved_s']}s saved)"
        )
    st = diag.get("stragglers")
    if st:
        flagged = st.get("flagged") or []
        lines.append(
            f"  stragglers: {len(flagged)} flagged of "
            f"{len(st.get('workers') or {})} workers "
            f"(factor {st.get('factor')})"
            + (f" — {', '.join('w' + str(w) for w in flagged)}" if flagged else "")
        )
    lease = diag.get("lease")
    if lease:
        lines.append(
            f"  lease: timeout {lease['timeout_s']}s vs task p99 "
            f"{lease['task_p99_s']}s ({lease.get('expiries', 0)} expiries)"
        )
    comp = diag.get("compile")
    if comp:
        lines.append(
            f"  compile: {comp.get('count')} compiles {comp.get('total_s')}s "
            f"({comp.get('cache_hits')} hits, {comp.get('cache_misses')} "
            "misses)"
        )
    mem = diag.get("device_memory")
    if mem:
        lines.append(
            f"  device memory high-water: "
            f"{mem['high_water_bytes'] / 1e6:.1f} MB"
        )
    inc = diag.get("incomplete")
    if inc:
        lines.append(
            f"  incomplete: tasks={inc.get('tasks')} flows={inc.get('flows')}"
        )
    for f in diag.get("findings") or []:
        lines.append(f"  [{f['severity'].upper():<5}] {f['code']}: {f['message']}")
    if not (diag.get("findings") or []):
        lines.append("  no findings — run looks healthy")
    if regressions is not None:
        if regressions:
            lines.append(f"  REGRESSIONS vs baseline ({len(regressions)}):")
            for r in regressions:
                chg = "new" if r["change"] is None else f"{r['change']:+.1%}"
                lines.append(
                    f"    {r['metric']}: {r['baseline']} -> {r['current']} "
                    f"[{chg}, threshold {r['threshold']:.0%} {r['direction']}]"
                )
        else:
            lines.append("  baseline: no watched metric regressed")
    return "\n".join(lines)


def run_cli(args) -> int:
    """``doctor`` subcommand body. Exit 0 = diagnosis produced; 1 = a
    --baseline watched metric regressed (the CI gate); 2 = unreadable
    input. The literal target ``trend`` dispatches to the history
    analyzer (run_trend_cli) instead of the manifest diagnosis."""
    from mapreduce_rust_tpu_torch.runtime.telemetry import load_manifest

    if getattr(args, "live", None):
        return run_live_cli(args)
    if args.manifest is None:
        print("doctor: need a manifest path (or --live HOST:PORT, or "
              "'trend')")
        return 2
    if args.manifest == "trend":
        return run_trend_cli(args)
    try:
        manifest = load_manifest(args.manifest)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"doctor: cannot read manifest {args.manifest!r}: {e}")
        return 2

    job_report = None
    if getattr(args, "job_report", None):
        try:
            doc = load_manifest(args.job_report)
            job_report = doc.get("report", doc)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"doctor: cannot read job report {args.job_report!r}: {e}")
            return 2

    trace_events = None
    if getattr(args, "trace", None):
        try:
            trace_events = _load_trace_events(args.trace)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"doctor: cannot read trace {args.trace!r}: {e}")
            return 2

    diag = diagnose(
        manifest, job_report=job_report, trace_events=trace_events,
        straggler_factor=getattr(args, "straggler_factor", 2.0),
    )

    regressions = None
    if getattr(args, "baseline", None):
        try:
            base = load_manifest(args.baseline)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"doctor: cannot read baseline {args.baseline!r}: {e}")
            return 2
        regressions = compare_manifests(
            base, manifest,
            threshold_scale=getattr(args, "threshold_scale", 1.0),
        )
        diag["regressions"] = regressions

    if getattr(args, "format", "text") == "json":
        print(json.dumps(diag, indent=2, sort_keys=True))
    else:
        print(format_diagnosis(diag, regressions))
    return 1 if regressions else 0

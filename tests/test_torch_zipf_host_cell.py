"""The benchmark cell ``wordcount-zipf-host.64m``: the port's host-map engine
(``map_engine="host"``) under the benchmark's own answer check.

Its configuration is taken from the repository at a test's size
(``mrbench.tests.conftest.tiny``) and run through ``mrbench.harness.run_cell``
on the CPU stand-in of the card, every job held against the plain
reference. Windows of 16 KiB make each job span several windows, so the
scan pool, the fold shards and the dispatch plane's coalescing all run.
Three faults that reach this engine's own path (the packed merge, the host
scan's counts and its keys) must come out not correct. Then the readers
of the cell's four per-layer metrics on recorded job statistics, and the
dispatch plane's counters and spans. One test, marked ``cuda``, runs the
cell on a card.
"""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from mrbench import harness
from mrbench.harness import Job, Readings
from mrbench.tests.conftest import ROOT, HostCard, tiny
from mapreduce_rust_tpu_torch.runtime import driver
from mapreduce_rust_tpu_torch.runtime.metrics import jobstats_collector

CELL = "wordcount-zipf-host.64m"
SEED = 3_000_000_019  # over 2**31: a seed may need more than 32 signed bits
#: (host_map_workers, fold_shards) and the settings that go with them.
RUNS = {
    "w1-s1": dict(host_map_workers=1, fold_shards=1),
    "w3-s2": dict(host_map_workers=3, fold_shards=2),
    # Merges dispatch at every half-full staging buffer of one update cap,
    # and the state evicts into the host accumulator.
    "w3-s2-evict": dict(host_map_workers=3, fold_shards=2, merge_capacity=1 << 10,
                        host_update_cap=1 << 9, dispatch_stage_cap=1 << 9),
}


def _cell(**program) -> harness.Cell:
    cell = harness.load_cell(str(ROOT), CELL)
    cell.config, cell.traffic = tiny(cell.config, "64m")
    cell.config["program"].update(host_window_bytes=16 << 10, **program)
    return cell


def _run(monkeypatch, cell, card=None) -> tuple[dict, list]:
    """The run's result line and the JobStats of each of its jobs."""
    stats = []
    orig = driver.run_job

    def run_job(*args, **kwargs):
        res = orig(*args, **kwargs)
        stats.append(res.stats)
        return res
    monkeypatch.setattr(driver, "run_job", run_job)
    res = harness.run_cell(cell, SEED, 1.0, False, time.perf_counter(),
                           card or HostCard())
    return res, stats


def test_configuration_is_the_zipf_deployment_on_the_host_engine():
    b = harness.load_cell(str(ROOT), CELL).config
    z = harness.load_cell(str(ROOT), "wordcount-zipf.64m").config
    for key in ("app", "generator", "generator_params", "guarantees", "control",
                "job_bytes"):
        assert b[key] == z[key], key
    assert b["program"] == dict(z["program"], map_engine="host",
                                host_window_bytes=16 << 20)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_cell_against_the_reference(monkeypatch, run):
    res, stats = _run(monkeypatch, _cell(**RUNS[run]))
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    assert res["checks"]["unknown_keys"]["value"] == 0
    assert res["checks"]["hash_collisions"]["value"] == 0
    want = RUNS[run]
    for s in stats:
        assert s.dispatch_mode == "async+coalesce"
        assert (s.host_map_workers, s.fold_shards) == (want["host_map_workers"],
                                                       want["fold_shards"])
        assert s.chunks > 1  # windows
        assert s.step_graph_replays == 0
    job = stats[-1]
    if run.endswith("evict"):
        assert job.merge_dispatches > job.chunks and job.spill_events > 0
    else:
        assert job.merge_dispatches >= 1 and job.spill_events == 0


def _merge_unchanged(monkeypatch):
    orig = driver.make_packed_merge_fn

    def make_packed_merge_fn(app, cap):
        merge = orig(app, cap)

        def merge_unchanged(state, flat):
            _new, evicted, ev_count = merge(state, flat)
            return state, evicted, ev_count * 0
        return merge_unchanged
    monkeypatch.setattr(driver, "make_packed_merge_fn", make_packed_merge_fn)


def _patch_scans(monkeypatch, alter):
    """``alter(keys, counts)`` on copies of every host scan's result, as
    ``_stream_host_map`` finds the two scans."""
    def wrap(scan):
        def altered(*args):
            out = list(scan(*args))
            out[2], out[3] = out[2].copy(), out[3].copy()  # keys, counts
            alter(out[2], out[3])
            return tuple(out)
        return altered
    monkeypatch.setattr(driver, "scan_count_raw", wrap(driver.scan_count_raw))
    monkeypatch.setattr(driver, "scan_count_sharded_raw",
                        wrap(driver.scan_count_sharded_raw))


def _half_count(monkeypatch):
    def alter(keys, counts):
        if len(counts):
            i = int(np.argmax(counts))
            counts[i] //= 2
    _patch_scans(monkeypatch, alter)


def _key_bit_flipped(monkeypatch):
    def alter(keys, counts):
        if len(keys):
            keys[0, 0] ^= 1
    _patch_scans(monkeypatch, alter)


FAULTS = {"merge_unchanged": _merge_unchanged, "scan_half_count": _half_count,
          "scan_key_bit_flipped": _key_bit_flipped}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_faults_come_out_not_correct(monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    res, _stats = _run(monkeypatch, _cell(**RUNS["w3-s2"]))
    assert res["correct"] is False, res["checks"]
    assert res["failed"] >= 1
    assert res["checks"]["jobs_raised"]["value"] == 0  # wrong answers, not errors


# ---- the cell's per-layer metrics on recorded job statistics ----

READERS = {"scan_wait_s_per_gb": "scan_wait_s", "fold_stall_s_per_gb": "fold_stall_s",
           "coalesce_s_per_gb": "coalesce_s", "merge_device_s_per_gb": "merge_device_s"}


def _job(i, nbytes, **stats):
    return Job(index=i, file=0, path="", nbytes=nbytes, t0=10.0 * i, t1=10.0 * i + 2.0,
               output_dir="", trace_path=None,
               stats=dict(bytes_in=nbytes, unknown_keys=0, hash_collisions=0, **stats),
               error=None)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_readers_on_recorded_stats(metric):
    field = READERS[metric]
    jobs = [_job(0, 500_000_000, **{field: 1.0}), _job(1, 1_500_000_000, **{field: 3.0})]
    # The traced window's job: what these readers must not read.
    traced = [_job(2, 1_000_000_000, **{field: 50.0})]
    r = Readings(jobs=jobs, window_s=8.0, setup_s=12.5, trace=None, kind="cpu",
                 traced_jobs=traced)
    assert harness.read_metric(metric, r) == pytest.approx(4.0 / 2.0)
    # A program whose JobStats lacks the field (the device engine's
    # statistics of an older commit) gives no reading, and raises nothing.
    for j in jobs:
        del j.stats[field]
    assert harness.read_metric(metric, r) is None
    r.jobs = []
    assert harness.read_metric(metric, r) is None
    # Zero everywhere: no event was made (the CPU); the seconds the
    # other three read may be zero in earnest.
    r.jobs = [_job(0, 500_000_000, **{field: 0.0})]
    zero = harness.read_metric(metric, r)
    assert zero is None if field == "merge_device_s" else zero == 0.0


# ---- the dispatch plane's counters and spans ----

def _corpus(tmp_path) -> str:
    """160 KiB of the cell's Zipf text over 2^14 ranks: about ten 16 KiB windows."""
    from mrbench import gen

    cfg = harness.load_cell(str(ROOT), CELL).config
    params = dict(cfg["generator_params"], ranks=1 << 14)
    data, _ids, _counts = gen.load("zipf").generate(params, SEED, 0, 160 << 10, "cpu")
    path = tmp_path / "in.txt"
    path.write_bytes(data.tobytes())
    return str(path)


def test_dispatch_counters_and_spans(tmp_path):
    from mapreduce_rust_tpu_torch.config import Config

    cfg = Config(map_engine="host", device="cpu", host_window_bytes=16 << 10,
                 merge_capacity=1 << 14, reduce_n=4, host_map_workers=2, fold_shards=2,
                 work_dir=str(tmp_path / "work"), output_dir=str(tmp_path / "out"),
                 trace_path=str(tmp_path / "t.json"),
                 manifest_path=str(tmp_path / "m.json"))
    s = driver.run_job(cfg, [_corpus(tmp_path)], write_outputs=True).stats
    assert s.dispatch_mode == "async+coalesce" and s.chunks > 1
    assert 0 < s.coalesce_s <= s.dispatch_s
    assert s.merge_device_s == 0.0  # no CUDA event on the CPU
    live = jobstats_collector(s)()
    assert live["job.coalesce_s"] == round(s.coalesce_s, 6)
    assert live["job.merge_device_s"] == 0.0
    manifest = json.loads((tmp_path / "m.json").read_text())
    assert manifest["stats"]["coalesce_s"] == s.coalesce_s
    assert manifest["stats"]["merge_device_s"] == 0.0
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"]
    coalesce = [e for e in spans if e["name"] == "dispatch.coalesce"]
    flush = [e for e in spans if e["name"] == "dispatch.flush"]
    assert len(coalesce) == s.chunks  # one a window
    assert flush and sum(e["args"]["n"] for e in flush) == sum(
        e["args"]["n"] for e in spans if e["name"] == "dispatch.submit")
    counters = [e for e in events if e.get("ph") == "C" and e["name"] == "dispatch"]
    assert counters[-1]["args"] == {"coalesce_s": s.coalesce_s, "merge_device_s": 0.0}


@pytest.mark.cuda
def test_cell_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mrbench import chip

    res, stats = _run(monkeypatch, _cell(**RUNS["w3-s2-evict"]), chip.open_card(1))
    assert res["correct"] is True, res["checks"]
    for s in stats:
        assert 0 < s.merge_device_s <= s.wall_seconds
        assert 0 < s.coalesce_s <= s.dispatch_s

"""The port's coordinator/worker task path against the JAX package's.

Port and reference run the same scheduler script, the same in-process
clusters (asyncio tasks over real TCP) and mixed fleets on the same
seeded corpus, on the CPU. Outputs (``mr-{r}.txt``), intermediate arrays
(``mr-{m}-{r}.npz``) and dictionary shards (``dict-{m}-{r}.txt``) must be
identical; the reference's own tools (``mrcheck``, ``load_manifest``,
``validate_events``) must accept the port's artifacts.
"""

import asyncio
import json
import pathlib
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from mapreduce_rust_tpu.apps import get_app as jax_get_app
from mapreduce_rust_tpu.config import Config as JaxConfig
from mapreduce_rust_tpu.coordinator.server import Coordinator as JaxCoordinator
from mapreduce_rust_tpu.worker.runtime import Worker as JaxWorker
from mapreduce_rust_tpu_torch.apps import get_app
from mapreduce_rust_tpu_torch.config import Config
from mapreduce_rust_tpu_torch.coordinator.server import (
    DONE,
    NOT_READY,
    WAIT,
    Coordinator,
)
from mapreduce_rust_tpu_torch.core.normalize import reference_word_counts
from mapreduce_rust_tpu_torch.worker.runtime import Worker

REPO = pathlib.Path(__file__).resolve().parents[1]

#: Control-plane timings of every cluster here: fast leases, fast polls.
FAST = dict(lease_timeout_s=1.0, lease_check_period_s=0.2,
            lease_renew_period_s=0.2, poll_retry_s=0.05)
#: Device-engine shapes shared with tests/test_torch_driver.py, so the
#: reference's XLA compiles are the ones that file already pays for.
DEVICE_SHAPES = dict(chunk_bytes=1 << 16, merge_capacity=1 << 14)


def _corpus(seed: int, n_words: int, vocab_size: int) -> bytes:
    rng = np.random.default_rng(seed)
    vocab = [b"w%d" % i for i in range(vocab_size)] + [
        "café".encode(), "naïve".encode(), "Ωmega".encode(), "don’t".encode(),
        b"it's", b"x,y", b"end."]
    seps = [b" ", b"\t", b"\r\n", b"\n", " ".encode()]
    ws = rng.integers(0, len(vocab), n_words)
    ss = rng.integers(0, len(seps), n_words)
    return b"".join(vocab[w] + seps[s] for w, s in zip(ws.tolist(), ss.tolist()))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two corpora of two files each (join reads them as a=, b=); the
    classic apps read ``all``, the four files together."""
    root = tmp_path_factory.mktemp("corpus")
    for name in ("a", "b", "all"):
        (root / name).mkdir()
    for i, (n, v) in enumerate([(9000, 2500), (7000, 300), (8000, 1200), (5000, 40)]):
        data = _corpus(10 + i, n, v)
        side = "a" if i < 2 else "b"
        (root / side / f"doc-{i}.txt").write_bytes(data)
        (root / "all" / f"doc-{i}.txt").write_bytes(data)
    return root


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cluster_kw(corpus, out: pathlib.Path, app: str, **kw) -> dict:
    """Config fields both packages take for one cluster of ``app``."""
    fields = dict(map_n=4, reduce_n=3, worker_n=2, port=free_port(),
                  work_dir=str(out / "work"), output_dir=str(out / "out"),
                  **FAST)
    if app == "join":
        fields["input_dirs"] = (("a", str(corpus / "a")), ("b", str(corpus / "b")))
        fields["input_dir"] = str(corpus / "a")
    else:
        fields["input_dir"] = str(corpus / "all")
    fields.update(kw)
    return fields


APP_KW = {"grep": {"query": ("w7", "café", "w1")}, "top_k": {"k": 5}}


async def run_cluster(coord, workers, timeout: float = 60.0):
    serve = asyncio.create_task(coord.serve())
    await asyncio.sleep(0.1)
    tasks = [asyncio.create_task(w.run()) for w in workers]
    await asyncio.wait_for(asyncio.gather(*tasks), timeout=timeout)
    await asyncio.wait_for(serve, timeout=30)


def port_cluster(fields: dict, app: str, engine: str, n_workers: int = 2):
    cfg = Config(device="cpu", **fields)
    coord = Coordinator(cfg)
    workers = [Worker(cfg, app=get_app(app, **APP_KW.get(app, {})), engine=engine)
               for _ in range(n_workers)]
    asyncio.run(run_cluster(coord, workers))
    return coord, workers


def jax_cluster(fields: dict, app: str, engine: str, n_workers: int = 2):
    cfg = JaxConfig(device="cpu", **fields)
    coord = JaxCoordinator(cfg)
    workers = [JaxWorker(cfg, app=jax_get_app(app, **APP_KW.get(app, {})),
                         engine=engine) for _ in range(n_workers)]
    asyncio.run(run_cluster(coord, workers))
    return coord, workers


def outputs(out: pathlib.Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted((out / "out").glob("mr-*.txt"))}


def unstamped(path: pathlib.Path) -> bytes:
    """A dictionary shard's bytes with its 8-byte run token (a random
    per-instance name, header bytes 8:16) zeroed."""
    b = bytearray(path.read_bytes())
    b[8:16] = bytes(8)
    return bytes(b)


def assert_same_intermediates(want: pathlib.Path, got: pathlib.Path) -> None:
    names = sorted(p.name for p in (want / "work").glob("mr-*-*.npz"))
    assert names == sorted(p.name for p in (got / "work").glob("mr-*-*.npz"))
    assert names
    for name in names:
        with np.load(want / "work" / name) as w, np.load(got / "work" / name) as g:
            assert sorted(w.files) == sorted(g.files) == ["k1", "k2", "value"]
            for k in w.files:
                assert w[k].dtype == g[k].dtype, (name, k)
                assert np.array_equal(w[k], g[k]), (name, k)
    shards = sorted(p.name for p in (want / "work").glob("dict-*"))
    assert shards == sorted(p.name for p in (got / "work").glob("dict-*"))
    for name in shards:
        assert unstamped(want / "work" / name) == unstamped(got / "work" / name), name


def oracle(corpus) -> dict:
    total: dict = {}
    for p in sorted((corpus / "all").glob("*.txt")):
        for w, c in reference_word_counts(p.read_bytes()).items():
            total[w.encode()] = total.get(w.encode(), 0) + c
    return total


def read_counts(out: pathlib.Path) -> dict:
    table = {}
    for data in outputs(out).values():
        for line in data.splitlines():
            w, v = line.rsplit(b" ", 1)
            table[w] = int(v)
    return table


# ---- the scheduler, scripted under an injected clock ----

def _script(coord, clock: list) -> list:
    """One RPC sequence through a coordinator's in-process methods:
    registration barrier, grants, renewals, a stale renewal, lease expiry,
    re-grant, a late duplicate finish, speculation, the reduce gate."""
    out = []

    def rec(name, *a):
        out.append((name, a, getattr(coord, name)(*a)))

    rec("get_map_task", -1)            # barrier: NOT_READY
    rec("get_worker_id")
    rec("get_worker_id")
    rec("get_worker_id")               # full: DONE
    rec("get_map_task", 0)
    rec("get_map_task", 1)
    rec("renew_map_lease", 0, 0)
    clock[0] += 0.4
    rec("report_map_task_finish", 1, 1, 1)
    rec("renew_map_lease", 1, 1)       # stale: already reported
    rec("get_map_task", 1)
    rec("get_map_task", 0)
    clock[0] += 0.4
    rec("renew_map_lease", 2, 1)
    rec("renew_map_lease", 3, 0)
    clock[0] += 0.8                    # task 0's lease is past due
    coord.check_lease()
    rec("get_map_task", 1)             # re-grant of the expired task
    rec("report_map_task_finish", 2, 1, 1)
    rec("report_map_task_finish", 0, 1, 0)   # the expired attempt, late
    rec("get_reduce_task", 0)          # gate: map not finished
    clock[0] += 0.3
    rec("get_map_task", 1)             # idle worker: speculation (or WAIT)
    rec("report_map_task_finish", 3, 2, 1)
    rec("report_map_task_finish", 3, 1, 0)   # duplicate
    rec("report_map_task_finish", 0, 2, 1)   # duplicate
    rec("get_map_task", 0)             # DONE
    rec("get_reduce_task", 0)
    rec("get_reduce_task", 1)
    rec("report_reduce_task_finish", 0, 1, 0)
    rec("get_reduce_task", 0)
    rec("report_reduce_task_finish", 1, 1, 1)
    rec("report_reduce_task_finish", 2, 1, 0)
    rec("get_reduce_task", 1)          # DONE
    return out


@pytest.mark.parametrize("speculate", [False, True])
def test_scheduler_script_matches_reference(corpus, tmp_path, speculate):
    runs = {}
    for name, cfg_cls, coord_cls in (("jax", JaxConfig, JaxCoordinator),
                                     ("port", Config, Coordinator)):
        fields = cluster_kw(corpus, tmp_path / name, "word_count", reduce_n=3,
                            speculate=speculate, speculate_after_frac=0.5)
        clock = [100.0]
        coord = coord_cls(cfg_cls(**fields), now=lambda c=clock: c[0])
        calls = _script(coord, clock)
        journal = (tmp_path / name / "work" / "coordinator.journal").read_text()
        runs[name] = (calls, journal.splitlines(), coord.report.to_dict(), coord.stats())
    (jc, jj, jr, js), (pc, pj, pr, ps) = runs["jax"], runs["port"]
    assert pc == jc
    assert pj == jj and len(pj) == 1 + 4 + 3
    assert pr["events"] == jr["events"] and pr["totals"] == jr["totals"]
    assert pr["tasks"] == jr["tasks"]
    assert ps["totals"] == js["totals"]
    results = [r for _n, _a, r in pc]
    assert results[0] == NOT_READY and results[3] == DONE and results[-1] == DONE
    assert sum(t["expiries"] for t in pr["totals"].values()) >= 1
    assert any(e["ev"] == "late_finish" for e in pr["events"])
    if speculate:
        assert any(e["ev"] == "speculate" for e in pr["events"])
    else:
        assert WAIT in results


# ---- clusters: port workers against reference workers ----

CASES = [("host", a) for a in
         ("word_count", "inverted_index", "grep", "join", "top_k", "sort")] + [
    ("device", "word_count"), ("device", "inverted_index")]


@pytest.mark.parametrize("engine,app", CASES)
def test_cluster_matches_reference(corpus, tmp_path, engine, app):
    kw = DEVICE_SHAPES if engine == "device" else dict(chunk_bytes=1 << 14)
    jax_cluster(cluster_kw(corpus, tmp_path / "jax", app, **kw), app, engine)
    port_cluster(cluster_kw(corpus, tmp_path / "port", app, **kw), app, engine)
    want, got = outputs(tmp_path / "jax"), outputs(tmp_path / "port")
    assert list(want) == [f"mr-{r}.txt" for r in range(3)]
    assert got == want
    assert any(want.values())
    assert_same_intermediates(tmp_path / "jax", tmp_path / "port")
    if app == "word_count":
        assert read_counts(tmp_path / "port") == oracle(corpus)


@pytest.mark.parametrize("mix", ["port-coordinator", "jax-coordinator"])
def test_mixed_fleet(corpus, tmp_path, mix):
    """A port coordinator schedules reference workers, and the reverse:
    the wire protocol and the files are one."""
    fields = cluster_kw(corpus, tmp_path, "inverted_index", chunk_bytes=1 << 14)
    app = "inverted_index"
    if mix == "port-coordinator":
        coord = Coordinator(Config(device="cpu", **fields))
        cfg = JaxConfig(device="cpu", **fields)
        workers = [JaxWorker(cfg, app=jax_get_app(app)) for _ in range(2)]
    else:
        coord = JaxCoordinator(JaxConfig(device="cpu", **fields))
        cfg = Config(device="cpu", **fields)
        workers = [Worker(cfg, app=get_app(app), engine="host") for _ in range(2)]
    asyncio.run(run_cluster(coord, workers))
    jax_cluster(cluster_kw(corpus, tmp_path / "jax", app, chunk_bytes=1 << 14), app, "host")
    assert outputs(tmp_path) == outputs(tmp_path / "jax")
    assert coord.stats()["totals"]["reduce"]["completed"] == 3


# ---- a dead worker ----

def test_worker_dies_mid_map(corpus, tmp_path):
    """The victim signals from inside its map task and stalls past the
    lease timeout, so it always dies holding an unreported lease; the
    survivor re-executes the task and the outputs stay exact."""
    import threading
    import time

    fields = cluster_kw(corpus, tmp_path, "word_count", chunk_bytes=1 << 14)
    cfg = Config(device="cpu", **fields)
    started = threading.Event()

    class SlowMapVictim(Worker):
        def run_map_task(self, tid: int) -> None:
            started.set()
            time.sleep(1.5)  # past the 1.0 s lease
            super().run_map_task(tid)

    async def cluster():
        coord = Coordinator(cfg)
        serve = asyncio.create_task(coord.serve())
        await asyncio.sleep(0.1)
        victim = asyncio.create_task(SlowMapVictim(cfg, engine="device").run())
        survivor = asyncio.create_task(Worker(cfg, engine="device").run())
        deadline = asyncio.get_running_loop().time() + 30
        while not started.is_set():
            assert asyncio.get_running_loop().time() < deadline
            await asyncio.sleep(0.02)
        victim.cancel()
        await asyncio.gather(victim, return_exceptions=True)
        await asyncio.wait_for(survivor, timeout=60)
        await asyncio.wait_for(serve, timeout=30)
        return coord

    asyncio.run(cluster())
    assert read_counts(tmp_path) == oracle(corpus)
    rep = json.loads((tmp_path / "work" / "job_report.json").read_text())["report"]
    assert sum(t["expiries"] for t in rep["totals"].values()) >= 1
    assert sum(t["re_executions"] for t in rep["totals"].values()) >= 1


def test_cli_chaos_kill_reexecutes(corpus, tmp_path):
    """The CLI cluster with one worker SIGKILLing itself on its first map
    task (``--chaos 'kill:map:*'``): the victim dies by SIGKILL, the
    survivor exits 0, the job report shows the expiry and re-execution,
    and the outputs are exact."""
    common = ["--input", str(corpus / "all"), "--output", str(tmp_path / "out"),
              "--work", str(tmp_path / "work"), "--port", str(free_port()),
              "--reduce-n", "3", "--device", "cpu", "--chunk-mb", "0.0625",
              "--lease-timeout", "1", "--lease-check-period", "0.2",
              "--renew-period", "0.2", "--poll-retry", "0.05"]
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"}
    cli = [sys.executable, "-m", "mapreduce_rust_tpu_torch"]
    procs = [subprocess.Popen([*cli, "coordinator", "--worker-n", "2", *common], env=env)]
    try:
        procs.append(subprocess.Popen(
            [*cli, "worker", "--engine", "device", "--chaos", "kill:map:*", *common],
            env=env))
        procs.append(subprocess.Popen([*cli, "worker", "--engine", "device", *common],
                                      env=env))
        assert procs[1].wait(timeout=90) == -signal.SIGKILL
        assert procs[2].wait(timeout=90) == 0
        assert procs[0].wait(timeout=30) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert read_counts(tmp_path) == oracle(corpus)
    rep = json.loads((tmp_path / "work" / "job_report.json").read_text())["report"]
    assert rep["totals"]["map"]["expiries"] >= 1
    assert rep["totals"]["map"]["re_executions"] >= 1


# ---- artifacts read by the reference's own tools ----

def test_artifacts_pass_reference_tools(corpus, tmp_path):
    from mapreduce_rust_tpu.analysis.doctor import diagnose
    from mapreduce_rust_tpu.analysis.mrcheck import run_check
    from mapreduce_rust_tpu.runtime.telemetry import diff_manifests, load_manifest
    from mapreduce_rust_tpu.runtime.trace import load_trace, merge_traces, validate_events
    from mapreduce_rust_tpu_torch.runtime.driver import run_job

    fields = cluster_kw(corpus, tmp_path, "word_count", chunk_bytes=1 << 14,
                        worker_n=1, trace_path=str(tmp_path / "t.json"),
                        manifest_path=str(tmp_path / "m.json"))
    port_cluster(fields, "word_count", "device", n_workers=1)
    traces = sorted(tmp_path.glob("t-*.json"))
    manifests = sorted(tmp_path.glob("m-*.json"))
    assert [p.name[:3] for p in traces] == ["t-c", "t-w"]
    assert [p.name[:3] for p in manifests] == ["m-c", "m-w"]
    for t in traces:
        events, _meta = load_trace(str(t))
        validate_events(events)
    merged = merge_traces(str(tmp_path / "merged.json"), [str(t) for t in traces])
    assert merged["events"] > 0
    doc = run_check(str(tmp_path / "work"), trace=str(traces[0]))
    assert doc["ok"], doc["violations"]
    assert doc["checked"]["authoritative"] and doc["checked"]["journal_lines"] == 7
    kinds = {load_manifest(str(m))["kind"] for m in manifests}
    assert kinds == {"coordinator_manifest", "worker_manifest"}

    # run_job: the same bytes with tracing and the manifest on and off.
    base = dict(device="cpu", input_dir=str(corpus / "all"), reduce_n=3,
                chunk_bytes=1 << 14, work_dir=str(tmp_path / "rw"))
    off = run_job(Config(output_dir=str(tmp_path / "off"), **base))
    on = run_job(Config(output_dir=str(tmp_path / "on"), trace_path=str(tmp_path / "r.json"),
                        manifest_path=str(tmp_path / "rm.json"), **base))
    for a, b in zip(off.output_files, on.output_files):
        assert pathlib.Path(a).read_bytes() == pathlib.Path(b).read_bytes()
    m = load_manifest(str(tmp_path / "rm.json"))
    assert m["kind"] == "run_manifest" and m["stats"]["distinct_keys"] == on.stats.distinct_keys
    assert "timeseries" in m["stats"] and "device.drain_s" in m["stats"]["histograms"]
    events, _meta = load_trace(str(tmp_path / "r.json"))
    validate_events(events)
    names = {e["name"] for e in events}
    assert {"phase.stream", "chunk.dispatch", "device.drain", "ingest.wait"} <= names
    assert diagnose(m)["bottleneck"]
    assert isinstance(diff_manifests(m, m), list)


# ---- guards ----

def test_device_worker_raises_without_a_card(corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fields = cluster_kw(corpus, tmp_path, "word_count")
    for device in ("cuda", "auto"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Worker(Config(device=device, **fields), engine="device")
    Worker(Config(device="cuda", **fields), engine="host")  # no card needed
    assert not (tmp_path / "work").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Worker(Config(device="cuda", **fields))  # the device engine by default


@pytest.mark.parametrize("cmd", ["run", "coordinator", "worker", "service", "submit"])
def test_cli_defaults_are_config_defaults(cmd):
    """A flag the subcommand leaves unset, or does not define, leaves its
    Config field at Config's own default; the worker maps on the card."""
    from mapreduce_rust_tpu_torch.__main__ import _cfg, build_parser

    args = build_parser().parse_args([cmd])
    got, want = _cfg(args), Config()
    for field in ("merge_capacity", "partial_capacity", "map_engine", "host_map_workers",
                  "fold_shards", "dispatch_async", "dispatch_coalesce",
                  "dispatch_fill_frac", "host_accum_budget_mb", "dictionary_budget_words",
                  "spill_async", "speculate", "speculate_after_frac", "metrics_port",
                  "device", "lease_timeout_s", "sched", "service_max_jobs",
                  "service_inflight_budget_mb", "service_cache_entries"):
        assert getattr(got, field) == getattr(want, field), field
    if cmd == "worker":
        assert args.engine == "device"

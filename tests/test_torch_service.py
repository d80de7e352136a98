"""The port's multi-tenant job service against the JAX package's.

Port and reference services take the same submissions: spec validation,
digests and cache keys, the admission script under an injected clock and
the ``service.journal`` lines must be equal, and each service's journal
must replay in the other. Concurrent jobs through a port service and port
``ServiceWorker``s must write the same ``job-<id>/mr-{r}.txt`` bytes as the
reference service with reference workers, as the same jobs one after
another, and as mixed fleets. The reference host engine's ``run_job`` is
never the truth for join (its ``_PackStager`` aliasing loses lines on a
multi-core CPU); join is held against the reference service and a
per-document oracle instead.
"""

import asyncio
import dataclasses
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from mapreduce_rust_tpu.config import Config as JaxConfig
from mapreduce_rust_tpu.service import server as jax_server
from mapreduce_rust_tpu.worker.runtime import ServiceWorker as JaxServiceWorker
from mapreduce_rust_tpu_torch.config import Config
from mapreduce_rust_tpu_torch.coordinator.server import CoordinatorClient
from mapreduce_rust_tpu_torch.core.normalize import reference_word_counts
from mapreduce_rust_tpu_torch.service import server as port_server
from mapreduce_rust_tpu_torch.worker.runtime import ServiceWorker, Worker

REPO = pathlib.Path(__file__).resolve().parents[1]

#: Control-plane timings of every service here: fast leases, fast polls.
FAST = dict(lease_timeout_s=2.0, lease_check_period_s=0.2,
            lease_renew_period_s=0.2, poll_retry_s=0.05)
#: Device-engine shapes shared with tests/test_torch_cluster.py, so the
#: reference's XLA compiles are the ones that file already pays for.
DEVICE_SHAPES = dict(chunk_bytes=1 << 16, merge_capacity=1 << 14)
HOST_SHAPES = dict(chunk_bytes=1 << 14)
PKG = {"jax": (JaxConfig, jax_server.JobService, JaxServiceWorker),
       "port": (Config, port_server.JobService, ServiceWorker)}


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
    """Corpus a (three files) and corpus b (two files)."""
    root = tmp_path_factory.mktemp("corpus")
    for side, specs in (("a", [(3000, 900), (2000, 200), (2500, 40)]),
                        ("b", [(2000, 600), (1500, 120)])):
        (root / side).mkdir()
        for i, (n, v) in enumerate(specs):
            seed = (1 if side == "a" else 2) * 100 + i
            (root / side / f"doc-{i}.txt").write_bytes(_corpus(seed, n, v))
    return root


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def svc_fields(root: pathlib.Path, **kw) -> dict:
    fields = dict(map_n=1, reduce_n=3, worker_n=1, port=free_port(),
                  input_dir=str(root / "idle"), work_dir=str(root / "work"),
                  output_dir=str(root / "out"), **FAST)
    fields.update(kw)
    return fields


def specs_of(corpus, kind: str) -> list:
    a, b = str(corpus / "a"), str(corpus / "b")
    if kind == "device":
        return [{"app": "word_count", "input_dir": a, "reduce_n": 3},
                {"app": "inverted_index", "input_dir": b, "reduce_n": 2}]
    return [{"app": "word_count", "input_dir": a, "reduce_n": 3},
            {"app": "inverted_index", "input_dir": b, "reduce_n": 2},
            {"app": "sort", "input_dir": a, "reduce_n": 3, "split_samples": 64},
            {"app": "join", "reduce_n": 3, "inputs": [["a", a], ["b", b]]}]


async def _wait_done(client, jids, timeout_s: float) -> dict:
    deadline = time.monotonic() + timeout_s
    while True:
        st = await client.call("list_jobs")
        states = {j["job"]: j["state"] for j in st["jobs"]}
        if all(states.get(j) == "done" for j in jids):
            return states
        assert time.monotonic() < deadline, f"jobs not done: {states}"
        await asyncio.sleep(0.05)


async def _drive(svc, workers, specs, timeout_s: float = 60.0):
    """Serve, submit ``specs``, run ``workers`` until every job is done,
    then shut down. Returns the submit results."""
    serve = asyncio.create_task(svc.serve())
    await asyncio.sleep(0.1)
    client = CoordinatorClient(svc.cfg.host, svc.cfg.port, timeout_s=15.0)
    await client.connect()
    results = []
    for spec in specs:
        res = await client.call("submit_job", spec)
        assert res["ok"], res
        results.append(res)
    tasks = [asyncio.create_task(w.run()) for w in workers]
    await _wait_done(client, [r["job"] for r in results], timeout_s)
    await client.call("shutdown")
    await client.close()
    await asyncio.wait_for(asyncio.gather(*tasks), timeout=30)
    await asyncio.wait_for(serve, timeout=30)
    return results


def run_service(svc_pkg: str, worker_pkgs, fields: dict, specs, engine="host"):
    cfg_cls, svc_cls, _w = PKG[svc_pkg]
    svc = svc_cls(cfg_cls(device="cpu", **fields))
    workers = []
    for pkg in worker_pkgs:
        wcfg_cls, _s, worker_cls = PKG[pkg]
        workers.append(worker_cls(wcfg_cls(device="cpu", **fields), engine=engine))
    results = asyncio.run(_drive(svc, workers, specs))
    return svc, results


def job_outputs(fields: dict, results) -> list:
    out = pathlib.Path(fields["output_dir"])
    return [{p.name: p.read_bytes() for p in sorted((out / f"job-{r['job']}").glob("mr-*.txt"))}
            for r in results]


def oracle_wc(corpus, side: str) -> dict:
    total: dict = {}
    for p in sorted((corpus / side).glob("*.txt")):
        for w, c in reference_word_counts(p.read_bytes()).items():
            total[w.encode()] = total.get(w.encode(), 0) + c
    return total


def per_doc(corpus, side: str) -> list:
    return [{w.encode() for w in reference_word_counts(p.read_bytes())}
            for p in sorted((corpus / side).glob("*.txt"))]


def check_oracles(corpus, outs: list) -> None:
    """word_count, sort and join of ``specs_of(corpus, "host")`` against
    per-file reference_word_counts."""
    wc = {}
    for data in outs[0].values():
        for line in data.splitlines():
            w, v = line.rsplit(b" ", 1)
            wc[w] = int(v)
    assert wc == oracle_wc(corpus, "a")
    want_sort = sorted(w for w, c in oracle_wc(corpus, "a").items() for _ in range(c))
    got_sort = b"".join(outs[2][f"mr-{r}.txt"] for r in range(3)).splitlines()
    assert got_sort == want_sort
    a_docs, b_docs = per_doc(corpus, "a"), per_doc(corpus, "b")
    want_join = sorted(b"%s %d %d" % (w, i, j)
                       for i, da in enumerate(a_docs) for j, db in enumerate(b_docs)
                       for w in da & db)
    got_join = sorted(line for data in outs[3].values() for line in data.splitlines())
    assert got_join == want_join and got_join


@pytest.fixture(scope="module")
def host_runs(corpus, tmp_path_factory):
    """The host-engine job mix through the reference service with
    reference workers, and through the port service with port workers (3
    concurrent, one queued), and one after another."""
    runs = {}
    for name, svc_pkg, max_jobs in (("jax", "jax", 3), ("port", "port", 3),
                                    ("port-seq", "port", 1)):
        root = tmp_path_factory.mktemp(name)
        fields = svc_fields(root, service_max_jobs=max_jobs, **HOST_SHAPES)
        svc, results = run_service(svc_pkg, [svc_pkg] * 2, fields, specs_of(corpus, "host"))
        runs[name] = (fields, results, job_outputs(fields, results), svc)
    return runs


# ---- specs, digests and cache keys ----

SPEC_CASES = {
    "word_count": lambda a, b: {"app": "word_count", "input_dir": a},
    "unknown-app": lambda a, b: {"app": "nope", "input_dir": a},
    "missing-dir": lambda a, b: {"app": "word_count", "input_dir": a + "-x"},
    "grep-no-query": lambda a, b: {"app": "grep", "input_dir": a},
    "grep-string-query": lambda a, b: {"app": "grep", "input_dir": a,
                                       "app_args": {"query": "fox"}},
    "grep": lambda a, b: {"app": "grep", "input_dir": a,
                          "app_args": {"query": ("w7", "café")}},
    "reduce-0": lambda a, b: {"app": "word_count", "input_dir": a, "reduce_n": 0},
    "top_k-bad-k": lambda a, b: {"app": "top_k", "input_dir": a, "app_args": {"k": "x"}},
    "top_k": lambda a, b: {"app": "top_k", "input_dir": a, "app_args": {"k": 5}},
    "bogus-args": lambda a, b: {"app": "word_count", "input_dir": a,
                                "app_args": {"bogus": 1}},
    "split-samples-bool": lambda a, b: {"app": "sort", "input_dir": a,
                                        "split_samples": True},
    "sort": lambda a, b: {"app": "sort", "input_dir": a, "split_samples": 64},
    "join": lambda a, b: {"app": "join", "inputs": [["a", a], ["b", b]]},
    "join-swapped": lambda a, b: {"app": "join", "inputs": [["b", b], ["a", a]]},
    "join-one-corpus": lambda a, b: {"app": "join", "input_dir": a},
    "dup-names": lambda a, b: {"app": "word_count", "inputs": [["a", a], ["a", b]]},
    "no-inputs": lambda a, b: {"app": "word_count", "input_dir": a,
                               "input_pattern": "*.none"},
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_spec_digests_and_keys_match_reference(corpus, case):
    spec = SPEC_CASES[case](str(corpus / "a"), str(corpus / "b"))
    got = {}
    for name, mod in (("jax", jax_server), ("port", port_server)):
        try:
            canon = mod.validate_spec(json.loads(json.dumps(spec)))
        except ValueError as e:
            got[name] = ("error", str(e))
            continue
        got[name] = (canon, mod.config_digest(canon), mod._ResultCache.key(canon),
                     mod.scan_corpus_spec(canon)[1:],
                     mod.corpus_digest(canon["input_dir"], canon["input_pattern"]))
    assert got["port"] == got["jax"]
    if case in ("word_count", "grep", "top_k", "sort", "join", "join-swapped"):
        assert got["port"][0] != "error"
    if case == "join-swapped":
        join = SPEC_CASES["join"](str(corpus / "a"), str(corpus / "b"))
        assert port_server._ResultCache.key(port_server.validate_spec(join)) == got["port"][2]


# ---- the admission plane, scripted under an injected clock ----

def _scrub(obj, root: str):
    """Results with the run's root path cut out and the report's wall
    stamps dropped."""
    if isinstance(obj, dict):
        return {k: _scrub(v, root) for k, v in obj.items()
                if k not in ("wall_start_unix_s", "anchor_unix_s")}
    if isinstance(obj, (list, tuple)):
        return [_scrub(v, root) for v in obj]
    if isinstance(obj, str):
        return obj.replace(root, "ROOT")
    return obj


def _admission_script(svc, clock: list, docs: str) -> list:
    out = []

    def rec(name, *a):
        out.append((name, a, getattr(svc, name)(*a)))

    def tick(dt=0.25):
        clock[0] += dt

    wc = lambda n, **kw: {"app": "word_count", "input_dir": docs, "reduce_n": n, **kw}
    rec("get_task", 0)                      # nothing running: WAIT
    rec("get_worker_id")
    rec("submit_job", wc(3))                # admits
    tick()
    rec("submit_job", wc(2))                # over the budget: queued
    svc._doctor_tick()
    out.append(("findings", (), dict(svc._live_findings)))
    rec("submit_job", wc(5), 5)             # higher priority, queued
    rec("submit_job", wc(2), 9)             # twin of the queued wc(2): joins, raises it
    rec("submit_job", {"app": "nope", "input_dir": docs})
    rec("queued_count")
    rec("get_task", 0)                      # a job-tagged grant of the running job
    rec("list_jobs")
    tick()
    rec("cancel_job", "j1")                 # head leaves: wc(2) (priority 9) admits
    svc._doctor_tick()
    out.append(("findings", (), dict(svc._live_findings)))
    for jid in ("j1", "j2", "j3", "j4", "j5"):
        rec("job_status", jid)
    rec("cancel_job", "j4")                 # the joined twin, while waiting
    tick()
    rec("cancel_job", "j2")                 # running: finalized cancelled; j3 admits
    rec("get_result", "j2")
    for n in (6, 7, 8, 9):                  # retention past DONE_JOBS_MAX
        rec("submit_job", wc(n))
        tick(0.1)
    rec("cancel_job", "j5")
    rec("cancel_job", "j8")
    rec("list_jobs")
    rec("request_drain")
    rec("submit_job", wc(10))               # draining: refused
    rec("cancel_job", "j3")
    rec("get_task", 0)                      # drained and empty: DONE
    rec("service_summary")
    return out


def test_admission_script_matches_reference(corpus, tmp_path, monkeypatch):
    docs = str(corpus / "a")
    size_mb = sum(p.stat().st_size for p in (corpus / "a").glob("*.txt")) / (1 << 20)
    runs = {}
    for name in ("jax", "port"):
        cfg_cls, svc_cls, _w = PKG[name]
        monkeypatch.setattr(svc_cls, "DONE_JOBS_MAX", 4)
        root = tmp_path / name
        clock = [100.0]
        cfg = cfg_cls(**svc_fields(root, service_max_jobs=2,
                                   service_inflight_budget_mb=size_mb * 1.5))
        svc = svc_cls(cfg, now=lambda c=clock: c[0])
        calls = _admission_script(svc, clock, docs)
        journal = [json.loads(line) for line in
                   (root / "work" / "service.journal").read_text().splitlines()]
        runs[name] = _scrub((calls, journal), str(root))
    (jc, jj), (pc, pj) = runs["jax"], runs["port"]
    assert [c[0] for c in pc] == [c[0] for c in jc]
    for want, got in zip(jc, pc):
        assert got == want, want[0]
    assert pj == jj
    assert any(c[0] == "findings" and c[2]["service-saturated"]["active"] for c in pc)
    assert [r.get("state") for n, a, r in pc if n == "submit_job"] == [
        "running", "queued", "queued", "joined", None, "queued", "queued", "queued",
        "queued", None]
    assert sum(1 for row in pj if row["op"] == "submit") == 8
    listing = [r for n, a, r in pc if n == "list_jobs"][-1]
    assert "j1" not in {j["job"] for j in listing["jobs"]}   # retention
    assert pc[-1][2]["draining"] and pc[-2][2] == -1         # drained: DONE


# ---- the journal, written by one service and replayed by the other ----

@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_journal_replays_across_packages(corpus, tmp_path, writer, reader):
    docs = str(corpus / "a")
    fields = svc_fields(tmp_path, service_max_jobs=1)
    wcfg, wsvc, _ = PKG[writer]
    rcfg, rsvc, _ = PKG[reader]
    mod = jax_server if writer == "jax" else port_server
    svc = wsvc(wcfg(**fields))
    r1 = svc.submit_job({"app": "word_count", "input_dir": docs})
    r2 = svc.submit_job({"app": "word_count", "input_dir": docs, "reduce_n": 2})
    # A completed job's rows and outputs, as the writer's own finalize
    # leaves them: the reader must seed its cache from them.
    out = tmp_path / "done-out"
    out.mkdir()
    (out / "mr-0.txt").write_bytes(b"cached 1\n")
    spec = mod.validate_spec({"app": "word_count", "input_dir": docs, "reduce_n": 9})
    svc._journal("submit", "j90", spec=spec, priority=0)
    svc._journal("done", "j90", state="done", cache_key=mod._ResultCache.key(spec),
                 outputs=[str(out / "mr-0.txt")])
    other = rsvc(rcfg(**fields))
    assert other.jobs[r1["job"]].state == "running"   # re-admitted (cap 1)
    assert other.jobs[r2["job"]].state == "queued"
    assert other.jobs["j90"].state == "done"
    res = other.submit_job(dict(spec))
    assert res["cached"] is True and res["job"] == "j91"
    assert other.jobs[res["job"]].outputs == [str(out / "mr-0.txt")]
    again = wsvc(wcfg(**fields))                       # and back again
    assert again.jobs[res["job"]].cached and again.jobs[r2["job"]].state == "queued"


# ---- concurrent jobs through the service ----

def test_concurrent_host_jobs_match_reference(corpus, host_runs):
    want = host_runs["jax"][2]
    assert host_runs["port"][2] == want
    assert host_runs["port-seq"][2] == want
    assert all(outs for outs in want)
    check_oracles(corpus, host_runs["port"][2])
    svc = host_runs["port"][3]
    assert svc.cache.stats()["hits"] == 0 and svc.jobs_completed == 4
    from mapreduce_rust_tpu.analysis.mrcheck import run_check

    doc = run_check(host_runs["port"][0]["work_dir"])
    assert doc["ok"], doc["violations"]
    assert doc["checked"]["jobs"] == 4


def test_concurrent_device_jobs_match_reference(corpus, tmp_path):
    """word_count and inverted_index at once on the device engine
    (``device="cpu"``), against the reference's device engine."""
    outs = {}
    for pkg in ("jax", "port"):
        fields = svc_fields(tmp_path / pkg, service_max_jobs=2, **DEVICE_SHAPES)
        _svc, results = run_service(pkg, [pkg] * 2, fields, specs_of(corpus, "device"),
                                    engine="device")
        outs[pkg] = job_outputs(fields, results)
    assert outs["port"] == outs["jax"] and all(outs["port"])


@pytest.mark.parametrize("mix", ["port-service", "jax-service"])
def test_mixed_fleet(corpus, tmp_path, host_runs, mix):
    """A port service with reference workers, and the reverse."""
    svc_pkg, worker_pkg = ("port", "jax") if mix == "port-service" else ("jax", "port")
    fields = svc_fields(tmp_path, service_max_jobs=3, **HOST_SHAPES)
    _svc, results = run_service(svc_pkg, [worker_pkg] * 2, fields, specs_of(corpus, "host"))
    assert job_outputs(fields, results) == host_runs["jax"][2]


def test_pipeline_sched_matches_fifo(corpus, tmp_path, host_runs):
    fields = svc_fields(tmp_path, service_max_jobs=3, sched="pipeline", **HOST_SHAPES)
    svc, results = run_service("port", ["port"] * 2, fields, specs_of(corpus, "host"))
    assert svc.service_summary()["sched"] == "pipeline"
    assert job_outputs(fields, results) == host_runs["port"][2]
    from mapreduce_rust_tpu.analysis.mrcheck import run_check

    doc = run_check(fields["work_dir"])
    assert doc["ok"], doc["violations"]


# ---- the result cache and in-flight dedup; the reference's tools ----

def test_cache_and_dedup_zero_new_grants(corpus, tmp_path):
    """A twin submitted while its job runs joins it; a repeat after it is
    done is served from the cache; neither is granted a task. The traced
    service root passes the reference's mrcheck and validate_events."""
    from mapreduce_rust_tpu.analysis.mrcheck import run_check
    from mapreduce_rust_tpu.runtime.telemetry import load_manifest
    from mapreduce_rust_tpu.runtime.trace import load_trace, validate_events

    docs = str(corpus / "a")
    spec = {"app": "word_count", "input_dir": docs, "reduce_n": 3}
    fields = svc_fields(tmp_path, trace_path=str(tmp_path / "t.json"),
                        manifest_path=str(tmp_path / "m.json"), **HOST_SHAPES)
    cfg = Config(device="cpu", **fields)
    svc = port_server.JobService(cfg)
    seen = {}

    async def go():
        serve = asyncio.create_task(svc.serve())
        await asyncio.sleep(0.1)
        client = CoordinatorClient(cfg.host, cfg.port, timeout_s=15.0)
        await client.connect()
        r1 = await client.call("submit_job", spec)
        r2 = await client.call("submit_job", spec)  # no workers yet: r1 runs
        assert r1["state"] == "running" and r2["state"] == "joined"
        assert r2["joined"] == r1["job"]
        assert (await client.call("get_result", r2["job"]))["ok"] is False
        workers = [asyncio.create_task(ServiceWorker(cfg, engine="host").run())
                   for _ in range(2)]
        await _wait_done(client, [r1["job"], r2["job"]], 60)
        grants = (await client.call("list_jobs"))["service"]["tenants"]
        r3 = await client.call("submit_job", spec)
        assert r3["cached"] is True and r3["state"] == "done"
        seen["st"] = {r["job"]: await client.call("job_status", r["job"])
                      for r in (r1, r2, r3)}
        seen["view"] = await client.call("list_jobs")
        seen["grants"] = grants
        await client.call("shutdown")
        await client.close()
        await asyncio.wait_for(asyncio.gather(*workers), timeout=30)
        await asyncio.wait_for(serve, timeout=30)

    asyncio.run(go())
    st = seen["st"]
    j1, j2, j3 = sorted(st)
    n_inputs = len(list((corpus / "a").glob("*.txt")))
    assert st[j1]["totals"]["map"]["completed"] == n_inputs
    assert sum(t["grants"] for t in st[j1]["tasks"]["map"].values()) == n_inputs
    for j in (j2, j3):
        assert st[j]["cached"] is True and st[j].get("totals") is None
        assert st[j]["outputs"] == st[j1]["outputs"]
    tenants = seen["view"]["service"]["tenants"]
    assert tenants[j1]["grants"] == seen["grants"][j1]["grants"] == n_inputs + 3
    assert tenants[j2]["grants"] == tenants[j3]["grants"] == 0
    cache = seen["view"]["service"]["cache"]
    assert cache["hit_inflight"] == 1 and cache["hit_done"] == 1
    doc = run_check(str(tmp_path / "work"))
    assert doc["ok"], doc["violations"]
    traces = sorted(tmp_path.glob("t-*.json"))
    assert traces and any(p.name.startswith("t-svc") for p in traces)
    for t in traces:
        events, _meta = load_trace(str(t))
        validate_events(events)
    kinds = {load_manifest(str(m))["kind"] for m in tmp_path.glob("m-*.json")}
    assert kinds == {"service_manifest", "worker_manifest"}


# ---- classic single-job workers keep their wire format ----

def test_classic_worker_stays_wire_valid(corpus, tmp_path, monkeypatch):
    """A classic port Worker (no job tags) completes the only running job
    of a port service, and sends a Coordinator exactly what it sent before
    the service seams: two- or three-parameter renewals and None in the
    finish report's job slot."""
    sent = []
    call = CoordinatorClient.call

    async def recording(self, method, *params):
        sent.append((method, params))
        return await call(self, method, *params)

    monkeypatch.setattr(CoordinatorClient, "call", recording)
    docs = str(corpus / "a")
    fields = svc_fields(tmp_path, **HOST_SHAPES)
    cfg = Config(device="cpu", **fields)
    svc = port_server.JobService(cfg)

    async def go():
        serve = asyncio.create_task(svc.serve())
        await asyncio.sleep(0.1)
        client = CoordinatorClient(cfg.host, cfg.port, timeout_s=15.0)
        await client.connect()
        jid = (await client.call("submit_job", {"app": "word_count", "input_dir": docs,
                                                "reduce_n": 3}))["job"]
        wcfg = dataclasses.replace(
            cfg, map_n=3, reduce_n=3, lease_renew_period_s=0.05,
            input_dir=docs, work_dir=os.path.join(cfg.work_dir, f"job-{jid}"),
            output_dir=os.path.join(cfg.output_dir, f"job-{jid}"))
        w = asyncio.create_task(Worker(wcfg, engine="host").run())
        await _wait_done(client, [jid], 60)
        await client.call("shutdown")
        await client.close()
        await asyncio.wait_for(w, timeout=30)
        await asyncio.wait_for(serve, timeout=30)
        return jid

    jid = asyncio.run(go())
    got = {}
    for data in (tmp_path / "out" / f"job-{jid}").glob("mr-*.txt"):
        for line in data.read_bytes().splitlines():
            w, v = line.rsplit(b" ", 1)
            got[w] = int(v)
    assert got == oracle_wc(corpus, "a")
    finishes = [p for m, p in sent if m == "report_map_task_finish"]
    assert finishes and all(len(p) == 5 and p[3] is None for p in finishes)
    assert all(len(p) == 3 for m, p in sent if m == "report_reduce_task_finish")
    assert all(len(p) in (2, 3) for m, p in sent if m.startswith("renew_"))
    assert not any(m in ("get_task", "job_spec") for m, _p in sent)


# ---- the CLI: drain and restart; a chaos kill ----

def _cli_env() -> dict:
    return {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"}


def _cli(*args) -> list:
    return [sys.executable, "-m", "mapreduce_rust_tpu_torch", *args]


def _common(corpus, root: pathlib.Path, port: int) -> list:
    return ["--input", str(corpus / "a"), "--output", str(root / "out"),
            "--work", str(root / "work"), "--port", str(port), "--device", "cpu",
            "--chunk-mb", "0.0625", "--lease-timeout", "1", "--lease-check-period",
            "0.2", "--renew-period", "0.2", "--poll-retry", "0.05"]


def _submit(common, reduce_n: int, side: str = "a", corpus=None) -> dict:
    args = list(common)
    if corpus is not None:
        args[1] = str(corpus / side)
    r = subprocess.run(_cli("submit", *args, "--reduce-n", str(reduce_n),
                            "--connect-retries", "50"),
                       env=_cli_env(), capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, (r.stdout, r.stderr[-2000:])
    return json.loads(r.stdout.splitlines()[0])


def _jobs(common) -> dict:
    port = common[common.index("--port") + 1]
    r = subprocess.run(_cli("jobs", "--port", port, "--json"), env=_cli_env(),
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout)


def _wait_all(procs: dict, timeout: float) -> dict:
    rcs = {}
    try:
        for name, p in procs.items():
            try:
                rcs[name] = p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                rcs[name] = None
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return rcs


def _read_wc(out: pathlib.Path) -> dict:
    got = {}
    for p in out.glob("mr-*.txt"):
        for line in p.read_bytes().splitlines():
            w, v = line.rsplit(b" ", 1)
            got[w] = int(v)
    return got


def test_cli_sigterm_drain_then_restart_completes(corpus, tmp_path):
    """SIGTERM with one job running and one queued: the service finishes
    the running job and exits 0, the workers go home; a restarted service
    takes the queued job from its journal and completes it."""
    port = free_port()
    common = _common(corpus, tmp_path, port)
    procs = {"service": subprocess.Popen(_cli("service", *common, "--max-jobs", "1"),
                                         env=_cli_env())}
    try:
        r1, r2 = _submit(common, 3), _submit(common, 2)
        states = {j["job"]: j["state"] for j in _jobs(common)["jobs"]}
        assert states == {r1["job"]: "running", r2["job"]: "queued"}
        procs["service"].send_signal(signal.SIGTERM)
        view = _jobs(common)
        assert view["service"]["draining"] and view["service"]["queued"] == 1
        for i in range(2):
            procs[f"w{i}"] = subprocess.Popen(
                _cli("worker", "--service", *common), env=_cli_env())
    finally:
        rcs = _wait_all(procs, 90)
    assert rcs == {"service": 0, "w0": 0, "w1": 0}
    assert _read_wc(tmp_path / "out" / f"job-{r1['job']}") == oracle_wc(corpus, "a")
    assert not (tmp_path / "out" / f"job-{r2['job']}").exists()

    port = free_port()
    common = _common(corpus, tmp_path, port)
    procs = {"service": subprocess.Popen(_cli("service", *common), env=_cli_env())}
    try:
        procs["w0"] = subprocess.Popen(_cli("worker", "--service", *common),
                                       env=_cli_env())
        deadline = time.monotonic() + 90
        while True:
            states = {j["job"]: j["state"] for j in _jobs(common)["jobs"]}
            if states.get(r2["job"]) == "done":
                break
            assert time.monotonic() < deadline, states
            time.sleep(0.2)
        assert states[r1["job"]] == "done"
        procs["service"].send_signal(signal.SIGTERM)
    finally:
        rcs = _wait_all(procs, 60)
    assert rcs == {"service": 0, "w0": 0}
    assert _read_wc(tmp_path / "out" / f"job-{r2['job']}") == oracle_wc(corpus, "a")


def test_cli_chaos_kill_under_multi_job_service(corpus, tmp_path):
    """Two jobs at once on two device-engine service workers, one of which
    SIGKILLs itself on its first map task: both jobs complete exact, and
    the reference's mrcheck finds the service root conformant."""
    from mapreduce_rust_tpu.analysis.mrcheck import run_check

    port = free_port()
    common = _common(corpus, tmp_path, port)
    procs = {"service": subprocess.Popen(_cli("service", *common, "--max-jobs", "2"),
                                         env=_cli_env())}
    try:
        r1 = _submit(common, 3)
        r2 = _submit(common, 2, side="b", corpus=corpus)
        procs["victim"] = subprocess.Popen(
            _cli("worker", "--service", "--chaos", "kill:map:*", *common), env=_cli_env())
        procs["survivor"] = subprocess.Popen(
            _cli("worker", "--service", *common), env=_cli_env())
        assert procs["victim"].wait(timeout=90) == -signal.SIGKILL
        deadline = time.monotonic() + 90
        while True:
            states = {j["job"]: j["state"] for j in _jobs(common)["jobs"]}
            if all(states.get(r["job"]) == "done" for r in (r1, r2)):
                break
            assert time.monotonic() < deadline, states
            time.sleep(0.2)
        procs["service"].send_signal(signal.SIGTERM)
    finally:
        rcs = _wait_all(procs, 60)
    assert rcs == {"service": 0, "victim": -signal.SIGKILL, "survivor": 0}
    assert _read_wc(tmp_path / "out" / f"job-{r1['job']}") == oracle_wc(corpus, "a")
    assert _read_wc(tmp_path / "out" / f"job-{r2['job']}") == oracle_wc(corpus, "b")
    reports = [json.loads((tmp_path / "work" / f"job-{r['job']}" / "job_report.json")
                          .read_text())["report"] for r in (r1, r2)]
    assert sum(rep["totals"]["map"]["re_executions"] for rep in reports) >= 1
    doc = run_check(str(tmp_path / "work"))
    assert doc["ok"], doc["violations"]


# ---- guards ----

_TORCH_FREE = """
import sys
import mapreduce_rust_tpu_torch.__main__ as cli
from mapreduce_rust_tpu_torch.config import Config
from mapreduce_rust_tpu_torch.service.server import JobService
args = cli.build_parser().parse_args(["service", "--work", sys.argv[2], "--output", sys.argv[2]])
cfg = cli._cfg(args)
clock = [0.0]
svc = JobService(cfg, now=lambda: clock[0])
r1 = svc.submit_job({"app": "word_count", "input_dir": sys.argv[1]})
svc.get_worker_id()
g = svc.get_task(0)
assert g["job"] == r1["job"], g
svc._doctor_tick()
svc._metrics_tick(force=True)
job = svc.jobs[r1["job"]]
svc._finalize_job(job, state="done")
svc.list_jobs()
print("TORCH", "torch" in sys.modules, "JAX", "jax" in sys.modules)
"""


def test_service_process_never_imports_torch(corpus, tmp_path):
    r = subprocess.run([sys.executable, "-c", _TORCH_FREE, str(corpus / "a"),
                        str(tmp_path / "w")], capture_output=True, text=True,
                       timeout=60, env=_cli_env(), cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "TORCH False JAX False" in r.stdout


def test_service_worker_needs_a_card_by_default(corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fields = svc_fields(tmp_path, input_dir=str(corpus / "a"))
    for device in ("cuda", "auto"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServiceWorker(Config(device=device, **fields))
    ServiceWorker(Config(device="cuda", **fields), engine="host")  # no card needed
    w = ServiceWorker(Config(device="cpu", **fields))
    assert w.engine == "device" and w.device == torch.device("cpu")
    assert not (tmp_path / "work").exists()


def test_job_switch_keeps_device_and_trims_grep_cache(corpus, tmp_path):
    """Switching jobs rebuilds the config from the base one, keeps the
    device the worker resolved, and drops grep's cached query tensors."""
    from mapreduce_rust_tpu_torch.apps import grep

    fields = svc_fields(tmp_path, input_dir=str(corpus / "a"))
    w = ServiceWorker(Config(device="cpu", **fields))
    spec = {"job": "j1", "app": "grep", "app_args": {"query": ["w7"]},
            "input_dir": str(corpus / "a"), "input_pattern": "*.txt", "map_n": 3,
            "reduce_n": 2, "split_samples": 512, "work_dir": str(tmp_path / "j1w"),
            "output_dir": str(tmp_path / "j1o")}
    w._apply_spec(spec)
    assert w.cfg.reduce_n == 2 and w._job_ctx == "j1" and w.app.query == ("w7",)
    grep._query_tensors(("w7",), torch.device("cpu"))
    grep._query_tensors(("w1", "w2"), torch.device("cpu"))
    assert grep._query_tensors.cache_info().currsize >= 2
    w._job_teardown()
    assert grep._query_tensors.cache_info().currsize == 0
    w._apply_spec({**spec, "job": "j2", "app": "word_count", "app_args": {}})
    assert w.device == torch.device("cpu") and w._task_fid("map", 0, 1) == "j2:map:0:1"
    assert w.cfg.device == "cpu" and w.report.row_job == "j2"

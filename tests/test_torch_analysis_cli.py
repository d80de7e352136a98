"""The port's analysis commands against the JAX package's.

``stats``, ``doctor``, ``trace merge`` and ``fleet`` of both packages run
over the same port artifacts (a traced and profiled run with a manifest,
a job service root with its journal and per-job reports); their output
and exit codes must be equal, the ``stats`` exit-3 gate, the doctor's
``--baseline`` gate and its trend history included. Where a line names
the package or its array library (``format_manifest``'s platform line,
the doctor's ``lineage`` hint) the comparison reads the two names as one.
``watch --once --json`` runs against an in-process port Coordinator and
JobService, and a subprocess shows that no analysis command loads torch
or jax.
"""

import asyncio
import json
import pathlib
import re
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from mapreduce_rust_tpu.__main__ import main as jax_cli_main
from mapreduce_rust_tpu_torch.__main__ import main as cli_main
from mapreduce_rust_tpu_torch.config import Config
from mapreduce_rust_tpu_torch.coordinator.server import Coordinator, CoordinatorClient
from mapreduce_rust_tpu_torch.runtime.driver import run_job
from mapreduce_rust_tpu_torch.service.server import JobService
from mapreduce_rust_tpu_torch.worker.runtime import ServiceWorker

REPO = pathlib.Path(__file__).resolve().parents[1]
FAST = dict(lease_timeout_s=2.0, lease_check_period_s=0.2, lease_renew_period_s=0.2,
            poll_retry_s=0.05)


def _corpus(seed: int, n_words: int, vocab_size: int) -> bytes:
    rng = np.random.default_rng(seed)
    vocab = [b"w%d" % i for i in range(vocab_size)] + ["Ωmega".encode(), b"end."]
    ws = rng.integers(0, len(vocab), n_words)
    return b" ".join(vocab[w] for w in ws.tolist()) + b"\n"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    for i, (n, v) in enumerate([(12_000, 3000), (6_000, 200), (4_000, 30)]):
        (d / f"doc-{i}.txt").write_bytes(_corpus(70 + i, n, v))
    return d


@pytest.fixture(scope="module")
def art(corpus, tmp_path_factory):
    """Port artifacts: a traced, profiled, lineage-recording device-engine
    run (manifest ``m``, trace ``t``), a host-engine run's manifest ``h``,
    ``m`` with its throughput halved (``bad``) and a bench history with a
    sustained decline (``drift``) and without (``flat``)."""
    root = tmp_path_factory.mktemp("art")
    common = dict(device="cpu", reduce_n=3, input_dir=str(corpus), chunk_bytes=1 << 15,
                  merge_capacity=1 << 14)
    run_job(Config(output_dir=str(root / "o1"), work_dir=str(root / "w1"),
                   trace_path=str(root / "t.json"), manifest_path=str(root / "m.json"),
                   profile=True, lineage=True, **common))
    run_job(Config(output_dir=str(root / "o2"), work_dir=str(root / "w2"),
                   manifest_path=str(root / "h.json"), map_engine="host",
                   host_map_workers=2, fold_shards=2, **common))
    m = json.loads((root / "m.json").read_text())
    m["stats"]["gb_per_s"] *= 0.5
    m["stats"]["wall_seconds"] *= 2.0
    (root / "bad.json").write_text(json.dumps(m))
    rows = [{"value": 1.0 - 0.06 * i, "zipf_gbs": 2.0, "merge_fill_frac": 0.5}
            for i in range(8)]
    (root / "drift.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
    (root / "flat.jsonl").write_text("".join(
        json.dumps({"value": 1.0 + 0.01 * (i % 2)}) + "\n" for i in range(8)))
    return root


async def _drive_service(svc, workers, specs):
    serve = asyncio.create_task(svc.serve())
    await asyncio.sleep(0.1)
    client = CoordinatorClient(svc.cfg.host, svc.cfg.port, timeout_s=15.0)
    await client.connect()
    jids = [(await client.call("submit_job", spec))["job"] for spec in specs]
    tasks = [asyncio.create_task(w.run()) for w in workers]
    deadline = time.monotonic() + 60
    while True:
        states = {j["job"]: j["state"] for j in (await client.call("list_jobs"))["jobs"]}
        if all(states.get(j) == "done" for j in jids):
            break
        assert time.monotonic() < deadline, states
        await asyncio.sleep(0.05)
    await client.call("shutdown")
    await client.close()
    await asyncio.wait_for(asyncio.gather(*tasks), timeout=30)
    await asyncio.wait_for(serve, timeout=30)
    return jids


@pytest.fixture(scope="module")
def service_root(corpus, tmp_path_factory):
    """A port job service root: two jobs run by two host-engine port
    service workers. Returns (work root, job ids)."""
    root = tmp_path_factory.mktemp("svc")
    fields = dict(device="cpu", map_n=1, reduce_n=2, worker_n=1, port=free_port(),
                  input_dir=str(root / "idle"), work_dir=str(root / "work"),
                  output_dir=str(root / "out"), chunk_bytes=1 << 14, **FAST)
    svc = JobService(Config(**fields))
    workers = [ServiceWorker(Config(**fields), engine="host") for _ in range(2)]
    specs = [{"app": "word_count", "input_dir": str(corpus), "reduce_n": 2},
             {"app": "inverted_index", "input_dir": str(corpus), "reduce_n": 3}]
    jids = asyncio.run(_drive_service(svc, workers, specs))
    return root / "work", jids


def _same_names(text: str) -> str:
    """Read the two packages' names as one."""
    text = text.replace("mapreduce_rust_tpu_torch", "mapreduce_rust_tpu")
    return re.sub(r"\b(torch|jax)=\S+", "BACKEND", text)


def both(args: list, capsys, normalize=lambda s: s) -> tuple:
    rcs, outs = [], []
    for main in (cli_main, jax_cli_main):
        rcs.append(main(list(args)))
        outs.append(normalize(capsys.readouterr().out))
    assert rcs[0] == rcs[1], (args, rcs)
    assert outs[0] == outs[1], args
    assert outs[0].strip(), args
    return rcs[0], outs[0]


@pytest.mark.parametrize("pair", [
    ["m"], ["h"], ["m", "h", "--no-gate"], ["m", "h"], ["m", "bad"], ["m", "bad", "--no-gate"],
    ["m", "bad", "--threshold-scale", "10"], ["bad", "m"]])
def test_stats_matches_reference(art, capsys, pair):
    args = ["stats"] + [str(art / f"{p}.json") if p in ("m", "h", "bad") else p
                        for p in pair]
    rc, out = both(args, capsys, _same_names)
    if pair[:2] == ["m", "bad"] and len(pair) == 2:
        assert rc == 3 and "REGRESSIONS" in out
    elif "--no-gate" in pair or len(pair) == 1:
        assert rc == 0


@pytest.mark.parametrize("form", ["text", "json", "trace", "report", "baseline", "bad",
                                  "trend-drift", "trend-flat"])
def test_doctor_matches_reference(art, service_root, capsys, form):
    work, jids = service_root
    m = str(art / "m.json")
    args = {
        "text": ["doctor", m],
        "json": ["doctor", m, "--format", "json", "--trace", str(art / "t.json")],
        "trace": ["doctor", m, "--trace", str(art / "t.json")],
        "report": ["doctor", m, "--job-report", str(work / f"job-{jids[0]}" /
                                                     "job_report.json")],
        "baseline": ["doctor", m, "--baseline", m],
        "bad": ["doctor", str(art / "bad.json"), "--baseline", m],
        "trend-drift": ["doctor", "trend", str(art / "drift.jsonl"), "--window", "8"],
        "trend-flat": ["doctor", "trend", str(art / "flat.jsonl")],
    }[form]
    rc, out = both(args, capsys, _same_names)
    assert rc == {"bad": 1, "trend-drift": 1}.get(form, 0), out
    if form == "trend-drift":
        assert "SUSTAINED DRIFT" in out


def test_doctor_unreadable_inputs_match_reference(art, tmp_path, capsys):
    for args in (["doctor", str(tmp_path / "missing.json")], ["doctor"],
                 ["doctor", "trend", str(tmp_path / "none.jsonl")]):
        rc, _out = both(args, capsys)
        assert rc == 2


def test_trace_merge_matches_reference(art, tmp_path, capsys):
    out = tmp_path / "merged.json"
    got = []
    for main in (cli_main, jax_cli_main):
        assert main(["trace", "merge", str(out), str(art / "t.json")]) == 0
        got.append((capsys.readouterr().out, out.read_bytes()))
    assert got[0] == got[1] and b"traceEvents" in got[0][1]
    pf = tmp_path / "merged.pftrace"
    got = []
    for main in (cli_main, jax_cli_main):
        assert main(["trace", "merge", "--format", "perfetto", str(pf),
                     str(art / "t.json")]) == 0
        got.append((capsys.readouterr().out, pf.read_bytes()))
    assert got[0] == got[1]
    for main in (cli_main, jax_cli_main):
        assert main(["trace", "merge", str(out), str(tmp_path / "none.json")]) == 1


@pytest.mark.parametrize("form", [[], ["--format", "json"], ["-v"]])
def test_fleet_matches_reference_over_a_port_service_root(service_root, capsys, form):
    work, jids = service_root
    _rc, out = both(["fleet", str(work)] + form, capsys)
    if form:
        if form[0] == "--format":
            doc = json.loads(out)
            assert set(doc["jobs"]) == set(jids)
            utils = [doc["fleet"]["util_frac"]] + [
                w["util_frac"] for w in doc["workers"].values()]
            assert all(0.0 <= u <= 1.0 for u in utils), utils
    # A single job's work dir is a fleet target too.
    both(["fleet", str(work / f"job-{jids[1]}")] + form, capsys)


class _Served:
    """A port server's ``serve()`` on an event loop of its own thread."""

    def __init__(self, server) -> None:
        self.server = server
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        asyncio.set_event_loop(self.loop)
        self.task = self.loop.create_task(self.server.serve())
        try:
            self.loop.run_until_complete(self.task)
        except asyncio.CancelledError:
            pass
        finally:
            self.loop.close()

    def call(self, method, *args):
        async def go():
            client = CoordinatorClient("127.0.0.1", self.server.cfg.port, timeout_s=10.0)
            await client.connect(retries=50, delay=0.05)
            try:
                return await client.call(method, *args)
            finally:
                await client.close()

        return asyncio.run(go())

    def stop(self) -> None:
        self.loop.call_soon_threadsafe(self.task.cancel)
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


def _watch(port: int, capsys, *extra) -> dict:
    rc = cli_main(["watch", "--once", "--json", "--port", str(port),
                   "--connect-retries", "50", *extra])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(out) == 1, out
    return json.loads(out[0])


def test_watch_and_live_doctor_against_port_servers(corpus, tmp_path, capsys):
    port = free_port()
    coord = _Served(Coordinator(Config(device="cpu", map_n=3, reduce_n=2, port=port,
                                       input_dir=str(corpus), work_dir=str(tmp_path / "c"),
                                       output_dir=str(tmp_path / "co"), **FAST)))
    try:
        row = _watch(port, capsys)
        assert row["stats"]["progress"]["phases"]["map"]["tasks_total"] == 3
        assert not row["stats"]["progress"]["done"]
        assert set(_watch(port, capsys, "--doctor")) == {"t", "stats", "metrics"}
        assert cli_main(["doctor", "--live", f"127.0.0.1:{port}", "--once"]) == 0
        assert "doctor[live]" in capsys.readouterr().out
    finally:
        coord.stop()

    port = free_port()
    svc = _Served(JobService(Config(device="cpu", port=port, work_dir=str(tmp_path / "s"),
                                    output_dir=str(tmp_path / "so"), **FAST)))
    try:
        jid = svc.call("submit_job", {"app": "word_count", "input_dir": str(corpus),
                                      "reduce_n": 2})["job"]
        row = _watch(port, capsys)
        assert [j["job"] for j in row["stats"]["jobs"]] == [jid]
        assert "service" in row["stats"]
        row = _watch(port, capsys, "--job", jid)
        assert row["stats"]["job"] == jid and row["stats"]["state"] == "running"
        assert cli_main(["doctor", "--live", f"127.0.0.1:{port}", "--job", jid, "--once",
                         "--format", "json"]) == 0
        assert json.loads(capsys.readouterr().out)["stats"]["job"] == jid
    finally:
        svc.stop()
    assert cli_main(["watch", "--once", "--port", str(port), "--connect-retries", "1"]) == 1
    capsys.readouterr()


_TORCH_FREE = """
import sys
from mapreduce_rust_tpu_torch.__main__ import main
art, svc, machine, dead = sys.argv[1:5]
rcs = [
    main(["stats", art + "/m.json"]),
    main(["stats", art + "/m.json", art + "/bad.json"]),
    main(["doctor", art + "/m.json", "--trace", art + "/t.json"]),
    main(["doctor", "trend", art + "/drift.jsonl"]),
    main(["trace", "merge", art + "/merged-sub.json", art + "/t.json"]),
    main(["prof", art + "/h.json", "--roofline", "--machine", machine]),
    main(["lineage", art + "/w1", "--backward", "0"]),
    main(["fleet", svc]),
    main(["watch", "--once", "--port", dead, "--connect-retries", "1"]),
]
print("RCS", rcs)
print("TORCH", "torch" in sys.modules, "JAX", "jax" in sys.modules)
"""


def test_analysis_commands_never_import_torch(art, service_root, tmp_path):
    r = subprocess.run(
        [sys.executable, "-c", _TORCH_FREE, str(art), str(service_root[0]),
         str(tmp_path / "machine.json"), str(free_port())],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert "RCS [0, 3, 0, 1, 0, 0, 0, 0, 1]" in r.stdout, r.stdout
    assert "TORCH False JAX False" in r.stdout
    assert json.loads((tmp_path / "machine.json").read_text())["devices"] == []

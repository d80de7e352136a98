"""The port's run_job, CLI and entry-point rules against the JAX package.

Both packages run the same Config fields on the same seeded corpus (about
1 MB: ASCII words, punctuation, café/naïve/Ωmega, curly quotes, tabs and
CRLF) on the CPU; their ``mr-{r}.txt`` files must be byte-identical and
their exactness counters equal. The reference results are computed once
per module (its XLA compiles dominate this file's time).
"""

import dataclasses
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from mapreduce_rust_tpu.config import Config as JaxConfig
from mapreduce_rust_tpu.runtime.driver import merge_outputs as jax_merge_outputs
from mapreduce_rust_tpu.runtime.driver import run_job as jax_run_job
from mapreduce_rust_tpu_torch.__main__ import main as cli_main
from mapreduce_rust_tpu_torch.config import Config
from mapreduce_rust_tpu_torch.core.normalize import reference_word_counts
from mapreduce_rust_tpu_torch.ops.tokenize_cuda import hash_scan, tokenize_hash
from mapreduce_rust_tpu_torch.runtime import driver
from mapreduce_rust_tpu_torch.runtime.chunker import chunk_stream
from mapreduce_rust_tpu_torch.runtime.driver import merge_outputs, run_job

REPO = pathlib.Path(__file__).resolve().parents[1]

#: Config fields both packages run with. "parity" takes the default
#: partial capacity (spills, no replays); "spill_replay" shrinks both
#: capacities, so dense chunks replay and the state evicts.
CONFIGS = {
    "parity": dict(chunk_bytes=1 << 16, merge_capacity=1 << 14),
    "spill_replay": dict(chunk_bytes=1 << 16, merge_capacity=1 << 12,
                         partial_capacity=1 << 10),
}


def _corpus(seed: int, n_words: int, vocab_size: int) -> bytes:
    rng = np.random.default_rng(seed)
    vocab = [b"w%d" % i for i in range(vocab_size)] + [
        "café".encode(), "naïve".encode(), "Ωmega".encode(), "don’t".encode(),
        "“quoted”".encode(), b"it's", b"x,y", b"--", b"end."]
    seps = [b" ", b" ", b"\t", b"\r\n", b"\n", b"  ", " ".encode()]
    ws = rng.integers(0, len(vocab), n_words)
    ss = rng.integers(0, len(seps), n_words)
    return b"".join(vocab[w] + seps[s] for w, s in zip(ws.tolist(), ss.tolist()))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two files: a high-cardinality one (every dense chunk overflows the
    small partial capacity) and a low-cardinality one (its chunks do not)."""
    d = tmp_path_factory.mktemp("corpus")
    (d / "a.txt").write_bytes(_corpus(1, 90_000, 20_000))
    (d / "b.txt").write_bytes(_corpus(2, 70_000, 300))
    return d


@pytest.fixture(scope="module")
def reference(corpus, tmp_path_factory):
    """(config name, reduce_n) → the JAX package's result, computed lazily."""
    cache = {}

    def get(name: str, reduce_n: int):
        if (name, reduce_n) not in cache:
            out = tmp_path_factory.mktemp(f"ref-{name}-{reduce_n}")
            cfg = JaxConfig(device="cpu", reduce_n=reduce_n, input_dir=str(corpus),
                            output_dir=str(out / "out"), work_dir=str(out / "work"),
                            **CONFIGS[name])
            cache[name, reduce_n] = jax_run_job(cfg)
        return cache[name, reduce_n]

    return get


def port_config(corpus, out, name: str, reduce_n: int) -> Config:
    return Config(device="cpu", reduce_n=reduce_n, input_dir=str(corpus),
                  output_dir=str(out / "out"), work_dir=str(out / "work"),
                  **CONFIGS[name])


def assert_same_files(want, got):
    assert [os.path.basename(p) for p in want] == [os.path.basename(p) for p in got]
    for w, g in zip(want, got):
        assert pathlib.Path(w).read_bytes() == pathlib.Path(g).read_bytes(), g


@pytest.mark.parametrize("reduce_n", [1, 4])
def test_output_parity(corpus, reference, tmp_path, reduce_n, monkeypatch):
    ref = reference("parity", reduce_n)
    scanned = []
    real_scan = driver.scan_unique_raw

    def spy(payload):
        scanned.append(len(payload))
        return real_scan(payload)

    # The dictionary scan is the native one, once per chunk.
    monkeypatch.setattr(driver, "scan_unique_raw", spy)
    before = hash_scan.launches, tokenize_hash.launches
    res = run_job(port_config(corpus, tmp_path, "parity", reduce_n))
    # The CPU path never launches the kernel, and runs the step op by op.
    assert (hash_scan.launches, tokenize_hash.launches) == before
    assert res.stats.step_graph_replays == res.stats.step_graph_captures == 0
    assert len(scanned) == res.stats.chunks == ref.stats.chunks
    assert_same_files(ref.output_files, res.output_files)
    assert res.stats.distinct_keys == ref.stats.distinct_keys
    assert res.stats.dictionary_words == ref.stats.dictionary_words
    assert res.stats.hash_collisions == ref.stats.hash_collisions == 0
    assert res.stats.unknown_keys == ref.stats.unknown_keys == 0
    assert res.stats.spilled_keys == ref.stats.spilled_keys
    assert res.stats.partial_overflow_replays == ref.stats.partial_overflow_replays == 0
    assert res.table == ref.table
    # ...and the reference semantics of the whole corpus.
    want = {}
    for path in sorted(corpus.glob("*.txt")):
        for w, c in reference_word_counts(path.read_bytes()).items():
            want[w.encode()] = want.get(w.encode(), 0) + c
    assert res.table == want


def test_spill_and_replay_parity(corpus, reference, tmp_path):
    ref = reference("spill_replay", 4)
    res = run_job(port_config(corpus, tmp_path, "spill_replay", 4))
    assert_same_files(ref.output_files, res.output_files)
    s, r = res.stats, ref.stats
    assert s.spilled_keys > 0 and s.partial_overflow_replays > 0
    assert s.partial_overflow_replays < s.chunks  # some chunks took the fast path
    for field in ("spilled_keys", "spill_events", "partial_overflow_replays",
                  "distinct_keys", "dictionary_words", "chunks", "bytes_in"):
        assert getattr(s, field) == getattr(r, field), field
    assert s.unknown_keys == r.unknown_keys == 0


def test_cli_run_and_merge(corpus, reference, tmp_path):
    ref = reference("parity", 4)
    out = tmp_path / "out"
    r = subprocess.run(
        [sys.executable, "-m", "mapreduce_rust_tpu_torch", "run", "--device", "cpu",
         "--input", str(corpus), "--output", str(out), "--work", str(tmp_path / "work"),
         "--reduce-n", "4", "--chunk-mb", "0.0625"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "outputs:" in r.stdout and "unknown=0" in r.stdout
    assert_same_files(ref.output_files, sorted(str(p) for p in out.glob("mr-*.txt")))
    assert cli_main(["merge", "--output", str(out)]) == 0
    jax_merge_outputs(ref.output_files, str(tmp_path / "want.txt"))
    assert (out / "final.txt").read_bytes() == (tmp_path / "want.txt").read_bytes()
    merge_outputs(sorted(str(p) for p in out.glob("mr-*.txt")), str(tmp_path / "got.txt"))
    assert (tmp_path / "got.txt").read_bytes() == (tmp_path / "want.txt").read_bytes()


def test_word_count_exact_at_torch_default_threads(tmp_path):
    # The repository's conftest.py runs torch at one OpenMP thread in every
    # test process; this run takes torch's default team of threads, on a
    # smaller corpus of the same two kinds (torch's thread team makes the
    # CPU path several times slower on small chunks).
    corpus = tmp_path / "in"
    corpus.mkdir()
    (corpus / "a.txt").write_bytes(_corpus(3, 30_000, 6_000))
    (corpus / "b.txt").write_bytes(_corpus(4, 20_000, 300))
    out = tmp_path / "out"
    env = {k: v for k, v in os.environ.items() if k != "OMP_NUM_THREADS"}
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch; from mapreduce_rust_tpu_torch.__main__ import main; "
         "print('threads', torch.get_num_threads()); sys.exit(main(sys.argv[1:]))",
         "run", "--device", "cpu", "--input", str(corpus), "--output", str(out),
         "--work", str(tmp_path / "work"), "--reduce-n", "4", "--chunk-mb", "0.0625"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env={**env, "PYTHONPATH": str(REPO)},
    )
    assert r.returncode == 0, r.stderr[-2000:]
    threads = int(r.stdout.split("threads ", 1)[1].split()[0])
    assert threads > 1 or (os.cpu_count() or 1) < 4, r.stdout
    got = {}
    for path in out.glob("mr-*.txt"):
        for line in path.read_text(encoding="utf-8").splitlines():
            word, count = line.rsplit(" ", 1)
            assert word not in got, word
            got[word] = int(count)
    want = {}
    for path in sorted(corpus.glob("*.txt")):
        for w, c in reference_word_counts(path.read_bytes()).items():
            want[w] = want.get(w, 0) + c
    assert got == want


@pytest.mark.parametrize("window", [None, 1 << 12])
def test_chunk_stream_matches_reference(corpus, window):
    import io

    from mapreduce_rust_tpu.runtime.chunker import chunk_stream as jax_chunk_stream

    # A whitespace-free 40 KiB token of 2-byte UTF-8 letters forces cuts,
    # inside a window too, beside ordinary text with curly quotes.
    long_token = "é".encode() * (20 << 10)
    docs = [(corpus / "a.txt").read_bytes()[:100_000],
            b"head " + long_token + " “tail” end\n".encode()]
    for raw in docs:
        want = list(jax_chunk_stream(io.BytesIO(raw), 0, 1 << 14, window_bytes=window))
        got = list(chunk_stream(io.BytesIO(raw), 0, 1 << 14, window_bytes=window))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert (g.seq, g.nbytes, g.forced_cut) == (w.seq, w.nbytes, w.forced_cut)
            assert np.array_equal(g.data, w.data)
    assert any(c.forced_cut for c in got)


_GATE = """
import sys
import __graft_entry_torch__
import bench_torch
import mapreduce_rust_tpu_torch.__main__
import mapreduce_rust_tpu_torch.apps.grep
import mapreduce_rust_tpu_torch.apps.inverted_index
import mapreduce_rust_tpu_torch.apps.join
import mapreduce_rust_tpu_torch.apps.sort
import mapreduce_rust_tpu_torch.apps.top_k
import mapreduce_rust_tpu_torch.ops.partition
import mapreduce_rust_tpu_torch.runtime.splitter
from mapreduce_rust_tpu_torch.apps import get_app
from mapreduce_rust_tpu_torch.config import Config
from mapreduce_rust_tpu_torch.runtime.driver import run_job
for engine in ("device", "host"):
    res = run_job(Config(device="cpu", chunk_bytes=4096, input_dir=sys.argv[1],
                         output_dir=sys.argv[2], work_dir=sys.argv[2],
                         map_engine=engine, fold_shards=2))
    assert res.table == {b"hello": 3, b"world": 1, "café".encode(): 1}, res.table
    res = run_job(Config(device="cpu", chunk_bytes=4096, input_dir=sys.argv[1],
                         output_dir=sys.argv[2], work_dir=sys.argv[2],
                         map_engine=engine, host_accum_budget_mb=0,
                         dictionary_budget_words=1))
    assert res.stats.accum_spill_runs > 0 and res.stats.dict_spill_runs > 0
    lines = b"".join(open(p, "rb").read() for p in res.output_files).splitlines()
    assert sorted(lines) == ["café 1".encode(), b"hello 3", b"world 1"], lines
    res = run_job(Config(device="cpu", chunk_bytes=4096, input_dir=sys.argv[1],
                         output_dir=sys.argv[2], work_dir=sys.argv[2],
                         map_engine=engine), app=get_app("inverted_index"))
    assert res.table == {b"hello": [0, 1], b"world": [0], "café".encode(): [0]}, res.table
    res = run_job(Config(device="cpu", chunk_bytes=4096, input_dir=sys.argv[1],
                         output_dir=sys.argv[2], work_dir=sys.argv[2], reduce_n=2,
                         map_engine=engine), app=get_app("sort"))
    lines = b"".join(open(p, "rb").read() for p in res.output_files).split()
    assert lines == sorted([b"hello"] * 3 + [b"world", "café".encode()]), lines
    # The profiling and provenance plane: the sampling profiler, a device
    # trace and the lineage ledger, with a manifest the analysis tools read.
    res = run_job(Config(device="cpu", chunk_bytes=4096, input_dir=sys.argv[1],
                         output_dir=sys.argv[2], work_dir=sys.argv[2] + "/pw",
                         map_engine=engine, profile=True, lineage=True,
                         profile_dir=sys.argv[2] + "/tp",
                         manifest_path=sys.argv[2] + "/pm.json"))
    assert res.table == {b"hello": 3, b"world": 1, "café".encode(): 1}, res.table
import mapreduce_rust_tpu_torch.analysis.lineage
import mapreduce_rust_tpu_torch.analysis.roofline
import mapreduce_rust_tpu_torch.runtime.fleet
import mapreduce_rust_tpu_torch.runtime.prof
from mapreduce_rust_tpu_torch.__main__ import main as cli_main
assert cli_main(["prof", sys.argv[2] + "/pm.json", "--roofline", "--machine",
                 sys.argv[2] + "/machine.json"]) == 0
assert cli_main(["lineage", sys.argv[2] + "/pw", "--forward", "0"]) == 0
# mrlint over the port's tree: clean, and torch-free like the other tools.
assert cli_main(["lint"]) == 0
# The task path and the observability core: a one-worker cluster on the
# device engine, traced, with a manifest.
import asyncio
import socket
import mapreduce_rust_tpu_torch.analysis.doctor
import mapreduce_rust_tpu_torch.runtime.perfetto
from mapreduce_rust_tpu_torch.coordinator.server import Coordinator
from mapreduce_rust_tpu_torch.worker.runtime import Worker
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
cfg = Config(device="cpu", chunk_bytes=4096, input_dir=sys.argv[1], map_n=2,
             reduce_n=2, worker_n=1, port=port, work_dir=sys.argv[2] + "/cw",
             output_dir=sys.argv[2] + "/co", poll_retry_s=0.05,
             trace_path=sys.argv[2] + "/t.json", manifest_path=sys.argv[2] + "/m.json")
async def cluster():
    serve = asyncio.create_task(Coordinator(cfg).serve())
    await asyncio.sleep(0.1)
    await asyncio.wait_for(Worker(cfg, engine="device").run(), 60)
    await asyncio.wait_for(serve, 30)
asyncio.run(cluster())
lines = b"".join(open(f"{sys.argv[2]}/co/mr-{r}.txt", "rb").read() for r in range(2))
assert sorted(lines.splitlines()) == ["café 1".encode(), b"hello 3", b"world 1"], lines
# The job service: one job through a one-worker service on the device engine.
from mapreduce_rust_tpu_torch.coordinator.server import CoordinatorClient
from mapreduce_rust_tpu_torch.service.server import JobService
from mapreduce_rust_tpu_torch.worker.runtime import ServiceWorker
scfg = Config(device="cpu", chunk_bytes=4096, port=port, work_dir=sys.argv[2] + "/sw",
              output_dir=sys.argv[2] + "/so", poll_retry_s=0.05)
async def service():
    serve = asyncio.create_task(JobService(scfg).serve())
    await asyncio.sleep(0.1)
    client = CoordinatorClient(scfg.host, scfg.port)
    await client.connect()
    job = await client.call("submit_job", {"app": "word_count", "input_dir": sys.argv[1],
                                           "reduce_n": 2})
    worker = asyncio.create_task(ServiceWorker(scfg).run())
    while (await client.call("job_status", job["job"]))["state"] != "done":
        await asyncio.sleep(0.05)
    await client.call("shutdown")
    await client.close()
    await asyncio.wait_for(worker, 60)
    await asyncio.wait_for(serve, 30)
    return job["job"]
jid = asyncio.run(service())
lines = b"".join(open(f"{sys.argv[2]}/so/job-{jid}/mr-{r}.txt", "rb").read() for r in range(2))
assert sorted(lines.splitlines()) == ["café 1".encode(), b"hello 3", b"world 1"], lines
# The single-process mesh: chunked with a checkpoint, then sequence-parallel.
for kw in (dict(checkpoint_every_groups=1), dict(sharded_stream=True)):
    res = run_job(Config(device="cpu", chunk_bytes=4096, input_dir=sys.argv[1],
                         output_dir=sys.argv[2] + "/mo", work_dir=sys.argv[2] + "/mw",
                         mesh_shape=2, **kw))
    assert res.table == {b"hello": 3, b"world": 1, "café".encode(): 1}, res.table
    assert res.stats.mesh_rounds > 0
import mapreduce_rust_tpu_torch.parallel.topk
# The multi-process mesh's bootstrap (a one-rank gloo group: the rounds'
# all_reduce and the all_to_all across processes) and the control-plane
# checkers over the cluster's artifacts.
import torch
from mapreduce_rust_tpu_torch.analysis.mrcheck import run_check
from mapreduce_rust_tpu_torch.analysis.mrmodel import run_model
from mapreduce_rust_tpu_torch.parallel import distributed
from mapreduce_rust_tpu_torch.parallel.shuffle import make_mesh, make_mh_shuffle_step_fns
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    gport = s.getsockname()[1]
distributed.initialize(f"127.0.0.1:{gport}", 1, 0, device="cpu")
assert distributed.cluster_info(2)["local_devices"] == 2
mesh = make_mesh(2, "cpu", world=1, rank=0)
chunk = torch.tensor(list(b"hello world hello"), dtype=torch.uint8)
local, totals = make_mh_shuffle_step_fns(get_app("word_count"), 64, 64, mesh)[0](
    [chunk, chunk], [0, 0], 1)
assert totals.tolist() == [1, 0, 0] and sum(int(x.valid.sum()) for x in local) == 2
distributed.shutdown()
assert run_check(sys.argv[2] + "/cw")["ok"]
fn, args = __graft_entry_torch__.entry("cpu")
assert int(fn(*args)[0].valid.sum()) == 8
assert bench_torch._zipf_cfg("w", "o", 8).map_engine == "device"
assert run_model(focus="lease", budget=20, depth=6)["ok"]
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "mapreduce_rust_tpu" or m.startswith("mapreduce_rust_tpu."))
print("LOADED", bad)
sys.exit(3 if bad else 0)
"""


def test_port_is_jax_free(tmp_path):
    (tmp_path / "in").mkdir()
    (tmp_path / "in" / "a.txt").write_bytes("hello world hello café\n".encode())
    (tmp_path / "in" / "b.txt").write_bytes(b"hello\n")
    r = subprocess.run(
        [sys.executable, "-c", _GATE, str(tmp_path / "in"), str(tmp_path / "out")],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"},
    )
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    assert "LOADED []" in r.stdout


@pytest.mark.parametrize(
    "app", ["word_count", "inverted_index", "grep", "join", "top_k", "sort"])
def test_no_cpu_fallback(tmp_path, monkeypatch, app):
    from mapreduce_rust_tpu_torch.apps import get_app

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "a.txt").write_bytes(b"hello\n")
    kw = {"grep": {"query": ("hello",)}}.get(app, {})
    dirs = (("a", str(tmp_path)), ("b", str(tmp_path))) if app == "join" else None
    for device in ("cuda", "auto"):
        cfg = Config(device=device, input_dir=str(tmp_path), input_dirs=dirs,
                     output_dir=str(tmp_path / "out"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_job(cfg, app=get_app(app, **kw))
    assert not (tmp_path / "out").exists()
    assert Config().device == "cuda"


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, where):
    script = REPO / "chip_smoke.py"
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    else:
        cwd = REPO
    r = subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True, timeout=120,
        cwd=cwd, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
                      "HOME": str(tmp_path)},
    )
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize(
    "field", ["checkpoint_every_groups", "mesh_shape", "resume", "sharded_stream"])
def test_config_rejects_unported_fields(field):
    # The mesh's four fields, once refused, are ported: each is accepted
    # with the reference's meaning, and so is the multi-process barrier's
    # timeout; only the XLA compile cache has no field. The halo keeps its
    # validation.
    value = {"mesh_shape": 2, "checkpoint_every_groups": 1}.get(field, True)
    assert getattr(Config(**{field: value}), field) == \
        getattr(JaxConfig(**{field: value}), field) == value
    with pytest.raises(TypeError, match="compilation_cache_dir"):
        Config(compilation_cache_dir=None)
    assert Config(multihost_barrier_timeout_s=5.0).multihost_barrier_timeout_s == \
        JaxConfig(multihost_barrier_timeout_s=5.0).multihost_barrier_timeout_s == 5.0
    for chunk_bytes in (128, 96):
        with pytest.raises(ValueError, match="max_word_len"):
            Config(chunk_bytes=chunk_bytes)
        with pytest.raises(ValueError, match="max_word_len"):
            JaxConfig(chunk_bytes=chunk_bytes)
    assert Config(chunk_bytes=64, max_word_len=31).max_word_len == 31


def test_config_shares_reference_defaults():
    ref, port = JaxConfig(), Config()
    for f in dataclasses.fields(Config):
        if f.name != "device" and hasattr(ref, f.name):
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.effective_partial_capacity() == ref.effective_partial_capacity()

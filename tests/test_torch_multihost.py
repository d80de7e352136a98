"""The port's multi-process mesh against the JAX package's, on the CPU.

Two ranks of two CPU shards each (D = 4): the port's ranks join a gloo
process group, the reference's a ``jax.distributed`` cluster of two
processes with two virtual CPU devices each, and both run the same jobs on
the same seeded corpora — word_count, grep (query words that only one rank
reads), inverted_index (global doc ids), and a word_count whose partial
capacity and bucket slack make both replay tiers fire from one rank's data
only. Each rank's ``mr-{r}.p{rank}.txt`` and ``dict-proc-*`` files must be
byte-identical to the reference rank's (a dictionary shard's 8-byte run
token aside), with equal counters. Each package's cluster runs once per
module, every job in one process group.

Also: one map_shuffle + merge step across the two ranks against the port's
one-process mesh (the twin of tests/test_distributed.py), the CLI's
``run --distributed``, the dictionary barrier, and the guards that refuse
checkpoint, resume, the sharded stream and the spill budgets across
processes.
"""

import collections
import json
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from mapreduce_rust_tpu_torch.config import Config
from mapreduce_rust_tpu_torch.core.normalize import reference_word_counts
from mapreduce_rust_tpu_torch.parallel import distributed
from mapreduce_rust_tpu_torch.parallel.shuffle import (
    make_mesh,
    make_shuffle_step_fns,
    sharded_empty_state,
)
from mapreduce_rust_tpu_torch.apps.word_count import WordCount
from mapreduce_rust_tpu_torch.runtime.driver import _await_shard_files, run_job

REPO = pathlib.Path(__file__).resolve().parents[1]
NPROC = 2
D = 4

#: name → (corpus, app, app kwargs, Config fields). Both packages run each.
JOBS = {
    "wc": ("main", "word_count", {}, {}),
    "grep": ("main", "grep", {"query": ["fox", "jugs", "sphinx", "café", "absent"]}, {}),
    "ii": ("main", "inverted_index", {}, {}),
    "replay": ("replay", "word_count", {},
               {"chunk_bytes": 2048, "partial_capacity": 64,
                "bucket_capacity_factor": 0.5, "merge_capacity": 512}),
}
BASE = {"chunk_bytes": 4096, "merge_capacity": 1 << 14, "reduce_n": 3}
STATS = ("mesh_rounds", "shuffle_wire_bytes", "partial_overflow_replays",
         "bucket_skew_replays", "spill_events", "spilled_keys", "unknown_keys",
         "chunks", "bytes_in", "distinct_keys", "dictionary_words", "hash_collisions")

_HEAD = """
import glob, json, os, sys
pid, nproc, port, base = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
plan = json.load(open(os.path.join(base, "plan.json")))
STATS = plan.pop("_stats")
"""

_RUN = """
for name, (corpus, app_name, app_kw, fields) in plan.items():
    if app_name == "grep":
        app_kw = {"query": tuple(app_kw["query"])}
    inputs = sorted(glob.glob(os.path.join(base, corpus, "*.txt")))
    cfg = Config(device="cpu", mesh_shape=4, work_dir=os.path.join(OUT, name, "work"),
                 output_dir=os.path.join(OUT, name, "out"), **fields)
    res = run_job(cfg, inputs, app=get_app(app_name, **app_kw))
    print("STATS " + json.dumps([name, {f: getattr(res.stats, f) for f in STATS}]),
          flush=True)
"""

_PORT_WORKER = _HEAD + textwrap.dedent("""
    import numpy as np
    import torch
    from mapreduce_rust_tpu_torch.parallel.distributed import (
        cluster_info, initialize, is_federated, shutdown)
    initialize(f"127.0.0.1:{port}", nproc, pid, device="cpu")
    assert is_federated() and cluster_info(4)["local_devices"] == 2
    from mapreduce_rust_tpu_torch.apps import get_app
    from mapreduce_rust_tpu_torch.apps.word_count import WordCount
    from mapreduce_rust_tpu_torch.config import Config
    from mapreduce_rust_tpu_torch.parallel.shuffle import (
        make_mesh, make_mh_shuffle_step_fns, sharded_empty_state)
    from mapreduce_rust_tpu_torch.runtime.driver import run_job
    OUT = os.path.join(base, "port")
    # One map_shuffle + merge step over the global mesh (the twin of
    # tests/test_distributed.py's smoke), saved for the test to compare.
    mesh = make_mesh(4, "cpu", world=nproc, rank=pid)
    fns = make_mh_shuffle_step_fns(WordCount(), 64, 64, mesh)
    state = sharded_empty_state(mesh, 128)
    row = (" ".join(f"w{i:02d}" for i in range(30)) + f" proc{pid}").encode()
    chunk = np.full(256, 0x20, dtype=np.uint8)
    chunk[: len(row)] = np.frombuffer(row, dtype=np.uint8)
    local, totals = fns[0]([torch.from_numpy(chunk.copy()) for _ in range(2)], [0, 0], 1)
    state, _ev, _evc = fns[1](state, local)
    np.savez(os.path.join(base, f"step-{pid}.npz"), totals=totals.numpy(),
             **{f"{lane}{i}": getattr(st, lane).numpy()
                for i, st in enumerate(state) for lane in ("k1", "k2", "value", "valid")})
""") + _RUN + textwrap.dedent("""
    shutdown()
    bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                 or m == "mapreduce_rust_tpu" or m.startswith("mapreduce_rust_tpu."))
    assert not bad, bad
    print(f"OK proc={pid}")
""")

_JAX_WORKER = _HEAD + textwrap.dedent("""
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    from mapreduce_rust_tpu.parallel.distributed import initialize, is_federated
    initialize(f"127.0.0.1:{port}", num_processes=nproc, process_id=pid,
               heartbeat_timeout_seconds=600)
    import jax
    if not is_federated():
        print(f"NOT_FEDERATED global={jax.device_count()}")
        sys.exit(3)
    # Global shard g belongs to process g // 2 in both packages.
    assert [d.process_index for d in jax.devices()] == [0, 0, 1, 1]
    from mapreduce_rust_tpu.apps import get_app
    from mapreduce_rust_tpu.config import Config
    from mapreduce_rust_tpu.runtime.driver import run_job
    OUT = os.path.join(base, "jax")
""") + _RUN + 'print(f"OK proc={pid}")\n'


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def _words(rng, vocab, n: int) -> bytes:
    seps = [b" ", b" ", b"\n", b"\t", b"  ", b"\r\n"]
    ws = rng.integers(0, len(vocab), n).tolist()
    ss = rng.integers(0, len(seps), n).tolist()
    return b"".join(vocab[w] + seps[s] for w, s in zip(ws, ss))


def _write_corpora(base: pathlib.Path) -> None:
    rng = np.random.default_rng(20261018)
    main, replay = base / "main", base / "replay"
    main.mkdir()
    replay.mkdir()
    # doc i goes to rank i % 2: "fox" only in doc 0, "jugs" only in doc 1.
    uni = [w.encode() for w in ("café", "naïve", "Ωmega", "don’t", "x,y", "end.")]
    (main / "doc-0.txt").write_bytes(
        _words(rng, [b"w%d" % i for i in range(3000)] + [b"fox", b"sphinx"], 9000))
    (main / "doc-1.txt").write_bytes(
        _words(rng, [b"v%d" % i for i in range(200)] + [b"jugs", b"sphinx"] + uni, 7000))
    (main / "doc-2.txt").write_bytes(_words(rng, [b"w%d" % i for i in range(50)] + uni, 5000))
    # Rank 0's document overflows a 64-key partial capacity (thousands of
    # distinct words) and then 8-record buckets (40 words); rank 1's holds
    # six words, which fit both.
    (replay / "doc-0.txt").write_bytes(
        _words(rng, [b"k%05d" % i for i in range(3000)], 3000)
        + _words(rng, [b"q%d" % i for i in range(40)], 6000))
    (replay / "doc-1.txt").write_bytes(_words(rng, [b"z%d" % i for i in range(6)], 4000))


def _launch(base: pathlib.Path, script: str, env: dict) -> list:
    port = _free_port()
    return [
        subprocess.Popen(
            [sys.executable, "-c", script, str(pid), str(NPROC), port, str(base)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=str(REPO), env=env,
        )
        for pid in range(NPROC)
    ]


def _collect(procs: list, what: str, timeout: float) -> list:
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail(f"{what} cluster timed out")
        outs.append((p.returncode, out, err))
    if what == "jax" and any(rc == 3 for rc, _o, _e in outs):
        pytest.skip("jax.distributed cannot federate CPU backends here")
    for rc, out, err in outs:
        assert rc == 0 and "OK proc=" in out, (what, rc, out[-1000:], err[-3000:])
    stats = []
    for _rc, out, _err in outs:
        rows = [json.loads(ln[6:]) for ln in out.splitlines() if ln.startswith("STATS ")]
        stats.append(dict(rows))
    return stats


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """Both packages' two-rank clusters over the same corpora, started
    together: {"base", "port": per-rank stats, "jax": per-rank stats}."""
    base = tmp_path_factory.mktemp("mh")
    _write_corpora(base)
    plan = {name: list(job) for name, job in JOBS.items()}
    for job in plan.values():
        job[3] = {**BASE, **job[3]}
    (base / "plan.json").write_text(json.dumps({**plan, "_stats": STATS}))
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    jax_procs = _launch(base, _JAX_WORKER, env)
    port_procs = _launch(base, _PORT_WORKER, env)
    port = _collect(port_procs, "port", 240)
    jax = _collect(jax_procs, "jax", 240)
    return {"base": base, "port": port, "jax": jax}


def _files(d: pathlib.Path, pattern: str) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.glob(pattern))}


def _unstamped(data: bytes) -> bytes:
    """A dictionary file's bytes with its 8-byte run token zeroed."""
    b = bytearray(data)
    b[8:16] = bytes(8)
    return bytes(b)


@pytest.mark.parametrize("job", sorted(JOBS))
def test_ranks_match_reference(clusters, job):
    base = clusters["base"]
    port, ref = base / "port" / job, base / "jax" / job
    got = _files(port / "out", "mr-*.txt")
    assert sorted(got) == [f"mr-{r}.p{p}.txt" for r in range(3) for p in range(NPROC)]
    assert got == _files(ref / "out", "mr-*.txt")
    shards = _files(port / "work", "dict-proc-*")
    want = _files(ref / "work", "dict-proc-*")
    assert sorted(shards) == sorted(want) and len(shards) == 2 * NPROC
    assert {k: _unstamped(v) for k, v in shards.items()} == \
        {k: _unstamped(v) for k, v in want.items()}
    for rank in range(NPROC):
        assert clusters["port"][rank][job] == clusters["jax"][rank][job], (job, rank)
        assert clusters["port"][rank][job]["unknown_keys"] == 0
    # Lockstep: both ranks ran the same rounds, replays included.
    assert clusters["port"][0][job]["mesh_rounds"] == clusters["port"][1][job]["mesh_rounds"]
    # No word in two ranks' files.
    words = [ln.rsplit(b" ", 1)[0] for data in got.values() for ln in data.splitlines()]
    assert len(words) == len(set(words))


def test_word_count_is_exact(clusters):
    base = clusters["base"]
    want = collections.Counter()
    for p in sorted((base / "main").glob("*.txt")):
        want.update(reference_word_counts(p.read_bytes()))
    got = {}
    for data in _files(base / "port" / "wc" / "out", "mr-*.txt").values():
        for ln in data.splitlines():
            w, v = ln.rsplit(b" ", 1)
            got[w.decode()] = int(v)
    assert got == dict(want)


def test_grep_prints_words_only_one_rank_read(clusters):
    got = {}
    for data in _files(clusters["base"] / "port" / "grep" / "out", "mr-*.txt").values():
        for ln in data.splitlines():
            w, v = ln.rsplit(b" ", 1)
            got[w] = v
    assert set(got) == {b"fox", b"jugs", b"sphinx", "café".encode()}
    assert got[b"fox"] == b"0" and got[b"jugs"] == b"1"


def test_replays_fire_from_one_rank(clusters, tmp_path):
    for rank in range(NPROC):
        s = clusters["port"][rank]["replay"]
        assert s["partial_overflow_replays"] > 0 and s["bucket_skew_replays"] > 0
    # Rank 1's document alone, on the one-process mesh: no replay.
    kw = {**BASE, **JOBS["replay"][3]}
    res = run_job(Config(device="cpu", mesh_shape=D, work_dir=str(tmp_path / "w"),
                         output_dir=str(tmp_path / "o"), **kw),
                  [str(clusters["base"] / "replay" / "doc-1.txt")])
    assert res.stats.partial_overflow_replays == res.stats.bucket_skew_replays == 0


def test_one_step_matches_one_process_mesh(clusters):
    # Rank r's chunks were "w00 .. w29 proc{r}" on each of its two shards.
    chunks = []
    for pid in range(NPROC):
        row = (" ".join(f"w{i:02d}" for i in range(30)) + f" proc{pid}").encode()
        chunk = np.full(256, 0x20, dtype=np.uint8)
        chunk[: len(row)] = np.frombuffer(row, dtype=np.uint8)
        chunks += [torch.from_numpy(chunk.copy()) for _ in range(2)]
    mesh = make_mesh(D, "cpu")
    fns = make_shuffle_step_fns(WordCount(), 64, 64, mesh)
    local, p_ovf, b_ovf = fns[0](chunks, [0] * D)
    state, _ev, _evc = fns[1](sharded_empty_state(mesh, 128), local)
    assert int(p_ovf.sum()) == int(b_ovf.sum()) == 0
    for pid in range(NPROC):
        with np.load(clusters["base"] / f"step-{pid}.npz") as z:
            assert z["totals"].tolist() == [NPROC, 0, 0]
            for i in range(2):
                st = state[pid * 2 + i]
                for lane in ("k1", "k2", "value", "valid"):
                    assert np.array_equal(z[f"{lane}{i}"], getattr(st, lane).numpy())
    assert sum(int(st.valid.sum()) for st in state) == 32


def test_cli_distributed(clusters, tmp_path):
    base = clusters["base"]
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "mapreduce_rust_tpu_torch", "run", "--device", "cpu",
             "--distributed", "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", str(NPROC), "--process-id", str(pid), "--mesh", str(D),
             "--input", str(base / "main"), "--output", str(tmp_path / "out"),
             "--work", str(tmp_path / "work"), "--reduce-n", "3",
             "--chunk-mb", str(4096 / (1 << 20)), "--manifest", str(tmp_path / "m.json")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=str(REPO),
            env=env,
        )
        for pid in range(NPROC)
    ]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0 and "unknown=0" in out, (out[-1000:], err[-2000:])
    assert _files(tmp_path / "out", "mr-*.txt") == _files(base / "port" / "wc" / "out",
                                                          "mr-*.txt")
    for pid in range(NPROC):
        m = json.loads((tmp_path / f"m-p{pid}.json").read_text())
        assert m["cluster"] == {
            "process_index": pid, "process_count": NPROC, "global_devices": D,
            "local_devices": D // NPROC, "federated": True}


def test_barrier_names_missing_ranks_and_respects_timeout(tmp_path):
    import time

    def shard_path(p: int) -> str:
        return str(tmp_path / f"dict-proc-{p}.txt")

    for p in (0, 2):  # ranks 0 and 2 published; 1 and 3 never do
        open(shard_path(p), "w").close()
        open(shard_path(p) + ".done", "w").close()
    t0 = time.monotonic()
    with pytest.raises(TimeoutError) as ei:
        _await_shard_files(shard_path, 4, timeout_s=0.3)
    assert time.monotonic() - t0 < 5.0
    assert "[1, 3]" in str(ei.value)
    for p in (1, 3):
        open(shard_path(p), "w").close()
        open(shard_path(p) + ".done", "w").close()
    _await_shard_files(shard_path, 4, timeout_s=0.3)


@pytest.mark.parametrize("fields,match", [
    ({"checkpoint_every_groups": 1}, "single-process"),
    ({"resume": True}, "single-process"),
    ({"sharded_stream": True}, "single-process"),
    ({"host_accum_budget_mb": 1}, "multi-process"),
    ({"dictionary_budget_words": 100}, "multi-process"),
])
def test_multi_process_refuses_single_process_features(tmp_path, monkeypatch,
                                                      fields, match):
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    monkeypatch.setattr(distributed, "process_index", lambda: 0)
    (tmp_path / "a.txt").write_bytes(b"hello world\n")
    cfg = Config(device="cpu", mesh_shape=D, input_dir=str(tmp_path),
                 work_dir=str(tmp_path / "w"), output_dir=str(tmp_path / "o"), **fields)
    with pytest.raises(ValueError, match=match):
        run_job(cfg)
    assert not (tmp_path / "o").exists()


def test_mesh_splits_over_processes():
    mesh = make_mesh(D, "cpu", world=2, rank=1)
    assert (mesh.size, mesh.d_local, len(mesh.local_devices)) == (D, 2, 2)
    assert len(sharded_empty_state(mesh, 16)) == 2
    assert make_mesh(None, "cpu", world=2, rank=0).size == 2
    with pytest.raises(ValueError, match="split evenly"):
        make_mesh(3, "cpu", world=2, rank=0)
    with pytest.raises(ValueError, match="rank 2"):
        make_mesh(D, "cpu", world=2, rank=2)
    assert distributed.default_backend("cpu") == "gloo"
    assert distributed.default_backend("cuda") == "nccl"
    assert distributed.cluster_info() == {
        "process_index": 0, "process_count": 1, "global_devices": 1,
        "local_devices": 1, "federated": False}
    assert Config().multihost_barrier_timeout_s == 120.0
    with pytest.raises(ValueError, match="multihost_barrier_timeout_s"):
        Config(multihost_barrier_timeout_s=0)

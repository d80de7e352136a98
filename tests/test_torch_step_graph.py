"""The device engine's step replayed from a captured CUDA graph against the
same step launched op by op (runtime/step_graph.py).

On the CPU: the slot ring, the checkout of instances, and the graph step's
bookkeeping (static input, state carried in place, the ring of counters
and evicted tails, the pinned staging a replay reads) with a stand-in for
the capture that runs the step eagerly, against the eager step over whole
streams. On a card (marked ``cuda``, skipped without one): the captured
step against the eager step on the same chunks, and whole jobs on both,
byte for byte. This file imports neither jax nor the JAX package, so on
the card's machine it runs without tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_step_graph.py
"""

import dataclasses
import json
import pathlib
import threading

import numpy as np
import pytest
import torch

from mapreduce_rust_tpu_torch.apps import get_app
from mapreduce_rust_tpu_torch.config import Config
from mapreduce_rust_tpu_torch.ops.tokenize_cuda import tokenize_hash
from mapreduce_rust_tpu_torch.runtime import driver, step_graph
from mapreduce_rust_tpu_torch.runtime.chunker import chunk_stream
from mapreduce_rust_tpu_torch.runtime.dictionary import Dictionary
from mapreduce_rust_tpu_torch.runtime.metrics import JobStats
from mapreduce_rust_tpu_torch.runtime.step_graph import (
    EagerStep,
    GraphStep,
    SlotRing,
    checkout,
)

REPO = pathlib.Path(__file__).resolve().parents[1]


# ---- the slot ring and the checkout (CPU) ----

def test_slot_ring_never_hands_out_a_slot_in_flight():
    ring = SlotRing(5)
    held = [ring.acquire() for _ in range(5)]
    assert sorted(held) == list(range(5))
    with pytest.raises(RuntimeError, match="in flight"):
        ring.acquire()
    ring.release(held[3])
    assert ring.acquire() == held[3]  # only the released slot comes back
    for s in (held[0], held[1]):
        ring.release(s)
    assert [ring.acquire(), ring.acquire()] == held[:2]  # longest released first
    with pytest.raises(RuntimeError, match="not in flight"):
        ring.release(99)
    ring.release(held[2])
    with pytest.raises(RuntimeError, match="not in flight"):
        ring.release(held[2])


class _Instance:
    def __init__(self):
        self.resets = 0

    def reset(self):
        self.resets += 1


def test_checkout_gives_concurrent_jobs_different_instances(monkeypatch):
    monkeypatch.setattr(step_graph, "_idle", [])
    with checkout("k", _Instance) as (a, built_a), checkout("k", _Instance) as (b, built_b):
        assert a is not b and built_a and built_b
    # Both went back; the next two jobs of the key reuse them, reset.
    with checkout("k", _Instance) as (c, built_c), checkout("k", _Instance) as (d, built_d):
        assert {id(c), id(d)} == {id(a), id(b)} and not (built_c or built_d)
        assert c.resets == d.resets == 1
    # Another key never gets them.
    with checkout("other", _Instance) as (e, built_e):
        assert built_e and e not in (a, b)


def test_checkout_keeps_an_instance_only_after_a_clean_stream(monkeypatch):
    monkeypatch.setattr(step_graph, "_idle", [])
    with pytest.raises(ValueError):
        with checkout("k", _Instance) as (a, _built):
            raise ValueError("the job failed")
    with checkout("k", _Instance) as (b, built):
        assert built and b is not a
    for k in range(step_graph.IDLE_MAX + 2):
        with checkout(k, _Instance):
            pass
    assert len(step_graph._idle) == step_graph.IDLE_MAX
    assert [k for k, _i in step_graph._idle] == list(range(2, step_graph.IDLE_MAX + 2))


def test_app_key_ignores_what_only_egress_reads():
    ii = get_app("inverted_index")
    assert step_graph.app_key(dataclasses.replace(ii, corpus_bounds=(3,))) == \
        step_graph.app_key(ii)
    grep = get_app("grep", query=("alpha",))
    assert step_graph.app_key(grep) != step_graph.app_key(get_app("grep", query=("beta",)))
    assert step_graph.app_key(grep) != step_graph.app_key(ii)


# ---- the graph step's bookkeeping against the eager step (CPU) ----

class _EagerReplay:
    """Stands in for a captured graph on the CPU: replay runs the step."""

    def __init__(self, step):
        step()  # the first run, as the capture's
        self.replay = step


def _corpus_files(tmp_path, n_docs: int, vocab: int, words: int):
    rng = np.random.default_rng(vocab)
    paths = []
    for d in range(n_docs):
        ids = rng.zipf(1.3, words) % vocab
        text = b" ".join(b"w%d" % i for i in ids.tolist()) + b"\n"
        p = tmp_path / f"doc{d}.txt"
        p.write_bytes(text)
        paths.append(str(p))
    return paths


def _stream(step, cfg, app, paths):
    acc = driver.HostAccumulator(app.combine_op)
    stats = JobStats()
    driver._stream_steps(cfg, app, paths, stats, acc, Dictionary(), 0, step,
                         max(cfg.pipeline_depth, 1))
    return acc, stats


#: (app, Config fields): evictions of a tiny state, overflow replays of a
#: tiny partial capacity, doc ids through inverted_index; pipeline_depth 2
#: drains every two chunks, so the five slots of the ring are reused.
CPU_CASES = {
    "evict": ("word_count", dict(merge_capacity=1 << 9)),
    "replay": ("word_count", dict(partial_capacity=64, merge_capacity=1 << 12)),
    "ii": ("inverted_index", dict(merge_capacity=1 << 10)),
}


@pytest.mark.parametrize("case", sorted(CPU_CASES))
def test_graph_bookkeeping_matches_eager_on_cpu(case, tmp_path, monkeypatch):
    monkeypatch.setattr(step_graph, "_capture", lambda step, device: _EagerReplay(step))
    app_name, fields = CPU_CASES[case]
    app = get_app(app_name)
    cfg = Config(device="cpu", chunk_bytes=1 << 13, pipeline_depth=2, **fields)
    paths = _corpus_files(tmp_path, 3, 3000, 6000)
    u_cap = cfg.effective_partial_capacity()
    cpu = torch.device("cpu")
    eager = EagerStep(*driver.make_step_fns(app, u_cap), cfg.merge_capacity, cpu)
    graph = GraphStep(*driver.make_step_fns(app, u_cap), chunk_bytes=cfg.chunk_bytes,
                      merge_capacity=cfg.merge_capacity, slots=5, device=cpu)
    got = []
    for step in (eager, graph, graph):  # the graph step twice: reset between jobs
        if step is graph:
            graph.reset()
        acc, stats = _stream(step, cfg, app, paths)
        got.append((acc.table, stats.spilled_keys, stats.spill_events,
                    stats.partial_overflow_replays, stats.chunks, step.replays))
    (want, *w_counts, chunks, w_replays), *graphs = got
    assert chunks > 5 and w_replays == 0
    for table, *counts, g_chunks, replays in graphs:
        assert table == want and counts == w_counts and replays == g_chunks == chunks
    if case == "evict":
        assert w_counts[0] > 0
    if case == "replay":
        assert w_counts[2] > 0


# ---- on the card ----

cuda = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _gen_text(generator: str, seed: int, index: int, nbytes: int) -> bytes:
    from mrbench import gen

    cfg = json.loads((REPO / "mrbench" / "configs" /
                      f"wordcount-{'hibench' if generator == 'randomtext' else 'zipf'}.json")
                     .read_text())
    data, _ids, _counts = gen.load(generator).generate(
        cfg["generator_params"], seed, index, nbytes, "cuda")
    return data.tobytes()


def _write_corpus(d: pathlib.Path, generator: str, n_docs: int, nbytes: int) -> list:
    d.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(n_docs):
        p = d / f"doc{i}.txt"
        p.write_bytes(_gen_text(generator, 20261019, i, nbytes))
        paths.append(str(p))
    return paths


#: (generator, app, docs, MiB a doc, Config fields) of the card's cases.
CARD_CASES = {
    "zipf": ("zipf", "word_count", 1, 12, {}),
    "hibench": ("randomtext", "word_count", 1, 12, {}),
    "evict": ("zipf", "word_count", 1, 8, dict(merge_capacity=1 << 14, pipeline_depth=2)),
    "replay": ("zipf", "word_count", 1, 6, dict(partial_capacity=1 << 12,
                                                pipeline_depth=2)),
    "ii": ("zipf", "inverted_index", 4, 3, dict(merge_capacity=1 << 16, pipeline_depth=3)),
}


@cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_captured_step_matches_eager_step_on_card(case, tmp_path):
    """Chunk by chunk: the same counters, evicted tails and state."""
    _need_card()
    generator, app_name, n_docs, mib, fields = CARD_CASES[case]
    app = get_app(app_name)
    cfg = Config(**fields)
    paths = _write_corpus(tmp_path, generator, n_docs, mib << 20)
    dev = driver.select_device("cuda")
    u_cap = cfg.effective_partial_capacity()
    eager = EagerStep(*driver.make_step_fns(app, u_cap), cfg.merge_capacity, dev)
    graph = GraphStep(*driver.make_step_fns(app, u_cap), chunk_bytes=cfg.chunk_bytes,
                      merge_capacity=cfg.merge_capacity, slots=4, device=dev)
    before = tokenize_hash.launches
    n = 0
    for doc_id, path in enumerate(paths):
        with open(path, "rb") as f:
            for chunk in chunk_stream(f, doc_id, cfg.chunk_bytes):
                he = eager.dispatch(chunk.data, chunk.doc_id)
                hg = graph.dispatch(chunk.data, chunk.doc_id)
                assert eager.counts([he]) == graph.counts([hg])
                for a, b in zip(eager.evicted(he), graph.evicted(hg)):
                    assert torch.equal(a, b), (case, n)
                assert torch.equal(eager.chunk_host(he), graph.chunk_host(hg))
                for a, b in zip(eager.state, graph.state):
                    assert torch.equal(a, b), (case, n)
                graph.release(hg)
                n += 1
    # One launch per eager call and one per replay; the capture's own
    # calls count none.
    assert graph.replays == n and tokenize_hash.launches == before + 2 * n


def _job(cfg: Config, app, paths, out: pathlib.Path):
    res = driver.run_job(dataclasses.replace(cfg, output_dir=str(out / "out"),
                                             work_dir=str(out / "work")),
                         paths, app=app)
    files = [pathlib.Path(p).read_bytes() for p in res.output_files]
    return res.stats, files


@cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_graph_jobs_match_eager_jobs_on_card(case, tmp_path, monkeypatch):
    """Whole jobs: mr-{r}.txt byte for byte, one replay and one counted
    launch per chunk."""
    _need_card()
    generator, app_name, n_docs, mib, fields = CARD_CASES[case]
    app = get_app(app_name)
    cfg = Config(reduce_n=3, **fields)
    paths = _write_corpus(tmp_path / "in", generator, n_docs, mib << 20)
    got = {}
    for side in ("graph", "eager", "graph-again"):
        with monkeypatch.context() as m:
            if side == "eager":
                m.setattr(step_graph, "_idle", [])
                m.setattr(step_graph, "GraphStep",
                          lambda mc, mg, chunk_bytes, merge_capacity, slots, device:
                          EagerStep(mc, mg, merge_capacity, device))
            before = tokenize_hash.launches
            stats, files = _job(cfg, app, paths, tmp_path / side)
            got[side] = files
        replays = stats.partial_overflow_replays
        assert tokenize_hash.launches == before + stats.chunks + replays, side
        if side != "eager":
            assert stats.step_graph_replays == stats.chunks, side
    assert got["graph"] == got["eager"] == got["graph-again"]
    assert stats.step_graph_captures == 0  # the second graph job reused the first's
    if case == "evict":
        assert stats.spilled_keys > 0
    if case == "replay":
        assert stats.partial_overflow_replays > 0


@cuda
def test_two_jobs_at_once_capture_their_own_graphs(tmp_path, monkeypatch):
    _need_card()
    monkeypatch.setattr(step_graph, "_idle", [])
    app = get_app("word_count")
    cfg = Config(reduce_n=2, merge_capacity=1 << 16, pipeline_depth=2)
    zipf = _write_corpus(tmp_path / "z", "zipf", 1, 12 << 20)
    hib = _write_corpus(tmp_path / "h", "randomtext", 1, 12 << 20)
    alone = {name: _job(cfg, app, p, tmp_path / f"alone-{name}")[1]
             for name, p in (("z", zipf), ("h", hib))}
    results, errors = {}, []
    go = threading.Barrier(2)

    def run(name, p):
        try:
            go.wait()
            for k in range(2):
                results[name, k] = _job(cfg, app, p, tmp_path / f"{name}-{k}")
        except BaseException as e:  # re-raised on the test's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=a) for a in (("z", zipf), ("h", hib))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    assert not errors, errors
    for (name, _k), (stats, files) in results.items():
        assert files == alone[name], name
        assert stats.step_graph_replays == stats.chunks
    # The jobs alone left one instance; the concurrent pair could not share
    # it, so one of them captured a second, and the pool holds both.
    assert sum(s.step_graph_captures for s, _f in results.values()) == 1
    assert len(step_graph._idle) == 2

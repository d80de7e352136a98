"""The port's driver entry points: single-card forward step + multi-process
dry run. The twin of ``__graft_entry__.py`` for ``mapreduce_rust_tpu_torch``.

entry() returns the flagship forward step — the word-count map+combine
(tokenize→hash on the CUDA scan kernel, then sort and segment-reduce) that
replaces the Rust original's map hot loop (src/mr/worker.rs:142-155,
src/app/wc.rs:6-13) — with an example chunk on the card.

dryrun_multichip(n) runs the multi-process mesh on n processes of one
gloo process group on the CPU, one shard each: two rounds of per-shard
combine, bucket scatter, all_to_all between the processes and per-shard
merge into hash-class-sharded state, on tiny shapes. This is the complete
multi-device "training step" of a MapReduce framework: map, shuffle,
reduce, state update.

Imports torch and the port only, never JAX nor the JAX package.
"""

from __future__ import annotations

import numpy as np

#: Tiny shapes of the dry run (the reference's).
_CHUNK_BYTES, _U_CAP, _BUCKET_CAP, _STATE_CAP = 512, 128, 64, 256
_WORDS_PER_SHARD, _ROUNDS = 40, 2


def entry(device: str = "cuda"):
    """(map_combine, example_args) of the single-device forward step, the
    chunk on ``device`` (the card unless the caller asks for "cpu")."""
    import torch

    from mapreduce_rust_tpu_torch.apps.word_count import WordCount
    from mapreduce_rust_tpu_torch.runtime.driver import make_step_fns, select_device

    chunk_bytes = 1 << 20
    map_combine, _ = make_step_fns(WordCount(), u_cap=chunk_bytes // 8)

    text = b"the quick brown fox jumps over the lazy dog " * 200
    chunk = np.full(chunk_bytes, 0x20, dtype=np.uint8)
    chunk[: len(text)] = np.frombuffer(text, dtype=np.uint8)
    return map_combine, (torch.from_numpy(chunk).to(select_device(device)), 0)


def _round_words(n_devices: int) -> list[list[str]]:
    """Every round's words, 40 per shard: the same in every process."""
    rng = np.random.default_rng(0)
    return [[f"w{rng.integers(0, 50):02d}" for _ in range(_WORDS_PER_SHARD * n_devices)]
            for _ in range(_ROUNDS)]


def dryrun_multichip(n_devices: int) -> None:
    """Validate the multi-process mesh on n gloo CPU processes: each rank
    runs the rounds in a subprocess with a hard deadline and prints its
    state; the parent checks that rank d holds exactly the keys whose
    unsigned k1 has ``k1 % n == d`` and that the sharded counts are the
    word-count oracle."""
    import collections
    import json
    import os
    import socket
    import subprocess
    import sys

    from mapreduce_rust_tpu_torch.core.hashing import hash_word

    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ,
           "PYTHONPATH": here + os.pathsep + os.environ.get("PYTHONPATH", "")}
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [
        subprocess.Popen(
            [sys.executable, "-c",
             f"import __graft_entry_torch__ as g; g._dryrun_rank({int(n_devices)}, "
             f"{rank}, {port})"],
            cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(n_devices)
    ]
    results = []
    try:
        for rank, p in enumerate(procs):
            out, err = p.communicate(timeout=110)
            sys.stderr.write(err[-4000:])
            if p.returncode != 0:
                tail = (err or out).strip().splitlines()
                raise RuntimeError(
                    f"dryrun_multichip({n_devices}) rank {rank} rc={p.returncode}: "
                    f"{tail[-1] if tail else 'no output'}")
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    oracle = collections.Counter(w for words in _round_words(n_devices) for w in words)
    got: dict = {}
    for rank, res in enumerate(results):
        for k1, k2, v in res["keys"]:
            if k1 % n_devices != rank:
                raise AssertionError(f"rank {rank} holds key k1={k1} of shard "
                                     f"{k1 % n_devices}")
            got[(k1, k2)] = got.get((k1, k2), 0) + v
    want = {hash_word(w.encode()): c for w, c in oracle.items()}
    if got != want:
        raise AssertionError("sharded counts diverge from the word-count oracle")
    print(
        f"dryrun_multichip({n_devices}): ok — {len(got)} distinct keys sharded "
        f"over {n_devices} processes, {_ROUNDS} rounds, counts exact"
    )


def _dryrun_rank(n_devices: int, rank: int, port: int) -> None:
    """One rank of dryrun_multichip: join the gloo group, run the rounds
    through make_mh_shuffle_step_fns on this rank's CPU shard, print
    {"rank", "keys": [[k1 unsigned, k2 unsigned, count], ...]}."""
    import json

    import torch

    torch.set_num_threads(1)

    from mapreduce_rust_tpu_torch.apps.word_count import WordCount
    from mapreduce_rust_tpu_torch.parallel import distributed
    from mapreduce_rust_tpu_torch.parallel.shuffle import (
        local_batch,
        make_mesh,
        make_mh_shuffle_step_fns,
        sharded_empty_state,
    )

    distributed.initialize(f"127.0.0.1:{port}", n_devices, rank, device="cpu")
    try:
        mesh = make_mesh(n_devices, "cpu", world=n_devices, rank=rank)
        map_shuffle, merge = make_mh_shuffle_step_fns(WordCount(), _U_CAP, _BUCKET_CAP,
                                                      mesh)
        state = sharded_empty_state(mesh, _STATE_CAP)
        # Round 1 merges into the empty state; round 2 rank-merges into a
        # non-trivial sorted state, the path every real stream takes.
        for words in _round_words(n_devices):
            mine = words[_WORDS_PER_SHARD * rank: _WORDS_PER_SHARD * (rank + 1)]
            row = " ".join(mine).encode()
            chunk = np.full(_CHUNK_BYTES, 0x20, dtype=np.uint8)
            chunk[: len(row)] = np.frombuffer(row, dtype=np.uint8)
            local, totals = map_shuffle([torch.from_numpy(chunk)], [rank], 1)
            state, _evicted, ev_counts = merge(state, local)
            if totals.tolist() != [n_devices, 0, 0] or int(ev_counts.sum()) != 0:
                raise AssertionError(f"rank {rank}: totals {totals.tolist()}, "
                                     f"evicted {ev_counts.tolist()}")
        st = local_batch(state)
        valid = st.valid[0]
        keys = [[int(a), int(b), int(v)] for a, b, v in
                zip(st.k1[0][valid], st.k2[0][valid], st.value[0][valid])]
    finally:
        distributed.shutdown()
    print(json.dumps({"rank": rank, "keys": keys}))

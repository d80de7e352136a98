"""The port's provenance ledger and ``lineage`` CLI against the JAX package.

Both packages run the same jobs on the same seeded corpus with
``Config.lineage`` on: word_count and inverted_index on each engine, and
one budgeted run through the streaming egress. Their ``lineage.jsonl``
records and their manifests' ``stats.lineage`` must be equal, field for
field, leaving out only the fields that name the process or the path
(``pid``, ``path``). The port's outputs must be byte-identical with the
ledger on and off. Then the ``lineage`` CLI of each package must print the
same thing over the same ledgers, the reference's over the port's ledger
included.
"""

import json
import pathlib
import shutil

import numpy as np
import pytest

from mapreduce_rust_tpu.__main__ import main as jax_cli_main
from mapreduce_rust_tpu.apps import get_app as jax_get_app
from mapreduce_rust_tpu.config import Config as JaxConfig
from mapreduce_rust_tpu.runtime import driver as jax_driver
from mapreduce_rust_tpu_torch.__main__ import main as cli_main
from mapreduce_rust_tpu_torch.apps import get_app
from mapreduce_rust_tpu_torch.config import Config
from mapreduce_rust_tpu_torch.runtime.driver import run_job
from mapreduce_rust_tpu_torch.runtime.lineage import active_ledger

HOST = dict(map_engine="host", host_update_cap=1 << 10, host_window_bytes=1 << 16,
            merge_capacity=1 << 15, host_map_workers=2, fold_shards=2)
#: case → (app, Config fields both packages run with).
CASES = {
    "wc-device": ("word_count", dict(chunk_bytes=1 << 16, merge_capacity=1 << 14)),
    "ii-device": ("inverted_index", dict(chunk_bytes=1 << 16, merge_capacity=1 << 14)),
    "wc-host": ("word_count", HOST),
    "ii-host": ("inverted_index", HOST),
    "wc-budget": ("word_count", dict(chunk_bytes=1 << 16, merge_capacity=1 << 12,
                                     host_accum_budget_mb=0,
                                     dictionary_budget_words=512)),
}
#: Fields that name the process or the file, not the data.
WALL_FIELDS = ("pid", "path")


def _corpus(seed: int, n_words: int, vocab_size: int) -> bytes:
    rng = np.random.default_rng(seed)
    vocab = [b"w%d" % i for i in range(vocab_size)] + ["naïve".encode(), b"x,y"]
    seps = [b" ", b"\n", b"\t", b"  "]
    ws = rng.integers(0, len(vocab), n_words)
    ss = rng.integers(0, len(seps), n_words)
    return b"".join(vocab[w] + seps[s] for w, s in zip(ws.tolist(), ss.tolist()))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    for i, (n, v) in enumerate([(22_000, 5000), (9_000, 700), (14_000, 60)]):
        (d / f"doc-{i}.txt").write_bytes(_corpus(40 + i, n, v))
    return d


def _plain_pack(self, k1, k2, vals):
    # The reference host engine on its plain packer (ROADMAP Queue 3: its
    # _PackStager may alias a reused buffer on a multi-core CPU).
    return jax_driver._pack_update(np.stack([k1, k2], axis=1), vals, self.cap)


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """case → {"ref"|"port"|"off": (work dir, manifest, output bytes)},
    computed lazily."""
    cache: dict = {}

    def get(case: str) -> dict:
        if case not in cache:
            app, fields = CASES[case]
            root = tmp_path_factory.mktemp(case)
            got = {}
            for side in ("ref", "port", "off"):
                work, m = root / side / "work", root / side / "m.json"
                kw = dict(device="cpu", reduce_n=3, input_dir=str(corpus),
                          output_dir=str(root / side / "out"), work_dir=str(work),
                          lineage=side != "off", manifest_path=str(m), **fields)
                if side == "ref":
                    with pytest.MonkeyPatch.context() as mp:
                        mp.setattr(jax_driver._PackStager, "pack", _plain_pack)
                        res = jax_driver.run_job(JaxConfig(**kw), app=jax_get_app(app))
                else:
                    res = run_job(Config(**kw), app=get_app(app))
                got[side] = (work, m, [pathlib.Path(p).read_bytes()
                                       for p in res.output_files])
            cache[case] = got
        return cache[case]

    return get


def ledger_records(work: pathlib.Path) -> list:
    recs = [json.loads(line) for line in (work / "lineage.jsonl").read_text().splitlines()]
    return [{k: v for k, v in r.items() if k not in WALL_FIELDS} for r in recs]


def lineage_block(manifest: pathlib.Path) -> dict:
    block = json.loads(manifest.read_text())["stats"]["lineage"]
    return {k: v for k, v in block.items() if k not in WALL_FIELDS}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ledger_equals_reference(runs, case):
    got = runs(case)
    (ref_work, ref_m, ref_out), (work, m, out) = got["ref"], got["port"]
    assert out == ref_out and out == got["off"][2]
    recs = ledger_records(work)
    assert recs == ledger_records(ref_work)
    kinds = [r["t"] for r in recs]
    assert kinds[0] == "start" and kinds[-1] == "end"
    assert kinds.count("part") == 3 and kinds.count("chunk") > 1
    assert lineage_block(m) == lineage_block(ref_m)
    assert not (got["off"][0] / "lineage.jsonl").exists()
    assert "lineage" not in json.loads(got["off"][1].read_text())["stats"]
    if case == "wc-budget":
        stats = json.loads(m.read_text())["stats"]
        assert stats["accum_spill_runs"] > 0 and stats["dict_spill_runs"] > 0
    assert active_ledger() is None  # compare-and-clear at job end


def _cli_pair(args: list, capsys) -> tuple:
    rcs, outs = [], []
    for main in (cli_main, jax_cli_main):
        rcs.append(main(args))
        outs.append(capsys.readouterr().out)
    return rcs, outs


@pytest.mark.parametrize("query", [
    [], ["--forward", "0"], ["--forward", "PREFIX"], ["--backward", "0"],
    ["--backward", "2", "--format", "json"], ["--backward", "7"], ["--format", "json"]])
def test_lineage_cli_matches_reference(runs, capsys, query):
    """Each package's CLI over the port's ledger and over the reference's
    prints the same; the reference reads the port's ledger."""
    for case in ("wc-device", "ii-host"):
        got = runs(case)
        for side in ("port", "ref"):
            work = got[side][0]
            dg = ledger_records(work)[3]["dg"]
            args = ["lineage", str(work)] + [dg[:10] if q == "PREFIX" else q for q in query]
            rcs, outs = _cli_pair(args, capsys)
            assert rcs[0] == rcs[1] and outs[0] == outs[1] and outs[0].strip()
            assert rcs[0] == (2 if query == ["--backward", "7"] else 0)
    # A manifest target resolves the same ledger.
    rcs, outs = _cli_pair(["lineage", str(runs("wc-host")["port"][1])], capsys)
    assert rcs == [0, 0] and outs[0] == outs[1]


def test_lineage_diff_and_stamp_match_reference(corpus, runs, tmp_path, capsys):
    """Blast radius between the corpus and the corpus with one file
    changed, in text, JSON and ``--stamp`` form."""
    grown = tmp_path / "grown"
    shutil.copytree(corpus, grown)
    (grown / "doc-2.txt").write_bytes(_corpus(99, 14_000, 60))
    app, fields = CASES["wc-device"]
    m = tmp_path / "new" / "m.json"
    run_job(Config(device="cpu", reduce_n=3, input_dir=str(grown),
                   output_dir=str(tmp_path / "new" / "out"),
                   work_dir=str(tmp_path / "new" / "work"), lineage=True,
                   manifest_path=str(m), **fields), app=get_app(app))
    old = str(runs("wc-device")["port"][0])
    for fmt in (["--format", "json"], []):
        rcs, outs = _cli_pair(["lineage", "diff", old, str(m)] + fmt, capsys)
        assert rcs == [0, 0] and outs[0] == outs[1]
    doc = json.loads(_cli_pair(["lineage", "diff", old, str(m), "--format", "json"],
                               capsys)[1][0])
    assert 0.0 < doc["memo_hit_frac"] < 1.0 and doc["changed_chunks"] > 0
    stamped = []
    for main, tag in ((cli_main, "port"), (jax_cli_main, "ref")):
        copy = tmp_path / f"m-{tag}.json"
        shutil.copy(m, copy)
        assert main(["lineage", "diff", old, str(copy), "--stamp"]) == 0
        capsys.readouterr()
        stamped.append(json.loads(copy.read_text())["stats"]["lineage"])
    assert stamped[0] == stamped[1] and "memo_hit_frac" in stamped[0]

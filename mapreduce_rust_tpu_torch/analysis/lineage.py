"""mrlineage queries: forward/backward provenance + blast radius.

A copy of ``mapreduce_rust_tpu/analysis/lineage.py``. The torch-free half
of the provenance plane: ``runtime/lineage.py`` writes the ledger during
a run; this module answers questions about it after — in any process,
without importing torch (tests/test_torch_analysis_cli.py gates that):

- **forward**: chunk (ledger seq or digest prefix) → the reduce
  partitions its routed keys contributed to — "if this chunk changes,
  which outputs move?"
- **backward**: reduce partition → the contributing chunk set (digests,
  bytes, docs) plus the attempt chain that scanned them — "which input
  bytes does this output depend on, and who computed it?"
- **diff**: two ledgers (old run, new run) → recompute blast radius: the
  changed-chunk set, the affected-partition fraction, and the headline
  ``memo_hit_frac`` — the byte-weighted fraction of the NEW corpus whose
  chunks already existed (digest-identical) in the old run, i.e. exactly
  the work a chunk-level memo tier would not redo.

Targets are flexible: a ``lineage.jsonl`` path, a work dir containing
one, a run manifest (``stats.lineage.path``), or a flight-recorder
``*.partial.json`` (its embedded lineage tail) — so a SIGKILLed run's
provenance resolves from the partial alone. Ledger parsing distrusts the
tail line (torn-append doctrine, same as the coordinator journal reader).
"""

from __future__ import annotations

import json
import os

from mapreduce_rust_tpu_torch.runtime.lineage import LEDGER_NAME, fold_digests


class LineageError(Exception):
    """A target that cannot be resolved/parsed into a ledger."""


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------

def _empty(source: str) -> dict:
    return {"source": source, "header": {}, "chunks": [], "attempts": [],
            "parts": [], "end": None, "bad_lines": 0, "partial": False}


def _parse_jsonl(path: str) -> dict:
    """Parse one ledger file. The last line is distrusted when the file
    does not end in a newline (torn append under SIGKILL); any
    unparseable line is counted and skipped, never fatal — a partial
    ledger still answers partial queries."""
    led = _empty(path)
    try:
        with open(path) as f:
            data = f.read()
    except OSError as e:
        raise LineageError(f"cannot read ledger: {e}") from e
    lines = data.splitlines()
    if lines and not data.endswith("\n"):
        lines.pop()  # torn tail from a crashed append — never trust it
        led["partial"] = True
    for line in lines:
        try:
            rec = json.loads(line)
            t = rec.get("t")
        except (ValueError, AttributeError):
            led["bad_lines"] += 1
            continue
        if t == "start":
            led["header"] = rec
        elif t == "chunk":
            led["chunks"].append(rec)
        elif t == "attempt":
            led["attempts"].append(rec)
        elif t == "part":
            led["parts"].append(rec)
        elif t == "end":
            led["end"] = rec
        else:
            led["bad_lines"] += 1
    return led


def _from_embed(doc: dict, source: str) -> dict:
    """Ledger view from a flight-recorder partial's embedded tail (or a
    manifest whose work dir is gone): header + the capped chunk-record
    tail. No part/attempt records — backward queries fall back to the
    chunks' own routing."""
    led = _empty(source)
    led["partial"] = True
    led["header"] = dict(doc.get("header") or {})
    led["chunks"] = [r for r in (doc.get("records") or [])
                     if isinstance(r, dict) and r.get("t") == "chunk"]
    return led


def load_ledger(target: str) -> dict:
    """Resolve ``target`` into a parsed ledger dict. Accepts a
    lineage.jsonl path, a work dir, a run manifest, or a *.partial.json
    flight-recorder snapshot."""
    if os.path.isdir(target):
        return _parse_jsonl(os.path.join(target, LEDGER_NAME))
    if not os.path.exists(target):
        raise LineageError(f"no such file or directory: {target}")
    if target.endswith(".jsonl"):
        return _parse_jsonl(target)
    # JSON documents: a manifest (stats.lineage) or a recorder partial
    # (top-level "lineage" tail) — the same two shapes mrprof reads its
    # profile from.
    try:
        with open(target) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        raise LineageError(f"cannot parse {target}: {e}") from e
    if isinstance(doc.get("lineage"), dict):          # recorder partial
        return _from_embed(doc["lineage"], target)
    summary = (doc.get("stats") or {}).get("lineage") if isinstance(
        doc.get("stats"), dict) else None
    if isinstance(summary, dict):                     # run manifest
        path = summary.get("path")
        if path and os.path.exists(path):
            return _parse_jsonl(path)
        # Manifest shipped without its work dir: summary-only view.
        led = _empty(target)
        led["partial"] = True
        led["header"] = {"corpus_meta_digest": summary.get(
            "corpus_meta_digest"), "reduce_n": summary.get("reduce_n")}
        return led
    raise LineageError(
        f"{target}: neither a lineage ledger, a manifest with "
        "stats.lineage, nor a recorder partial (was the run --lineage?)")


# ---------------------------------------------------------------------------
# Queries
# ---------------------------------------------------------------------------

def _reduce_n(led: dict) -> int:
    n = led["header"].get("reduce_n") or 0
    if not n:
        for p in led["parts"]:
            n = max(n, int(p.get("r", -1)) + 1)
    return int(n)


def _chunk_by_ref(led: dict, ref: str) -> dict:
    """Resolve a chunk reference — a ledger seq (decimal int) or a
    digest prefix (>= 6 hex chars, unambiguous) — to its chunk record."""
    chunks = led["chunks"]
    if ref.isdigit():
        for c in chunks:
            if c.get("seq") == int(ref):
                return c
        raise LineageError(f"no chunk with seq {ref} "
                           f"({len(chunks)} chunk records)")
    if len(ref) < 6:
        raise LineageError("digest prefix too short (need >= 6 hex chars)")
    hits = [c for c in chunks if str(c.get("dg", "")).startswith(ref)]
    if not hits:
        raise LineageError(f"no chunk digest matches {ref!r}")
    if len({c["dg"] for c in hits}) > 1:
        raise LineageError(f"digest prefix {ref!r} is ambiguous "
                           f"({len(hits)} matches)")
    return hits[0]


def forward(led: dict, ref: str) -> dict:
    """chunk → the reduce partitions it contributed to. Uses the chunk
    record's own routed-parts edge when present (driver ledgers); falls
    back to part-record claims (cluster ledgers, where routing lives on
    the egress side)."""
    c = _chunk_by_ref(led, ref)
    parts = list(c.get("parts") or [])
    via = "routing"
    if not parts and led["parts"]:
        parts = sorted(int(p["r"]) for p in led["parts"]
                       if c.get("dg") in (p.get("chunks") or []))
        via = "claims"
    return {"chunk": c, "partitions": parts, "via": via}


def backward(led: dict, r: int) -> dict:
    """reduce partition → contributing chunks + the attempt chain. The
    claim set comes from the partition's egress record when present;
    otherwise (partial/killed run) from the chunk records' routing edges
    — both sides of the same conservation invariant mrcheck replays."""
    part = next((p for p in led["parts"] if p.get("r") == r), None)
    if part is not None:
        claimed = list(part.get("chunks") or [])
        via = "claims"
    else:
        claimed = [c["dg"] for c in led["chunks"]
                   if r in (c.get("parts") or [])]
        via = "routing"
    by_dg = {c.get("dg"): c for c in led["chunks"]}
    chunks = [by_dg.get(dg, {"dg": dg}) for dg in claimed]
    attempts = [a for a in led["attempts"]
                if set(claimed) & set(a.get("chunks") or [])]
    return {
        "partition": r,
        "bytes": part.get("bytes") if part else None,
        "chunks": chunks,
        "attempts": attempts,
        "via": via,
    }


def diff(old: dict, new: dict) -> dict:
    """Recompute blast radius between two runs. Chunks are matched by
    content digest as a byte-weighted multiset — an appended/changed
    file shifts only the chunks whose bytes actually differ, and
    ``memo_hit_frac`` is the fraction of the NEW corpus's bytes a
    chunk-level memo tier keyed on (app, chunk digest) would serve
    without recomputation (the memo tier's headline number)."""
    def weights(led: dict) -> dict:
        w: dict = {}
        for c in led["chunks"]:
            dg = c.get("dg")
            if dg:
                w[dg] = w.get(dg, 0) + int(c.get("bytes") or 1)
        if not w:  # attempt-only (cluster) ledger: unit weights
            for a in led["attempts"]:
                for dg in a.get("chunks") or []:
                    w[dg] = w.get(dg, 0) + 1
        return w

    ow, nw = weights(old), weights(new)
    new_total = sum(nw.values())
    hit_bytes = sum(min(b, ow[dg]) for dg, b in nw.items() if dg in ow)
    changed = [dg for dg in nw if dg not in ow]
    removed = [dg for dg in ow if dg not in nw]
    # Affected partitions: everywhere a changed chunk routes. A chunk
    # with no recorded routing claims every partition (conservative).
    rn = max(_reduce_n(new), _reduce_n(old))
    parts_of: dict = {c.get("dg"): c.get("parts")
                      for c in new["chunks"]}
    affected: set = set()
    for dg in changed:
        ps = parts_of.get(dg)
        affected.update(ps if ps else range(rn))
    return {
        "old_chunks": sum(1 for _ in old["chunks"]) or len(ow),
        "new_chunks": sum(1 for _ in new["chunks"]) or len(nw),
        "changed_chunks": len(changed),
        "removed_chunks": len(removed),
        "changed_bytes": sum(nw[dg] for dg in changed),
        "memo_hit_frac": (hit_bytes / new_total) if new_total else 0.0,
        "affected_partitions": sorted(affected),
        "affected_partition_frac": (len(affected) / rn) if rn else 0.0,
        "reduce_n": rn,
    }


def stamp_manifest(path: str, d: dict) -> bool:
    """Write a diff's headline numbers into ``path``'s stats.lineage
    block (the doctor's incremental-opportunity finding cites them from
    there). Only meaningful when the diff's NEW target was a manifest;
    returns False when the file is not a stampable manifest."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return False
    stats = doc.get("stats")
    if not isinstance(stats, dict) or not isinstance(
            stats.get("lineage"), dict):
        return False
    stats["lineage"]["memo_hit_frac"] = round(d["memo_hit_frac"], 6)
    stats["lineage"]["changed_chunks"] = d["changed_chunks"]
    stats["lineage"]["affected_partition_frac"] = round(
        d["affected_partition_frac"], 6)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    return True


# ---------------------------------------------------------------------------
# CLI (`mapreduce_rust_tpu_torch lineage ...`)
# ---------------------------------------------------------------------------

def _summary_lines(led: dict) -> list:
    h, end = led["header"], led["end"]
    lines = [f"ledger: {led['source']}"
             + (" (partial)" if led["partial"] else "")]
    if h:
        lines.append(
            f"corpus: {h.get('corpus_meta_digest', '?')} "
            f"{h.get('corpus_bytes', '?')}B "
            f"inputs={len(h.get('inputs') or [])} "
            f"reduce_n={h.get('reduce_n', '?')}")
    lines.append(
        f"records: {len(led['chunks'])} chunks, {len(led['attempts'])} "
        f"attempts, {len(led['parts'])} partition claims"
        + (f", {led['bad_lines']} bad lines" if led["bad_lines"] else ""))
    if end:
        lines.append(f"content digest: {end.get('corpus_digest')} "
                     f"({end.get('chunks')} chunks, {end.get('bytes')}B)")
    elif led["chunks"]:
        lines.append("content digest (re-folded): "
                     + fold_digests(c["dg"] for c in led["chunks"]
                                    if c.get("dg")))
    for p in led["parts"]:
        lines.append(f"  part {p.get('r')}: {p.get('bytes')}B from "
                     f"{len(p.get('chunks') or [])} chunks")
    return lines


def run_cli(args) -> int:
    fmt = getattr(args, "format", "text")

    def emit(doc, text_lines) -> None:
        if fmt == "json":
            print(json.dumps(doc, indent=2, sort_keys=True))
        else:
            print("\n".join(text_lines))

    targets = list(args.target)
    try:
        if targets and targets[0] == "diff":
            if len(targets) != 3:
                print("lineage diff needs exactly two targets "
                      "(old, new)")
                return 2
            old, new = load_ledger(targets[1]), load_ledger(targets[2])
            d = diff(old, new)
            if getattr(args, "stamp", False):
                if stamp_manifest(targets[2], d):
                    d["stamped"] = targets[2]
            pct = 100.0 * d["memo_hit_frac"]
            emit(d, [
                f"old: {d['old_chunks']} chunks   new: {d['new_chunks']} "
                f"chunks   changed: {d['changed_chunks']} "
                f"(+{d['changed_bytes']}B)   removed: {d['removed_chunks']}",
                f"memo_hit_frac: {d['memo_hit_frac']:.4f} ({pct:.1f}% of "
                "new-corpus bytes reusable by a chunk-level memo tier)",
                f"blast radius: {len(d['affected_partitions'])}/"
                f"{d['reduce_n']} partitions "
                f"({100.0 * d['affected_partition_frac']:.1f}%): "
                f"{d['affected_partitions']}",
            ])
            return 0
        if len(targets) != 1:
            print("expected one ledger target (or: diff <old> <new>)")
            return 2
        led = load_ledger(targets[0])
        fwd = getattr(args, "forward", None)
        bwd = getattr(args, "backward", None)
        if fwd is not None:
            r = forward(led, fwd)
            c = r["chunk"]
            emit(r, [
                f"chunk seq={c.get('seq')} doc={c.get('doc')} "
                f"bytes={c.get('bytes')} dg={c.get('dg')}",
                f"→ partitions {r['partitions']} (via {r['via']})",
            ])
            return 0 if r["partitions"] or not led["parts"] else 0
        if bwd is not None:
            r = backward(led, int(bwd))
            lines = [f"partition {r['partition']}"
                     + (f" ({r['bytes']}B)" if r["bytes"] is not None
                        else "")
                     + f" ← {len(r['chunks'])} chunks (via {r['via']})"]
            for c in r["chunks"]:
                lines.append(f"  {c.get('dg')} seq={c.get('seq')} "
                             f"doc={c.get('doc')} bytes={c.get('bytes')}")
            for a in r["attempts"]:
                lines.append(f"  attempt: map tid={a.get('tid')} "
                             f"a{a.get('attempt')} w{a.get('wid')} "
                             f"({len(a.get('chunks') or [])} chunks)")
            emit(r, lines)
            return 0 if r["chunks"] else 2
        emit(led, _summary_lines(led))
        return 0
    except LineageError as e:
        print(f"lineage: {e}")
        return 2

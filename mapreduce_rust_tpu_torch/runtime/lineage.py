"""Chunk-level data provenance ledger — the mrlineage plane.

A copy of ``mapreduce_rust_tpu/runtime/lineage.py`` (stdlib only).

The paper's one durable architectural decision is that all data moves
through files while the control plane carries only ids — so every output
partition is, in principle, an exactly attributable function of input
chunks, spill runs and attempts. This module makes that attribution a
recorded fact instead of a principle: an opt-in ledger
(``Config.lineage`` / ``--lineage`` / ``MR_LINEAGE=1``, off by default)
writes one torn-tail-safe jsonl record per ingest chunk — a blake2b
content digest computed in the scan thread where the bytes are already
hot, plus the reduce partitions the chunk's (masked) keys route to — and
per-partition claim records at egress, riding the same ``part_bytes``
bookkeeping the coordinator already ships.

Contracts (the prof.py plane doctrine):
- **Observational only.** Nothing the data plane reads is touched, so
  outputs are bit-identical lineage ON vs OFF; the tax is gated ≤2% by
  bench's ``--lineage-overhead`` interleaved pair.
- **Crash-durable.** Records are flushed line-by-line (the reader pops a
  torn tail, like the coordinator journal's parser) and the flight
  recorder embeds the in-memory tail in every ``*.partial.json``, so a
  SIGKILLed run keeps its provenance and backward queries still resolve.
- **One digest seam.** ``chunk_digest`` (content) and
  ``corpus_fingerprint`` (the (name, size, mtime) metadata digest the
  service's ``scan_corpus`` cache key uses) live HERE; mrlint rule
  ``ad-hoc-corpus-digest`` flags any second digest function over the
  same bytes — two formulas for one corpus is exactly the cache-key
  drift ROADMAP item 4's memo tier cannot survive.

Record schema (``{work}/lineage.jsonl``, one JSON object per line):
  {"t":"start", "schema":1, "corpus_meta_digest", "corpus_bytes",
   "reduce_n", "inputs":[basenames], "pid"}
  {"t":"chunk", "seq", "doc", "bytes", "dg", "parts":[r, ...]}
  {"t":"attempt", "phase":"map", "tid", "attempt", "wid",
   "chunks":[dg, ...], "part_bytes":[...]}        (cluster runs: the
   coordinator appends one per finish REPORT — late duplicates too,
   which is what gives mrcheck's re-execution-equality check teeth)
  {"t":"part", "r", "bytes", "chunks":[dg, ...]}  (claims at egress)
  {"t":"end", "chunks", "bytes", "corpus_digest", "partition_bytes"}

``corpus_digest`` is the ordered fold of the per-chunk content digests —
a pure function of (input bytes, window policy), identical across every
(host_map_workers, fold_shards) combination and across the driver and
worker engines, which is what makes it a memo-tier cache key.

jax-free on purpose: ``analysis/lineage.py`` (the query/diff CLI) and the
service import this module in processes that never initialize a backend.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading

#: Content-digest width. 16 bytes of blake2b: collision-safe for any
#: plausible corpus (2^64 chunks to a birthday collision) at half the
#: ledger bytes of the full 32.
DIGEST_SIZE = 16

#: Ledger file name inside a job's work dir — shared by the driver
#: ledger, the coordinator's cluster appends, mrcheck's pass and the CLI.
LEDGER_NAME = "lineage.jsonl"

SCHEMA = 1


def lineage_forced() -> bool:
    """``MR_LINEAGE`` — process-tree opt-in to the provenance ledger
    (the MR_PROFILE enablement pattern): a fleet worker or SIGKILL-test
    subprocess inherits lineage without plumbing a flag through argv."""
    return os.environ.get("MR_LINEAGE", "").strip().lower() in (
        "1", "true", "on", "yes"
    )


#: chunk_digest hashes every byte up to this size (cluster chunks and
#: small windows: exact content identity). Above it — the driver's
#: multi-MB ingest windows — it hashes a deterministic SAMPLE: the size,
#: both 64 KiB edges, and 16 strided 8 KiB interior blocks (~256 KiB a
#: window). The sample is a pure function of the bytes, so digests stay
#: reproducible and comparable; what it trades away is detection of a
#: same-length in-place edit that dodges every sampled byte. That trade
#: is what keeps the ledger inside bench's ≤2% wall contract on a
#: CPU-saturated host (a full blake2b of every window byte costs more
#: than the 2% budget on any box whose scan runs near the hash's own
#: speed) — and the common corpus edits (append, truncate, touch a
#: file's head) all move the size or an edge, so the blast-radius diff
#: sees them exactly. A memo tier wanting hard guarantees pairs this
#: content tier with the header's (size, mtime) corpus_fingerprint.
FULL_DIGEST_MAX = 1 << 20
_SAMPLE_EDGE = 64 << 10
_SAMPLE_BLOCKS = 16
_SAMPLE_BLOCK = 8 << 10


def chunk_digest(data) -> str:
    """blake2b content digest of one chunk/window's RAW bytes — full
    content at or below FULL_DIGEST_MAX, sampled (size + edges + strided
    interior) above. Accepts bytes or any contiguous buffer (a zero-copy
    memmap window view) — called from the scan thread, where the bytes
    are already hot in cache, so the hash rides the scan's memory
    traffic instead of re-faulting the corpus."""
    view = memoryview(data)
    if view.ndim != 1 or view.itemsize != 1:
        view = view.cast("B")
    n = view.nbytes
    if n <= FULL_DIGEST_MAX:
        return hashlib.blake2b(view, digest_size=DIGEST_SIZE).hexdigest()
    h = hashlib.blake2b(digest_size=DIGEST_SIZE)
    h.update(n.to_bytes(8, "little"))
    h.update(view[:_SAMPLE_EDGE])
    h.update(view[n - _SAMPLE_EDGE:])
    stride = (n - 2 * _SAMPLE_EDGE) // _SAMPLE_BLOCKS
    for i in range(_SAMPLE_BLOCKS):
        off = _SAMPLE_EDGE + i * stride
        h.update(view[off:off + _SAMPLE_BLOCK])
    return h.hexdigest()


def fold_digests(digests) -> str:
    """Ordered fold of per-chunk content digests into one corpus content
    digest — the memo-tier cache key. Order-sensitive on purpose: the
    chunk sequence is part of the corpus identity (doc ids are
    positional)."""
    h = hashlib.blake2b(digest_size=DIGEST_SIZE)
    for dg in digests:
        h.update(bytes.fromhex(dg) if isinstance(dg, str) else dg)
    return h.hexdigest()


def corpus_fingerprint(paths) -> "tuple[str, int]":
    """(metadata digest, total bytes) over an ordered path list — the
    (basename, size, mtime_ns) fingerprint the service's ``scan_corpus``
    uses as its result-cache corpus key and the per-job journal header
    uses for resume identity. ONE formula, defined here, imported there:
    the finalize cross-check compares the ledger header's copy against
    the cache key's, and they can only agree because they are the same
    function."""
    sig = hashlib.sha256()
    total = 0
    for p in paths:
        try:
            st = os.stat(p)
            total += st.st_size
            sig.update(
                f"{os.path.basename(p)}:{st.st_size}:{st.st_mtime_ns};".encode()
            )
        except OSError:
            sig.update(f"{os.path.basename(p)}:gone;".encode())
    return sig.hexdigest()[:16], total


def append_record(path: str, rec: dict) -> None:
    """Append one ledger record — the coordinator's (cluster-mode) write
    path: no process-global ledger, just the shared line format. Append
    + flush per record keeps the file torn-tail-safe under SIGKILL; the
    reader distrusts an unterminated last line."""
    with open(path, "a") as f:
        f.write(json.dumps(rec, separators=(",", ":")) + "\n")


class LineageLedger:
    """The driver-side provenance ledger: per-chunk content digests +
    partition routing recorded in chunk order, per-partition claims at
    egress, a running ordered digest fold, and a line-buffered jsonl
    file that survives SIGKILL mid-run.

    Thread contract: digests are COMPUTED on scan threads (pure), but
    records are appended from each engine's single consumer/router
    thread — the lock below is belt-and-braces for embedders, not a
    hot-path serialization point."""

    #: In-memory record cap for flight-recorder partial embeds: the tail
    #: a partial carries stays bounded however long the run (the full
    #: history is on disk in the jsonl).
    TAIL_CAP = 8192

    def __init__(self, path: str, inputs=(), reduce_n: int = 0) -> None:
        self.path = path
        self.reduce_n = int(reduce_n)
        self._lock = threading.Lock()
        self._seq = 0
        self._bytes = 0
        self._fold = hashlib.blake2b(digest_size=DIGEST_SIZE)
        self._chunks: list[dict] = []      # tail (capped) for partials
        self._chunk_parts: list[list] = [] # FULL parts index (ints only)
        self._digests: list[str] = []      # FULL ordered digest list
        self._partition_bytes: dict[int, int] = {}
        self._dropped = 0
        self._closed = False
        meta_dg, corpus_bytes = corpus_fingerprint(inputs)
        self.header = {
            "t": "start", "schema": SCHEMA,
            "corpus_meta_digest": meta_dg,
            "corpus_bytes": corpus_bytes,
            "reduce_n": self.reduce_n,
            "inputs": [os.path.basename(p) for p in inputs],
            "pid": os.getpid(),
        }
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # Truncate: a fresh run in a reused work dir must not append to a
        # previous job's provenance (the coordinator-journal doctrine).
        self._f = open(path, "w")
        self.submit(self.header)

    # ---- recording ----

    def submit(self, rec: dict) -> None:
        """The ledger's emit seam — a sync-mode plane handoff (the
        rule-13/14 doctrine AsyncSpillWriter and _DispatchPlane share):
        the fold/consumer hot scopes hand a frozen record here and this
        plane owns what happens below. It runs inline on purpose —
        write + flush per line is what makes the file torn-tail-safe
        under SIGKILL, and the ledger is an explicit opt-in measurement
        path whose tax bench gates at ≤2% (--lineage-overhead)."""
        self._f.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._f.flush()

    def record_chunk(self, doc_id: int, nbytes: int, digest: str,
                     parts=None) -> int:
        """One ingest chunk/window, in stream order (the engines' single
        consumer thread): content digest + the reduce partitions its
        masked keys route to. Returns the chunk's ledger seq."""
        parts = [int(r) for r in parts] if parts is not None else []
        with self._lock:
            seq = self._seq
            self._seq += 1
            self._bytes += int(nbytes)
            self._fold.update(bytes.fromhex(digest))
            self._digests.append(digest)
            self._chunk_parts.append(parts)
            rec = {"t": "chunk", "seq": seq, "doc": int(doc_id),
                   "bytes": int(nbytes), "dg": digest, "parts": parts}
            if len(self._chunks) < self.TAIL_CAP:
                self._chunks.append(rec)
            else:
                self._dropped += 1
            self.submit(rec)
        return seq

    def record_partition(self, r: int, nbytes: int) -> None:
        """One reduce partition's egress claim: its output bytes (the
        part_bytes path's number) plus the digests of every chunk whose
        routed keys contributed — mrcheck's lineage-conservation pass
        checks this claim set ⊆ the scanned set."""
        with self._lock:
            claims = [self._digests[i]
                      for i, ps in enumerate(self._chunk_parts) if r in ps]
            self._partition_bytes[int(r)] = int(nbytes)
            self.submit({"t": "part", "r": int(r), "bytes": int(nbytes),
                         "chunks": claims})

    def close(self) -> None:
        """Write the end summary (folded corpus content digest — the
        memo-tier key) and release the file. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self.submit(self.end_dict())
            self._f.close()

    # ---- views ----

    def corpus_digest(self) -> str:
        return self._fold.copy().hexdigest()

    def end_dict(self) -> dict:
        return {
            "t": "end", "chunks": self._seq, "bytes": self._bytes,
            "corpus_digest": self.corpus_digest(),
            "partition_bytes": [
                self._partition_bytes.get(r, 0)
                for r in range(max(self.reduce_n,
                                   len(self._partition_bytes)))
            ],
        }

    def lineage_dict(self) -> dict:
        """Manifest summary block (``stats.lineage``): counts + digests,
        never the per-chunk records — those live in the jsonl, whose
        path this names for the CLI."""
        with self._lock:
            return {
                "schema": SCHEMA,
                "chunks": self._seq,
                "bytes": self._bytes,
                "corpus_digest": self.corpus_digest(),
                "corpus_meta_digest": self.header["corpus_meta_digest"],
                "reduce_n": self.reduce_n,
                "path": self.path,
            }

    def tail_dict(self) -> dict:
        """Flight-recorder partial embed: header + the capped record
        tail + the running fold, enough for backward queries to resolve
        on a SIGKILLed run even if the jsonl itself is lost."""
        with self._lock:
            return {
                "schema": SCHEMA,
                "header": dict(self.header),
                "chunks": self._seq,
                "bytes": self._bytes,
                "corpus_digest": self.corpus_digest(),
                "records": list(self._chunks),
                "records_dropped": self._dropped,
            }


# ---------------------------------------------------------------------------
# Process-global lifecycle — the prof.py start/stop/active doctrine: one
# slot, compare-and-clear on stop (an in-process co-hosted job may have
# replaced it), build_manifest reads the still-active instance.
# ---------------------------------------------------------------------------

_ledger: "LineageLedger | None" = None
_ledger_lock = threading.Lock()


def start_ledger(path: str, inputs=(), reduce_n: int = 0) -> LineageLedger:
    global _ledger
    led = LineageLedger(path, inputs=inputs, reduce_n=reduce_n)
    with _ledger_lock:
        _ledger = led
    return led


def stop_ledger(expected: "LineageLedger | None" = None) -> None:
    """Close + clear the global slot. Compare-and-clear: only clears if
    the slot still holds ``expected`` (or unconditionally when None)."""
    global _ledger
    with _ledger_lock:
        led = _ledger
        if expected is not None and led is not expected:
            expected.close()
            return
        _ledger = None
    if led is not None:
        led.close()


def active_ledger() -> "LineageLedger | None":
    return _ledger

"""Opt-in thread-ownership sanitizer — the dynamic half of mrlint.

The port of ``mapreduce_rust_tpu/analysis/sanitize.py``; its factories
build the port's JobStats and Dictionary.

The static rules (rules.py) prove structure: a pool-submitted function
contains no stats write, an executor reaches its shutdown. What they can't
prove is aliasing — a callable that REACHES shared state through a closure
chain, a Dictionary handed to a thread that wasn't supposed to own it, a
scan arena crossing a fork. This module catches those at runtime:

- ``SanitizedJobStats``: every attribute write asserts the writing thread
  is registered (creator + explicitly registered writers, e.g. the ingest
  producer). A scan worker mutating stats raises
  ``SanitizerError`` at the write site instead of corrupting counters.
- ``SanitizedDictionary``: mutating methods assert the owner thread — the
  fold-on-one-thread contract of the ingest/host-map engines, enforced.
- native arena check (native/host.py calls ``check_arena_owner``): per-
  thread scan scratch must never be observed by a different (pid, tid) —
  the fork/handoff hazard thread-locals can't express.

Enabled by ``Config.sanitize=True`` or ``MR_SANITIZE=1`` in the
environment; the factories below return plain instances when disabled, so
the hot path pays nothing. No torch import here.
"""

from __future__ import annotations

import os
import threading

from mapreduce_rust_tpu_torch.runtime.dictionary import Dictionary
from mapreduce_rust_tpu_torch.runtime.metrics import JobStats

_TRUTHY = ("1", "true", "on", "yes")


class SanitizerError(RuntimeError):
    """A thread-ownership invariant was violated (this is a bug in the
    calling code, not a recoverable condition — it fires at the exact
    write that would have raced)."""


def sanitize_enabled(cfg=None) -> bool:
    """True when the sanitizer is on for this process: ``MR_SANITIZE`` in
    the environment (so a whole test suite can opt in without touching
    configs) or ``Config.sanitize`` on the job."""
    if os.environ.get("MR_SANITIZE", "").strip().lower() in _TRUTHY:
        return True
    return bool(cfg is not None and getattr(cfg, "sanitize", False))


class SanitizedJobStats(JobStats):
    """JobStats whose attribute writes are gated on a registered-writer set.

    The creator thread is registered at construction; a legitimately
    concurrent writer (the ingest producer, which owns bytes_in/chunks/
    forced_cuts by design) announces itself with ``register_writer()`` —
    the base JobStats carries the same method as a no-op, so production
    code calls it unconditionally. Everything else that writes from an
    unregistered thread is the orphaned-pool-thread race, and raises
    here.

    Still a real dataclass instance: ``dataclasses.asdict`` (the manifest
    path) and ``stats.phase(...)`` work unchanged — ``_writers`` is not a
    dataclass field, so it never leaks into telemetry.
    """

    def __init__(self) -> None:
        object.__setattr__(self, "_writers", {threading.get_ident()})
        super().__init__()

    def register_writer(self) -> None:
        self._writers.add(threading.get_ident())

    def __setattr__(self, name, value):
        writers = getattr(self, "_writers", None)
        if writers is not None and threading.get_ident() not in writers:
            raise SanitizerError(
                f"JobStats.{name} written from thread "
                f"{threading.current_thread().name!r}, which never "
                "registered as a writer — stats are owned by the consumer "
                "thread; pool-submitted work must return values, not "
                "mutate shared state (mrlint rule: stats-ownership)"
            )
        object.__setattr__(self, name, value)


class SanitizedDictionary(Dictionary):
    """Dictionary whose mutating methods assert the owner thread.

    The ingest and host-map engines fold scan results into the dictionary
    on exactly one consumer thread (driver docstrings state it; this
    enforces it). ``set_owner()`` hands the instance to another thread
    explicitly — the only sanctioned transfer.
    """

    def __init__(self, *args, **kwargs) -> None:
        self._owner = threading.get_ident()
        super().__init__(*args, **kwargs)

    def set_owner(self, ident: int | None = None) -> None:
        self._owner = threading.get_ident() if ident is None else ident

    def _assert_owner(self, what: str) -> None:
        if threading.get_ident() != self._owner:
            raise SanitizerError(
                f"Dictionary.{what} called from thread "
                f"{threading.current_thread().name!r}, but the dictionary "
                "is owned by another thread — scan workers return results; "
                "only the consumer thread folds them (use set_owner() for "
                "an explicit handoff)"
            )

    def add_scanned(self, words, keys):
        self._assert_owner("add_scanned")
        return super().add_scanned(words, keys)

    def add_scanned_raw(self, raw, ends, keys):
        self._assert_owner("add_scanned_raw")
        return super().add_scanned_raw(raw, ends, keys)

    def merge(self, other):
        self._assert_owner("merge")
        return super().merge(other)


def new_job_stats(cfg=None) -> JobStats:
    """JobStats, sanitized when enabled — the driver/worker construction
    point (one factory so the enablement check lives in one place)."""
    return SanitizedJobStats() if sanitize_enabled(cfg) else JobStats()


def new_dictionary(cfg=None, **kwargs) -> Dictionary:
    """Dictionary, sanitized when enabled; kwargs pass through (budgets)."""
    cls = SanitizedDictionary if sanitize_enabled(cfg) else Dictionary
    return cls(**kwargs)


def check_shard_route(keys, n_shards: int, shard_index: int) -> None:
    """Called by the fold plane's shard threads when sanitizing: every key
    handed to fold shard ``shard_index`` must actually route there
    (``shard_of_packed(packed, S) == shard_index``). The per-shard
    dictionary's owner-thread assert catches a fold from the WRONG THREAD;
    this catches the complementary bug — a router that sends a key to the
    wrong shard's queue, where the right thread would fold it into the
    wrong shard and silently split that key's dedup/collision state across
    two dictionaries. Vectorized (one numpy pass per routed slice), and
    only ever called under the sanitizer."""
    import numpy as np

    from mapreduce_rust_tpu_torch.runtime.dictionary import shard_ids_of_packed

    if len(keys) == 0:
        return
    keys = np.asarray(keys)
    packed = (
        keys[:, 0].astype(np.uint64) << np.uint64(32)
    ) | keys[:, 1].astype(np.uint64)
    routed = shard_ids_of_packed(packed, n_shards)
    wrong = routed != np.uint64(shard_index)
    if wrong.any():
        i = int(np.nonzero(wrong)[0][0])
        raise SanitizerError(
            f"fold shard {shard_index} received key "
            f"({int(keys[i, 0])}, {int(keys[i, 1])}) which routes to shard "
            f"{int(routed[i])} of {n_shards} — the "
            "router mis-partitioned a scan result; that key's dedup and "
            "collision state would silently split across two shard "
            "dictionaries"
        )


def check_arena_owner(owner_pid: int, owner_tid: int) -> None:
    """Called by native/host._buffers on arena reuse when sanitizing: a
    scratch arena observed under a different (pid, tid) than the one that
    allocated it means thread-local state crossed a fork or a handoff —
    its contents are another context's scan results."""
    if (os.getpid(), threading.get_ident()) != (owner_pid, owner_tid):
        raise SanitizerError(
            f"native scan arena allocated by (pid={owner_pid}, "
            f"tid={owner_tid}) observed from (pid={os.getpid()}, "
            f"tid={threading.get_ident()}) — arenas are per-thread scratch "
            "and must never cross a fork or thread handoff"
        )

"""How the device engine launches its per-chunk step.

``_stream_single`` (runtime/driver.py) runs ``make_step_fns``'s
``map_combine`` then ``merge`` once per chunk. The work is the same ops on
the same shapes in the same order either way; how it is launched follows
the device the job runs on:

- :class:`EagerStep` (a CPU device): the ops run one by one from Python,
  and each chunk's outputs stay in its own handle.
- :class:`GraphStep` (a card): the step is captured once into a CUDA graph
  over static buffers and replayed once per chunk. A chunk costs the host
  a copy into a pinned staging buffer, one host-to-device copy and one
  graph launch, in place of a fresh pinned allocation and ~200 launches.

Both hand out a handle per dispatched chunk. The driver resolves a window
of handles with one read of their counters (``counts``), spills their
evicted tails (``evicted``), replays the overflowed chunks from their host
bytes (``chunk_host``) and then releases them.

The graph reads the chunk and its doc id from one static device buffer
and carries the state from one replay to the next in static buffers. Each
chunk's counters and evicted tail go to a slot of a ring, chosen by a slot
index copied with the chunk, so they outlive the later replays until the
driver drains them; each slot has its own pinned staging buffer, whose
bytes an overflow replay reads. A slot is handed out again only after its
release (:class:`SlotRing`).

An instance serves one job at a time: :func:`checkout` takes an idle one
of the same key from the process's pool, or builds (captures) a new one,
and takes it back when the job's stream ends without an exception. Two
jobs of one process (a service's in-process workers, a fleet's map tasks)
never share one.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading

import numpy as np
import torch

from mapreduce_rust_tpu_torch.core.kv import SENTINEL_I32, KVBatch
from mapreduce_rust_tpu_torch.ops.tokenize_cuda import count_launch, uncounted

#: Idle instances the process keeps (each holds its state, rings and the
#: graph's memory on the card, and its pinned staging on the host).
IDLE_MAX = 4


class SlotRing:
    """The slots of a ring of ``n``: ``acquire`` hands out the free slot
    released longest ago, ``release`` takes back a slot in use. Handing
    out a slot in use, or taking back a free one, raises."""

    def __init__(self, n: int) -> None:
        self.n = n
        self._free = collections.deque(range(n))
        self._busy: set = set()

    def acquire(self) -> int:
        if not self._free:
            raise RuntimeError(f"all {self.n} slots of the ring are in flight")
        slot = self._free.popleft()
        self._busy.add(slot)
        return slot

    def release(self, slot: int) -> None:
        if slot not in self._busy:
            raise RuntimeError(f"slot {slot} is not in flight")
        self._busy.remove(slot)
        self._free.append(slot)


class EagerStep:
    """The step launched op by op; a handle is the chunk's own
    ``(ovf, ev_count, evicted, chunk_host)``. On a card the chunk's host
    side is pinned and its copy asynchronous, and the handle keeps the
    pinned source alive until the chunk is drained."""

    replays = 0  # never a graph replay

    def __init__(self, map_combine, merge, merge_capacity: int,
                 device: torch.device) -> None:
        self._map_combine, self._merge = map_combine, merge
        self.device = device
        self.state = KVBatch.empty(merge_capacity, device)

    def dispatch(self, data: np.ndarray, doc_id: int):
        host = torch.from_numpy(data)
        chunk = host
        if self.device.type != "cpu":
            host = host.pin_memory()
            chunk = host.to(self.device, non_blocking=True)
        update, ovf = self._map_combine(chunk, doc_id)
        # Merge dispatches immediately: an overflowed update is empty on
        # the device, so merging before the flag reaches the host is safe.
        self.state, evicted, ev_count = self._merge(self.state, update)
        return ovf, ev_count, evicted, host

    @staticmethod
    def counts(handles) -> list:
        """(ovf, ev_count) of each handle, in ONE device→host copy."""
        flat = torch.stack([x for h in handles for x in h[:2]]).cpu().tolist()
        return list(zip(flat[::2], flat[1::2]))

    @staticmethod
    def evicted(handle) -> KVBatch:
        return handle[2]

    @staticmethod
    def chunk_host(handle) -> torch.Tensor:
        return handle[3]

    @staticmethod
    def release(handle) -> None:
        pass


class GraphStep:
    """The step captured into one CUDA graph; a handle is a slot of the
    ring (``slots`` of them). Built outside every loop: the constructor
    runs the step once and then captures it (:func:`_capture`)."""

    def __init__(self, map_combine, merge, chunk_bytes: int, merge_capacity: int,
                 slots: int, device: torch.device) -> None:
        self.device = device
        self.replays = 0
        self._chunk_bytes = chunk_bytes
        # The doc id and slot index sit 16-byte aligned after the chunk, so
        # one copy moves all three.
        self._meta_at = -(-chunk_bytes // 16) * 16
        self._in = torch.full((self._meta_at + 16,), 0x20, dtype=torch.uint8,
                              device=device)
        self._in[self._meta_at:] = 0
        chunk = self._in[:chunk_bytes]
        meta = self._in[self._meta_at:self._meta_at + 8].view(torch.int32)
        self._state = KVBatch.empty(merge_capacity, device)
        self._counts = torch.zeros((slots, 2), dtype=torch.int32, device=device)
        self._tails: "KVBatch | None" = None  # [slots, tail capacity] lanes
        self._ring = SlotRing(slots)
        self._staging: list = [None] * slots  # pinned, allocated at first use

        def step() -> None:
            update, ovf = map_combine(chunk, meta[0])
            new, evicted, ev_count = merge(self._state, update)
            for dst, src in zip(self._state, new):
                dst.copy_(src)
            if self._tails is None:  # the first run learns the tail's width
                self._tails = KVBatch(*(
                    torch.empty((slots, x.shape[0]), dtype=x.dtype, device=device)
                    for x in evicted))
            slot = meta[1:].to(torch.int64)
            self._counts.index_copy_(0, slot, torch.stack([ovf, ev_count])[None])
            for dst, src in zip(self._tails, evicted):
                dst.index_copy_(0, slot, src[None])

        self.graph = _capture(step, device)
        self.reset()

    def reset(self) -> None:
        """The empty state and every slot free: the start of a job."""
        self._state.k1.fill_(SENTINEL_I32)
        self._state.k2.fill_(SENTINEL_I32)
        self._state.value.zero_()
        self._state.valid.zero_()
        self._ring = SlotRing(self._ring.n)
        self.replays = 0

    @property
    def state(self) -> KVBatch:
        return self._state

    @state.setter
    def state(self, new: KVBatch) -> None:
        for dst, src in zip(self._state, new):
            dst.copy_(src)

    def dispatch(self, data: np.ndarray, doc_id: int) -> int:
        slot = self._ring.acquire()
        stage = self._staging[slot]
        if stage is None:
            stage = self._staging[slot] = torch.zeros(
                self._in.shape[0], dtype=torch.uint8,
                pin_memory=self.device.type == "cuda")
        host = stage.numpy()
        host[:self._chunk_bytes] = data
        host[self._meta_at:self._meta_at + 8].view(np.int32)[:] = (doc_id, slot)
        # The slot's previous chunk was drained, so no copy reads the
        # staging buffer any more; this copy is stream-ordered after the
        # last replay that read the static input.
        self._in.copy_(stage, non_blocking=True)
        self.graph.replay()
        count_launch()
        self.replays += 1
        return slot

    def counts(self, slots) -> list:
        """(ovf, ev_count) of each slot, in ONE device→host copy of the
        ring's counters."""
        c = self._counts.cpu().numpy()
        return [(int(c[s, 0]), int(c[s, 1])) for s in slots]

    def evicted(self, slot: int) -> KVBatch:
        return KVBatch(*(x[slot] for x in self._tails))

    def chunk_host(self, slot: int) -> torch.Tensor:
        return self._staging[slot][:self._chunk_bytes]

    def release(self, slot: int) -> None:
        self._ring.release(slot)


def _capture(step, device: torch.device) -> "torch.cuda.CUDAGraph":
    """``step`` run once, then captured; neither counts a launch of the
    scan kernel. The run loads the kernel library and fills the caches
    the step reads (an app's query keys), which capture may not do, and
    allocates the ring's tails on the job's stream. ``thread_local``:
    other threads (the ingest pool, another job) go on launching while
    this one captures."""
    with torch.cuda.device(device), uncounted():
        step()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            step()
    return graph


def app_key(app):
    """The app as a graph's key: its fields that only egress reads
    (splitters, corpus bounds) cleared, so jobs that differ in those share
    the graph."""
    return dataclasses.replace(app, splitters=(), corpus_bounds=())


_idle: list = []  # (key, instance), the most recently returned last
_idle_lock = threading.Lock()


@contextlib.contextmanager
def checkout(key, build):
    """Yields ``(instance, built)``: an idle instance of ``key`` taken from
    the process's pool and reset (``built`` False), else ``build()``
    (``built`` True). The instance goes back to the pool, which keeps the ``IDLE_MAX``
    most recently returned, only when the block exits without an
    exception: a failed job's work may still be in flight."""
    with _idle_lock:
        hit = next((i for i in range(len(_idle) - 1, -1, -1) if _idle[i][0] == key),
                   None)
        inst = _idle.pop(hit)[1] if hit is not None else None
    built = inst is None
    if built:
        inst = build()
    else:
        inst.reset()
    yield inst, built
    with _idle_lock:
        _idle.append((key, inst))
        del _idle[:-IDLE_MAX]

"""Streaming log-bucket histogram (a copy of
``mapreduce_rust_tpu/runtime/histogram.py``, stdlib only).

In the port it holds the per-run ``write_s`` distribution of the spill
writers (runtime/spill.py).

The observability doctrine (runtime/metrics.py) allows per-chunk/per-round
work but forbids per-record work; this histogram keeps that contract: an
``add`` is one bisect over a fixed 61-edge table plus a few scalar updates,
cheap enough for every site we currently only sum — per-window host-map
scan/glue durations, per-round ``mesh.all_to_all`` latencies, per-RPC
control-plane latencies, per-task attempt durations. Manifests then carry
p50/p95/p99/max where they used to carry a single total, which is what
lets ``doctor`` tell a uniformly slow run from one dragged by a tail.

Design constraints:

- **Fixed log-spaced buckets** (5 per decade, 1e-7 .. 1e5 — sub-µs RPC
  dispatch up to day-long jobs), so two histograms from different
  processes/runs are ALWAYS mergeable bucket-for-bucket: no rescaling, no
  resampling. Values outside the range land in under/overflow buckets and
  their percentiles clamp to the exact min/max, which are tracked
  separately.
- **Sparse serialization**: only occupied buckets are written, so a
  manifest histogram is a few dozen ints, not a 61-wide array.
- **Self-describing**: ``to_dict`` precomputes p50/p95/p99 so a reader
  (the doctor, a human in a manifest diff) needs no bucket math; the
  buckets ride along for exact re-merging.

No imports beyond the stdlib and no jax: control-plane processes
(coordinator, doctor CLI) must use this without dragging in a backend.
"""

from __future__ import annotations

import math
from bisect import bisect_right

_PER_DECADE = 5
_LO_EXP = -7            # lowest edge 1e-7 (0.1 µs)
_HI_EXP = 5             # highest edge 1e5 (~28 h)
_N_BUCKETS = (_HI_EXP - _LO_EXP) * _PER_DECADE
#: Bucket edges; value v lands in bucket ``bisect_right(EDGES, v)``:
#: index 0 is the underflow bucket (v <= 1e-7, incl. zeros/negatives),
#: index len(EDGES) the overflow bucket (v > 1e5).
EDGES: tuple = tuple(
    10.0 ** (_LO_EXP + i / _PER_DECADE) for i in range(_N_BUCKETS + 1)
)

SCHEMA = 1


class Histogram:
    """Mergeable streaming histogram with exact count/sum/min/max and
    log-bucket percentiles (geometric-midpoint estimate, clamped to the
    exact extremes — a one-sample histogram reports p50 == that sample).
    """

    __slots__ = ("count", "total", "min", "max", "buckets")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets: dict[int, int] = {}

    def add(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        idx = bisect_right(EDGES, v)
        self.buckets[idx] = self.buckets.get(idx, 0) + 1

    def merge(self, other: "Histogram") -> "Histogram":
        self.count += other.count
        self.total += other.total
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        for idx, n in other.buckets.items():
            self.buckets[idx] = self.buckets.get(idx, 0) + n
        return self

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> "float | None":
        """Value at quantile ``q`` in [0, 1], or None when empty. Exact at
        the extremes (min/max), bucket-geometric-midpoint in between."""
        if self.count == 0:
            return None
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        # Nearest-rank: the bucket holding the ceil(q * count)-th sample.
        target = max(int(math.ceil(q * self.count)), 1)
        cum = 0
        for idx in sorted(self.buckets):
            cum += self.buckets[idx]
            if cum >= target:
                return self._representative(idx)
        return self.max  # unreachable unless buckets were hand-corrupted

    def _representative(self, idx: int) -> float:
        if idx <= 0:                     # underflow: <= the lowest edge
            return self.min
        if idx >= len(EDGES):            # overflow: > the highest edge
            return self.max
        mid = math.sqrt(EDGES[idx - 1] * EDGES[idx])
        # Clamp to the exact extremes so a near-empty histogram never
        # reports a percentile outside the observed range.
        return min(max(mid, self.min), self.max)

    def to_dict(self) -> dict:
        """JSON-safe sparse form, percentiles precomputed for readers."""
        d: dict = {
            "schema": SCHEMA,
            "count": self.count,
            "total": round(self.total, 9),
        }
        if self.count:
            d["min"] = self.min
            d["max"] = self.max
            d["mean"] = round(self.mean, 9)
            d["p50"] = self.percentile(0.50)
            d["p95"] = self.percentile(0.95)
            d["p99"] = self.percentile(0.99)
            d["buckets"] = {str(i): n for i, n in sorted(self.buckets.items())}
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Histogram":
        """Inverse of ``to_dict`` — the precomputed percentiles are
        recomputable from the buckets and are ignored on load."""
        h = cls()
        h.count = int(d.get("count", 0))
        h.total = float(d.get("total", 0.0))
        if h.count:
            h.min = float(d["min"])
            h.max = float(d["max"])
            h.buckets = {int(i): int(n) for i, n in (d.get("buckets") or {}).items()}
        return h

    def summary(self, scale: float = 1.0, digits: int = 6) -> dict:
        """Compact {count, mean, p50, p95, p99, max} view, values × scale
        (e.g. scale=1e3 renders second-valued samples in ms)."""
        if self.count == 0:
            return {"count": 0}
        return {
            "count": self.count,
            "mean": round(self.mean * scale, digits),
            "p50": round((self.percentile(0.50) or 0.0) * scale, digits),
            "p95": round((self.percentile(0.95) or 0.0) * scale, digits),
            "p99": round((self.percentile(0.99) or 0.0) * scale, digits),
            "max": round(self.max * scale, digits),
        }

    def __len__(self) -> int:
        return self.count

    def __repr__(self) -> str:
        if not self.count:
            return "Histogram(empty)"
        return (
            f"Histogram(n={self.count}, p50={self.percentile(0.5):.4g}, "
            f"p99={self.percentile(0.99):.4g}, max={self.max:.4g})"
        )

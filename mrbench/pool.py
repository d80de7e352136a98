"""A run's pool of input files, made from the seed by the configuration's
generator, with the generator's truth for each file and the order in which
the window's jobs take them.

The files live in memory (``memfd_create``) and the jobs read them by
their ``/proc/self/fd/<n>`` paths: a read as warm as one from the page
cache of a file just written, and no write to the disk. They go when the
pool is closed or the process ends.

The sizes come from the traffic mix alone, so every seed gets the same
set of sizes; the seed changes the words and the order. Consecutive jobs
step through the pool by a stride near ``0.618 * files`` that is coprime
with the count, so every file is taken once per cycle and no two
consecutive jobs share a file (with two or more files).
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np

from mrbench import gen
from mrbench.reference import hashing


def plan_sizes(traffic: dict) -> list[int]:
    """Bytes of each pool file (at most: a generator cuts between tokens).
    ``job_bytes.law``: ``fixed``, ``bytes`` each, ``pool_files`` of them."""
    law = traffic["job_bytes"]
    if law["law"] == "fixed":
        return [int(law["bytes"])] * int(traffic["pool_files"])
    raise ValueError(f"unknown job size law {law['law']!r}")


def stride(n: int) -> int:
    """The step through a pool of ``n`` files: coprime with ``n``, nearest
    to ``0.618 n``, at least 1."""
    if n <= 2:
        return 1
    target = n * (math.sqrt(5) - 1) / 2
    return min((g for g in range(1, n) if math.gcd(g, n) == 1),
               key=lambda g: (abs(g - target), g))


@dataclasses.dataclass
class Pool:
    files: list[str]
    truth: list[tuple[np.ndarray, np.ndarray]]  # (word ids, counts) per file
    words: list[bytes]
    parts: np.ndarray        # output partition of each word id
    warmup: str
    offset: int
    step: int
    fds: list = dataclasses.field(default_factory=list)

    def file_for(self, job: int) -> int:
        """Index of the file that job ``job`` of the window reads."""
        return (self.offset + job * self.step) % len(self.files)

    def nbytes(self, index: int) -> int:
        return os.path.getsize(self.files[index])

    def close(self) -> None:
        for fd in self.fds:
            os.close(fd)
        self.fds.clear()


def _in_memory(name: str, data: np.ndarray) -> int:
    fd = os.memfd_create(name)
    view = memoryview(data)
    while view:
        view = view[os.write(fd, view):]
    return fd


def build(config: dict, traffic: dict, seed: int, device, reduce_n: int) -> Pool:
    """Draw the pool and the warm-up file (the last one)."""
    g = gen.load(config["generator"])
    params = config["generator_params"]
    sizes = plan_sizes(traffic)
    fds, truth = [], []
    try:
        for i, size in enumerate(sizes + [int(traffic["warmup_bytes"])]):
            data, ids, counts = g.generate(params, seed, i, size, device)
            fds.append(_in_memory(f"in-{i:04d}.txt", data))
            truth.append((ids, counts))
    except BaseException:
        for fd in fds:
            os.close(fd)
        raise
    files = [f"/proc/self/fd/{fd}" for fd in fds]
    words = g.vocabulary(params, seed)
    n = len(sizes)
    return Pool(files=files[:n], truth=truth[:n], words=words,
                parts=hashing.partitions(words, reduce_n), warmup=files[n],
                offset=gen.stream_seed(seed, -2, 0) % n, step=stride(n), fds=fds)

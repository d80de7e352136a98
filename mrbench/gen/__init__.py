"""Input generators, one module per generator name (a configuration's
``generator`` key). Each module has:

- ``vocabulary(params, seed) -> list[bytes]``: the words, indexed by id;
- ``generate(params, seed, index, nbytes, device) -> (data, ids, counts)``:
  file ``index`` of the pool, at most ``nbytes`` long and cut between
  tokens, as a uint8 numpy array, with the generator's own truth: the ids
  of the words it drew and how often it drew each (int64 numpy arrays,
  counts > 0).

The draws run on ``device`` (the card in a run, the CPU in tests) from a
``torch.Generator`` seeded by :func:`stream_seed`, so one seed gives the
same bytes on one kind of device.
"""

from __future__ import annotations

import importlib

_MASK63 = (1 << 63) - 1


def stream_seed(seed: int, index: int, salt: int) -> int:
    """A 63-bit seed for file ``index`` of a pool: a splitmix64 step over the
    run's seed (any width), the file's index and the generator's salt."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + (index + 1) * 0xBF58476D1CE4E5B9
         + salt) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 31
    return x & _MASK63


def load(name: str):
    """The generator module called ``name``."""
    return importlib.import_module(f"mrbench.gen.{name}")

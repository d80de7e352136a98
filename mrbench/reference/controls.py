"""Controls: the plain reference put in the program's place with one
guarantee of the configuration broken. Each returns the lines it would
write, per partition, for one job; the run's comparison must fail them.
A configuration names its control under ``control``.

- ``int16_counts``: counts are held in 16 bits (wrapping) where the
  configuration guarantees exact counts in 32. A job whose most frequent
  words pass 32,767 writes them wrong.
- ``fixed_cuts``: the input is cut every ``chunk_bytes`` bytes wherever the
  cut falls, where the configuration guarantees that a chunk ends between
  words. A word that straddles a cut counts as its two pieces.
"""

from __future__ import annotations

import collections

import numpy as np

from mrbench.reference import hashing
from mrbench.reference.word_count import expected

_WS = np.zeros(256, dtype=bool)
_WS[list(b" \t\n\r\x0b\x0c")] = True


def int16_counts(words, parts, ids, counts, reduce_n, path, program):
    return expected(words, parts, ids, counts.astype(np.int16).astype(np.int64), reduce_n)


def fixed_cuts(words, parts, ids, counts, reduce_n, path, program):
    step = int(program["chunk_bytes"])
    data = np.fromfile(path, dtype=np.uint8)
    ws = _WS[data]
    index = {w: i for i, w in enumerate(words)}
    tally = collections.Counter(dict(zip(ids.tolist(), counts.tolist())))
    extra: collections.Counter = collections.Counter()
    for p in range(step, len(data), step):
        if ws[p - 1] or ws[p]:
            continue
        s, e = p, p
        while s > 0 and not ws[s - 1]:
            s -= 1
        while e < len(data) and not ws[e]:
            e += 1
        tally[index[data[s:e].tobytes()]] -= 1
        for piece in (data[s:p].tobytes(), data[p:e].tobytes()):
            if piece in index:
                tally[index[piece]] += 1
            else:
                extra[piece] += 1
    got_ids = np.array(sorted(tally), dtype=np.int64)
    got = expected(words, parts, got_ids,
                   np.array([tally[i] for i in got_ids.tolist()], dtype=np.int64),
                   reduce_n)
    new = sorted(extra)
    for w, r in zip(new, hashing.partitions(new, reduce_n).tolist() if new else []):
        got[r].append(b"%s %d" % (w, extra[w]))
    for lines in got:
        lines.sort()
    return got


CONTROLS = {"int16_counts": int16_counts, "fixed_cuts": fixed_cuts}

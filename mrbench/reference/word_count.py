"""word_count's answer for one job and the comparison with what the
program wrote.

The answer is, for every word drawn at least once, the line
``b"<word> <count>"`` in partition ``partition(word)``; a partition's file
``mr-{r}.txt`` holds its lines, each ending in a newline. Lines are
compared as a multiset per partition, so the order within a file is not
judged.
"""

from __future__ import annotations

import collections
import os

import numpy as np


def expected(words: list[bytes], parts: np.ndarray, ids: np.ndarray,
             counts: np.ndarray, reduce_n: int) -> list[list[bytes]]:
    """Sorted lines of each partition, from the generator's draws: word
    ``ids[i]`` drawn ``counts[i]`` times."""
    out: list[list[bytes]] = [[] for _ in range(reduce_n)]
    for i, c, r in zip(ids.tolist(), counts.tolist(), parts[ids].tolist()):
        if c > 0:
            out[r].append(b"%s %d" % (words[i], c))
    for lines in out:
        lines.sort()
    return out


def read_outputs(output_dir: str, reduce_n: int) -> list[bytes]:
    """The bytes of each ``mr-{r}.txt`` (empty where a file is missing)."""
    blobs = []
    for r in range(reduce_n):
        path = os.path.join(output_dir, f"mr-{r}.txt")
        try:
            with open(path, "rb") as f:
                blobs.append(f.read())
        except FileNotFoundError:
            blobs.append(b"")
    return blobs


def mismatched_lines(got: list[bytes], want: list[list[bytes]]) -> int:
    """Lines of the symmetric difference between the files' lines and the
    answer, over every partition: a wrong count is two lines, a missing,
    extra or misplaced word one line per partition it is wrong in. Files
    with more partitions than the answer count every extra line."""
    bad = 0
    for r, blob in enumerate(got):
        lines = want[r] if r < len(want) else []
        if blob == b"".join(line + b"\n" for line in lines):
            continue
        have = blob.split(b"\n")
        if have and have[-1] == b"":
            have.pop()
        else:
            bad += 1  # no newline after the last line
        diff = collections.Counter(have)
        diff.subtract(lines)
        bad += sum(abs(v) for v in diff.values())
    for r in range(len(got), len(want)):
        bad += len(want[r])
    return bad

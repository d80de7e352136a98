"""The plain reference: its hash lane, its answer on a hand-counted
corpus, the comparison, and the controls."""

from __future__ import annotations

import numpy as np

from mrbench.reference import controls, hashing, word_count


def _loop_lane(word: bytes, which: int) -> int:
    h, m = ((0x811C9DC5, 0x01000193), (0x9E3779B9, 1000003))[which]
    for b in word:
        h = (h * m + b + 1) & 0xFFFFFFFF
    return h


WORDS = [b"the", b"cat", b"sat", b"on", b"mat", b"a", b"zebra_9", b"\xc3\xa9t\xc3\xa9"]


def test_lanes_equal_a_loop():
    for which in (0, 1):
        got = hashing.lane(WORDS, which).tolist()
        assert got == [_loop_lane(w, which) for w in WORDS]


def test_lane_is_the_programs_key():
    # The frozen copy agrees with the program's hash at this commit.
    from mapreduce_rust_tpu_torch.core.hashing import hash_word

    assert [tuple(p) for p in zip(hashing.lane(WORDS, 0).tolist(),
                                  hashing.lane(WORDS, 1).tolist())] == \
        [hash_word(w) for w in WORDS]


def _hand_answer(text: bytes, reduce_n: int) -> list[list[bytes]]:
    counts: dict = {}
    for w in text.split():
        counts[w] = counts.get(w, 0) + 1
    parts: list[list[bytes]] = [[] for _ in range(reduce_n)]
    for w, c in counts.items():
        parts[_loop_lane(w, 0) % reduce_n].append(w + b" " + str(c).encode())
    return [sorted(p) for p in parts]


def test_expected_on_a_hand_counted_corpus():
    text = b"the cat sat on the mat\nthe cat\ta zebra_9 on on on"
    vocab = sorted(set(text.split()))
    ids = np.arange(len(vocab))
    counts = np.array([text.split().count(w) for w in vocab])
    got = word_count.expected(vocab, hashing.partitions(vocab, 3), ids, counts, 3)
    assert got == _hand_answer(text, 3)
    assert sum(map(len, got)) == 7 and b"on 4" in sum(got, [])


def _blobs(parts):
    return [b"".join(x + b"\n" for x in p) for p in parts]


def test_mismatched_lines_counts_each_fault():
    want = [[b"a 1", b"b 2"], [b"c 3"]]
    assert word_count.mismatched_lines(_blobs(want), want) == 0
    assert word_count.mismatched_lines([b"b 2\na 1\n", b"c 3\n"], want) == 0  # order
    assert word_count.mismatched_lines(_blobs([[b"a 1", b"b 3"], [b"c 3"]]), want) == 2
    assert word_count.mismatched_lines(_blobs([[b"a 1"], [b"c 3"]]), want) == 1
    assert word_count.mismatched_lines(_blobs([[b"a 1"], [b"b 2", b"c 3"]]), want) == 2
    assert word_count.mismatched_lines(_blobs([[b"a 1", b"b 2", b"b 2"], [b"c 3"]]),
                                       want) == 1
    assert word_count.mismatched_lines([b"a 1\nb 2", b"c 3\n"], want) == 1
    assert word_count.mismatched_lines([b"a 1\nb 2\n"], want) == 1  # a file missing


def test_read_outputs(tmp_path):
    (tmp_path / "mr-0.txt").write_bytes(b"x 1\n")
    assert word_count.read_outputs(str(tmp_path), 2) == [b"x 1\n", b""]


def test_int16_counts_wrap_large_counts():
    words = [b"a", b"b", b"c"]
    parts = hashing.partitions(words, 2)
    ids, counts = np.arange(3), np.array([5, 40_000, 70_000])
    want = word_count.expected(words, parts, ids, counts, 2)
    got = controls.int16_counts(words, parts, ids, counts, 2, None, {})
    assert sum(got, []).count(b"a 5") == 1
    assert b"b 40000" not in sum(got, []) and b"c 70000" not in sum(got, [])
    # b wraps below 0 and drops out (1 line); c wraps to 4464 (2 lines).
    assert word_count.mismatched_lines(_blobs(got), want) == 3


def test_fixed_cuts_splits_straddling_words(tmp_path):
    text = b"abc de fgh\n"
    path = tmp_path / "in.txt"
    path.write_bytes(text)
    words = [b"abc", b"de", b"fgh", b"gh"]
    parts = hashing.partitions(words, 2)
    ids, counts = np.array([0, 1, 2]), np.array([1, 1, 1])
    got = controls.fixed_cuts(words, parts, ids, counts, 2, str(path), {"chunk_bytes": 2})
    # cuts at 2 (ab|c), 4 and 6 (at a space), 8 (f|gh, a word of the list),
    # 10 (before the LF)
    lines = sorted(sum(got, []))
    assert lines == sorted([b"ab 1", b"c 1", b"de 1", b"f 1", b"gh 1"])
    want = word_count.expected(words, parts, ids, counts, 2)
    assert word_count.mismatched_lines(_blobs(got), want) > 0

"""Hadoop ``RandomTextWriter`` text, the input of HiBench's WordCount: lines
of a key of ``key_words`` words and a value of ``value_words`` words, every
word drawn uniformly from a list of ``words`` words. A range ``[lo, hi]``
draws ``lo + nextInt(hi - lo)`` words, as RandomTextWriter does: from
``lo`` to ``hi - 1``. A line is ``key words<TAB>value words<LF>``, words
joined by single spaces.

The list itself is not at hand, so it is made from the seed: ``words``
distinct words whose lengths follow ``length_weights``, of which
``capitalised`` start with a capital letter and the rest are lowercase (a
fixed multiset of lengths and a fixed count of capitals, the same for every
seed, so every seed gives the same amount of work).

params: ``{"words": 1000, "length_weights": {"2": 1, ...}, "capitalised": 107,
"key_words": [5, 10], "value_words": [20, 100]}``.
"""

from __future__ import annotations

import functools
import json

import numpy as np
import torch

from mrbench.gen import stream_seed

SALT = 0x7E47
ALPHABET = b"abcdefghijklmnopqrstuvwxyz"


def length_multiset(params: dict) -> np.ndarray:
    """How many words of each length: ``words`` split by the weights,
    largest remainders first, ties to the shorter length."""
    n = int(params["words"])
    lw = sorted((int(k), float(v)) for k, v in params["length_weights"].items())
    lengths = np.array([k for k, _ in lw])
    w = np.array([v for _, v in lw])
    exact = w / w.sum() * n
    take = np.floor(exact).astype(np.int64)
    rest = n - int(take.sum())
    order = np.lexsort((lengths, -(exact - take)))
    take[order[:rest]] += 1
    return np.repeat(lengths, take)


def vocabulary(params: dict, seed: int) -> list[bytes]:
    return list(_vocabulary(json.dumps(params, sort_keys=True), int(seed)))


@functools.lru_cache(maxsize=2)
def _vocabulary(params_json: str, seed: int) -> tuple[bytes, ...]:
    params = json.loads(params_json)
    rng = np.random.default_rng(stream_seed(seed, -1, SALT))
    sizes = length_multiset(params)
    words: list[bytes] = []
    for length in np.unique(sizes).tolist():
        need = int((sizes == length).sum())
        if need > len(ALPHABET) ** length:
            raise ValueError(f"randomtext: no {need} distinct words of {length} letters")
        have: dict[bytes, None] = {}
        while len(have) < need:
            draw = rng.integers(0, len(ALPHABET), (need - len(have), length))
            for row in draw:
                have.setdefault(bytes(ALPHABET[i] for i in row), None)
        words.extend(have)
    for i in rng.choice(len(words), int(params["capitalised"]), replace=False).tolist():
        words[i] = words[i][:1].upper() + words[i][1:]
    return tuple(words)


@functools.lru_cache(maxsize=2)
def _table(params_json: str, seed: int, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(bytes uint8[V, maxlen + 1], lengths int64[V]) on ``device``; the
    column after each word is left for its separator."""
    words = _vocabulary(params_json, seed)
    width = max(map(len, words)) + 1
    mat = np.zeros((len(words), width), dtype=np.uint8)
    for i, w in enumerate(words):
        mat[i, : len(w)] = np.frombuffer(w, dtype=np.uint8)
    lens = np.fromiter(map(len, words), dtype=np.int64, count=len(words))
    dev = torch.device(device)
    return torch.from_numpy(mat).to(dev), torch.from_numpy(lens).to(dev)


def generate(params: dict, seed: int, index: int, nbytes: int, device):
    table, lens = _table(json.dumps(params, sort_keys=True), int(seed), str(device))
    dev = table.device
    n_words = table.shape[0]
    kmin, kmax = (int(x) for x in params["key_words"])
    vmin, vmax = (int(x) for x in params["value_words"])
    mean_tok = float(lens.double().mean()) + 1.0
    mean_line = ((kmin + kmax - 1) / 2 + (vmin + vmax - 1) / 2) * mean_tok
    g = torch.Generator(device=dev)
    g.manual_seed(stream_seed(seed, index, SALT))
    n_lines = int(nbytes / mean_line * 1.25) + 8
    kl = torch.randint(kmin, kmax, (n_lines,), generator=g, device=dev)
    vl = torch.randint(vmin, vmax, (n_lines,), generator=g, device=dev)
    wl = kl + vl
    ids = torch.randint(0, n_words, (int(wl.sum()),), generator=g, device=dev)
    tok_bytes = lens[ids] + 1
    word_end = torch.cumsum(wl, 0)                 # words up to each line's end
    line_end_byte = torch.cumsum(tok_bytes, 0)[word_end - 1]
    m = int((line_end_byte <= nbytes).sum())
    if m == 0:
        raise ValueError(f"randomtext: {nbytes} bytes hold no line")
    if m == n_lines:
        raise RuntimeError("randomtext: drew too few lines for the file")
    n_tok = int(word_end[m - 1])
    ids, tok_lens = ids[:n_tok], lens[ids[:n_tok]]
    sep = torch.full((n_tok,), ord(" "), dtype=torch.uint8, device=dev)
    starts = word_end[:m] - wl[:m]
    sep[starts + kl[:m] - 1] = ord("\t")
    sep[word_end[:m] - 1] = ord("\n")
    mat = table[ids]
    mat[torch.arange(n_tok, device=dev), tok_lens] = sep
    keep = torch.arange(mat.shape[1], device=dev)[None, :] <= tok_lens[:, None]
    data = mat[keep].cpu().numpy()
    counts = torch.bincount(ids, minlength=n_words)
    nz = torch.nonzero(counts).flatten()
    return data, nz.cpu().numpy(), counts[nz].cpu().numpy()

"""Zipf-distributed words of natural-language lengths: word ``r`` is drawn
with probability proportional to ``(r + 1) ** -s`` over ``ranks`` ranks by
inverse-CDF sampling (the law of ``bench_torch.py``'s Zipf corpus, seeded
from the run's seed instead of a constant), and each is written with one
space after it.

Word lengths follow the law of abbreviation (Zipf 1935: the more frequent
a word, the shorter), fitted to a table of token lengths in running text:
ranks are laid out in order of frequency over ``[0, 1)`` by their
probability mass, and rank ``r`` takes the length whose share of tokens in
``token_length_pct`` covers the middle of its stretch. So the text's
token lengths follow the table, as far as whole ranks allow, and a chunk
cut falls inside a word as it does in prose. Words of one length are
distinct strings of lowercase letters: the ``k``-th word of length ``L``
spells ``k * MULT`` modulo ``26 ** min(L, 13)`` in base 26, padded on the
left by a fixed run of letters. The vocabulary is the same for every seed.

params: ``{"s": 1.05, "ranks": 2097152, "token_length_pct": {"1": 2.998, ...}}``.
"""

from __future__ import annotations

import functools
import json

import numpy as np
import torch

from mrbench.gen import stream_seed

SALT = 0x21F5
#: Prime to 26, so multiplying by it permutes the residues mod 26**m; under
#: 2**40, so its product with an index under 2**22 fits in int64.
MULT = 0x9E3779B97F
ALPHABET = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", dtype=np.uint8)


def _probabilities(s: float, ranks: int) -> np.ndarray:
    w = np.arange(1, ranks + 1, dtype=np.float64) ** -s
    return w / w.sum()


def lengths(params: dict) -> np.ndarray:
    """Letters of each rank's word, int64[ranks], non-decreasing in rank."""
    ranks = int(params["ranks"])
    p = _probabilities(float(params["s"]), ranks)
    table = sorted((int(k), float(v)) for k, v in params["token_length_pct"].items())
    share = np.array([v for _, v in table])
    edges = np.cumsum(share / share.sum())[:-1]
    mid = np.cumsum(p) - p / 2
    return np.array([k for k, _ in table], dtype=np.int64)[np.searchsorted(edges, mid,
                                                                           side="right")]


@functools.lru_cache(maxsize=2)
def _spelled(params_json: str) -> tuple[np.ndarray, np.ndarray]:
    """(uint8[ranks, maxlen + 1] letters with a space after each word,
    int64[ranks] lengths)."""
    lens = lengths(json.loads(params_json))
    width = int(lens.max()) + 1
    mat = np.zeros((len(lens), width), dtype=np.uint8)
    for length in np.unique(lens).tolist():
        rows = np.flatnonzero(lens == length)
        m = min(length, 13)
        if len(rows) > 26 ** m:
            raise ValueError(f"zipf: {len(rows)} words of {length} letters")
        k = np.arange(len(rows), dtype=np.int64) * (MULT % 26 ** m) % 26 ** m
        digits = np.empty((len(rows), m), dtype=np.int64)
        for j in range(m - 1, -1, -1):
            digits[:, j] = k % 26
            k //= 26
        pad = (np.arange(length - m) * 7 + length) % 26
        mat[rows, : length - m] = ALPHABET[pad]
        mat[rows, length - m: length] = ALPHABET[digits]
        mat[rows, length] = ord(" ")
    return mat, lens


def vocabulary(params: dict, seed: int) -> list[bytes]:
    """Every rank's word; the same for every seed."""
    mat, lens = _spelled(json.dumps(params, sort_keys=True))
    flat = mat.tobytes()
    width = mat.shape[1]
    return [flat[i * width: i * width + n] for i, n in enumerate(lens.tolist())]


@functools.lru_cache(maxsize=2)
def _tables(params_json: str, device: str):
    """(cdf float64[ranks], tokens uint8[ranks, maxlen + 1], token bytes
    int64[ranks]) on ``device``."""
    params = json.loads(params_json)
    dev = torch.device(device)
    cdf = torch.from_numpy(np.cumsum(_probabilities(float(params["s"]),
                                                    int(params["ranks"])))).to(dev)
    cdf /= cdf[-1].clone()
    mat, lens = _spelled(params_json)
    return cdf, torch.from_numpy(mat).to(dev), torch.from_numpy(lens + 1).to(dev)


def generate(params: dict, seed: int, index: int, nbytes: int, device):
    ranks = int(params["ranks"])
    cdf, table, tok_bytes = _tables(json.dumps(params, sort_keys=True), str(device))
    dev = cdf.device
    mean_tok = float((tok_bytes.double() * torch.diff(cdf, prepend=cdf.new_zeros(1))).sum())
    n = int(nbytes / mean_tok * 1.05) + 64
    g = torch.Generator(device=dev)
    g.manual_seed(stream_seed(seed, index, SALT))
    u = torch.rand(n, generator=g, dtype=torch.float64, device=dev)
    drawn = torch.searchsorted(cdf, u).clamp_(max=ranks - 1)
    del u
    ends = torch.cumsum(tok_bytes[drawn], 0)
    m = int((ends <= nbytes).sum())
    if m == 0:
        raise ValueError(f"zipf: {nbytes} bytes hold no token")
    if m == n:
        raise RuntimeError("zipf: drew too few tokens for the file")
    drawn = drawn[:m]
    mat = table[drawn]
    keep = torch.arange(mat.shape[1], device=dev)[None, :] < tok_bytes[drawn][:, None]
    data = mat[keep].cpu().numpy()
    counts = torch.bincount(drawn, minlength=ranks)
    ids = torch.nonzero(counts).flatten()
    return data, ids.cpu().numpy(), counts[ids].cpu().numpy()

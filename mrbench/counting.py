"""What the token-hash scan's work needs, counted from the bytes it is
given, whatever implements it: every byte read once, and one 8-byte key
(two 32-bit lanes) written once per token.

A token is a maximal run of non-whitespace bytes that holds at least one
word byte (ASCII letters, digits, ``_``, every byte >= 0x80); other ASCII
bytes inside a run are dropped and do not split it. Whitespace is ASCII
space, tab, LF, CR, VT and FF.
"""

from __future__ import annotations

import numpy as np

KEY_BYTES = 8

WHITESPACE = np.zeros(256, dtype=bool)
WHITESPACE[list(b" \t\n\r\x0b\x0c")] = True
WORD = np.zeros(256, dtype=bool)
WORD[list(b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_")] = True
WORD[0x80:] = True


def count_tokens(data: np.ndarray, block: int = 1 << 22) -> int:
    """Tokens in a uint8 array: word bytes whose previous non-dropped byte
    is whitespace or the start, counted block by block."""
    total = 0
    prev_ws = True
    for b0 in range(0, len(data), block):
        x = data[b0:b0 + block]
        ws, wc = WHITESPACE[x], WORD[x]
        kept_ws = ws[ws | wc]
        if not len(kept_ws):
            continue
        before = np.empty_like(kept_ws)
        before[0] = prev_ws
        before[1:] = kept_ws[:-1]
        total += int(np.count_nonzero(~kept_ws & before))
        prev_ws = bool(kept_ws[-1])
    return total


def scan_bytes(nbytes: int, tokens: int) -> int:
    """Device-memory bytes the scan needs: the input read once, a key
    written per token."""
    return nbytes + KEY_BYTES * tokens

"""Published peaks, from the vendor's data sheet. The card's power limit
is reported beside every share of a peak, since a card set below its
maximum runs slower under load."""

PEAKS = {
    # NVIDIA H100 SXM5 80 GB, at its 700 W maximum.
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def peak(kind: str, what: str) -> "float | None":
    """A peak of the card called ``kind``; None for a card not in the table."""
    return PEAKS.get(kind, {}).get(what)

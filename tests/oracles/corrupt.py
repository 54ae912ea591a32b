"""Corrupt-stream batches and the oracle's verdict on them.

Shared by the garbage-parity tests and chip_smoke.py's corrupt-input phase:
a batch mixes pure garbage, truncated valid streams and bit-flipped valid
streams; the oracle decoders give the expected verdict for each row.
"""

from __future__ import annotations

import numpy as np

GARBAGE, TRUNCATED, FLIPPED = 0, 1, 2


def corrupt_batch(rng, streams, width: int):
    """Rows of corrupt input built from valid ``streams`` (one per row).

    Returns (comp uint8[B, width], sizes int32[B], kinds int[B]): each row
    is random garbage, a truncation of its stream, or its stream with one
    bit flipped, chosen at random.  Bytes past a truncation stay in the row
    so a decoder that reads past ``sizes`` is caught.
    """
    b = len(streams)
    comp = np.zeros((b, width), np.uint8)
    sizes = np.zeros((b,), np.int32)
    kinds = rng.integers(0, 3, b)
    for i, st in enumerate(streams):
        if kinds[i] == GARBAGE:
            n = int(rng.integers(1, width + 1))
            comp[i, :n] = rng.integers(0, 256, n)
            sizes[i] = n
            continue
        n = min(len(st), width)
        comp[i, :n] = np.frombuffer(st[:n], np.uint8)
        if kinds[i] == TRUNCATED:
            sizes[i] = max(1, n // int(rng.integers(2, 5)))
        else:
            k = int(rng.integers(0, max(1, n - 1)))
            comp[i, k] ^= 1 << int(rng.integers(0, 8))
            sizes[i] = n
    return comp, sizes, kinds


def oracle_verdict(decode, stream: bytes, capacity: int):
    """The oracle's decoded bytes, or None where it rejects the stream or
    the output would exceed ``capacity``."""
    try:
        out = decode(stream)
    except (ValueError, IndexError):
        return None
    return out if len(out) <= capacity else None

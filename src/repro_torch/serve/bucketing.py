"""Bucketed prefill widths (host side).

A prompt of length ``p <= buckets[-1]`` is padded up to the smallest bucket
that holds it, so serving sees a closed set of prefill shapes; past the top
bucket the ladder extends by doubling (:func:`ladder_rung`). The chunked and
packed admission plans of the reference wait for the continuous-serving
slice.
"""
from __future__ import annotations

from typing import Optional, Sequence

__all__ = ["DEFAULT_PREFILL_BUCKETS", "validate_buckets", "bucket_of", "ladder_rung"]

DEFAULT_PREFILL_BUCKETS = (32, 64, 128, 256)


def validate_buckets(buckets: Sequence[int]) -> tuple[int, ...]:
    """Normalize + validate a bucket ladder: ints, strictly increasing."""
    out = tuple(int(b) for b in buckets)
    if not out:
        raise ValueError("prefill_buckets must be non-empty (or None to disable)")
    if any(b < 1 for b in out):
        raise ValueError(f"buckets must be positive, got {out}")
    if any(b >= c for b, c in zip(out, out[1:])):
        raise ValueError(f"buckets must be strictly increasing, got {out}")
    return out


def bucket_of(n: int, buckets: Sequence[int]) -> Optional[int]:
    """Smallest bucket holding ``n`` tokens; None past the top bucket."""
    for b in buckets:
        if n <= b:
            return int(b)
    return None


def ladder_rung(n: int, buckets: Sequence[int]) -> int:
    """Like :func:`bucket_of` but on the ladder extended past the top bucket
    by doubling — always resolves."""
    b = bucket_of(n, buckets)
    if b is not None:
        return b
    r = int(buckets[-1])
    while r < n:
        r *= 2
    return r

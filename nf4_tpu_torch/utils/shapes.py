"""Shape bucketing shared by prefill and scoring paths."""

from __future__ import annotations

__all__ = ["bucket_len"]


def bucket_len(n: int, minimum: int = 16) -> int:
    """The smallest power of two >= max(n, minimum)."""
    b = minimum
    while b < n:
        b *= 2
    return b

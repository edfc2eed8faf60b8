"""Shape padding helpers: the port's copy of ``bm25_tpu/utils/padding.py``."""

from __future__ import annotations


def next_multiple(x: int, m: int) -> int:
    """Smallest multiple of m that is >= x (>= m for x <= 0)."""
    if x <= 0:
        return m
    return ((x + m - 1) // m) * m


def next_pow2_at_least(x: int) -> int:
    """Smallest power of two >= x (>= 1)."""
    if x <= 1:
        return 1
    return 1 << (x - 1).bit_length()


def cdiv(a: int, b: int) -> int:
    return -(-a // b)

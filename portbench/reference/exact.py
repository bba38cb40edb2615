"""Exact values and the comparison of one answer with the reference's.

Every value is compared as what it says: a decimal or a double as the
exact rational it denotes (`fractions.Fraction`), a bigint as an int, a
date or a varchar as its text.  A decimal's gap is counted in units of
its column's last digit, so a gap of 1 is one cent at scale 2."""
from __future__ import annotations

from fractions import Fraction
from typing import Optional, Sequence, Tuple


def half_away(num: int, den: int) -> int:
    """num / den rounded half away from zero (SQL decimal division)."""
    q, r = divmod(abs(num), den)
    q += 2 * r >= den
    return q if num >= 0 else -q


def dec(unscaled: int, scale: int) -> Fraction:
    return Fraction(unscaled, 10 ** scale)


def rounded(x: float, scale: int) -> Fraction:
    """A binary float cast to a decimal of `scale`, rounded half away
    from zero: what a program that computes a DECIMAL column in floating
    point returns."""
    f = Fraction(x) * 10 ** scale
    return dec(half_away(f.numerator, f.denominator), scale)


def gap_units(got, want: Fraction, scale: int) -> Fraction:
    """|got - want| in units of the last digit at `scale`; a value that
    is missing where one is due counts as infinitely far."""
    if got is None or want is None:
        return Fraction(0) if got is None and want is None else Fraction(10**30)
    return abs(Fraction(got) - want) * 10 ** scale


def compare_rows(want: Sequence[tuple], got: Sequence[tuple],
                 scales: Sequence[Optional[int]]) -> Tuple[bool, Fraction]:
    """(wrong, widest gap): columns with a scale are numbers held to their
    gap (any gap is wrong), the others must be equal."""
    wrong = len(want) != len(got)
    widest = Fraction(0)
    for w, g in zip(want, got):
        if len(w) != len(g):
            wrong = True
            continue
        for k, scale in enumerate(scales):
            if scale is None:
                wrong |= w[k] != g[k]
            else:
                d = gap_units(g[k], w[k], scale)
                widest = max(widest, d)
                wrong |= d != 0
    return wrong, widest

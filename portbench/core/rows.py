"""Answers as the comparison reads them: a decimal column's value is the
exact number it states (text, a Decimal, or a float whose shortest form
is its decimal text), a double column's value is its exact binary value,
every other value is kept as it came."""
from __future__ import annotations

from decimal import Decimal
from fractions import Fraction
from typing import List, Sequence


def number(value, decimal_column: bool):
    if value is None or isinstance(value, bool) or isinstance(value, int):
        return value
    if isinstance(value, float):
        return Fraction(Decimal(repr(value))) if decimal_column else Fraction(value)
    if isinstance(value, (str, Decimal)) and decimal_column:
        return Fraction(Decimal(value))
    return value


def canonical(rows: Sequence[Sequence], decimal_columns: Sequence[bool]) -> List[tuple]:
    return [tuple(number(v, d) for v, d in zip(r, decimal_columns)) for r in rows]

"""SQL type system for the TPU-native engine.

Reference parity: /root/reference/core/trino-spi/src/main/java/io/trino/spi/type/
(BigintType, IntegerType, DoubleType, DecimalType, VarcharType, DateType,
BooleanType, TimestampType...).  Unlike the reference's MethodHandle-based
``TypeOperators`` (TypeOperators.java:70), type operations here lower directly
to jax/XLA ops over fixed-dtype device arrays.

TPU-first representation choices:
  - BIGINT   -> int64  (jax x64 enabled; TPU emulates int64 as 2x int32)
  - INTEGER  -> int32
  - DOUBLE   -> float64 (CPU-exact; TPC-H money math avoids doubles entirely)
  - DECIMAL(p,s) -> scaled int64 fixed point (p<=18).  The reference uses
    Int128 two-limb math (spi/type/Int128Math.java); TPC-H needs only p<=15
    for stored columns, and aggregate sums stay within int64 at SF100.
  - VARCHAR  -> dictionary codes (int32) on device + host-side dictionary,
    the analog of the reference's DictionaryBlock (spi/block/DictionaryBlock.java:33)
  - DATE     -> int32 days since 1970-01-01
  - BOOLEAN  -> bool_
  - TIMESTAMP -> int64 microseconds since epoch (reference uses ps precision;
    us is enough for TPC-H/DS and fits one limb)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Type:
    """Base SQL type. Instances are interned-ish via module constants."""

    name: str

    def __str__(self) -> str:  # pragma: no cover
        return self.name

    # --- device representation ---------------------------------------
    @property
    def np_dtype(self) -> np.dtype:
        raise NotImplementedError(self.name)

    @property
    def is_dictionary(self) -> bool:
        return False

    @property
    def is_decimal(self) -> bool:
        return False

    @property
    def comparable(self) -> bool:
        return True

    @property
    def orderable(self) -> bool:
        return True

    @property
    def is_array(self) -> bool:
        return False

    @property
    def is_map(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class FixedWidthType(Type):
    dtype: str = "int64"

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(self.dtype)


@dataclasses.dataclass(frozen=True)
class DecimalType(Type):
    """Fixed-point decimal, scaled by 10**scale.

    p <= 18 stores one int64 lane; p > 18 ("wide") stores a two-limb
    (n, 2) int64 lane — the Int128ArrayBlock analog
    (spi/block/Int128ArrayBlock.java:28, spi/type/Int128Math.java)."""

    precision: int = 18
    scale: int = 0

    def __post_init__(self):
        if self.precision > 38:
            raise ValueError("decimal precision exceeds 38")

    @property
    def wide(self) -> bool:
        return self.precision > 18

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype("int64")

    @property
    def is_decimal(self) -> bool:
        return True

    def __str__(self) -> str:
        return f"decimal({self.precision},{self.scale})"


@dataclasses.dataclass(frozen=True)
class ArrayType(Type):
    """ARRAY(element).  Device representation: dictionary-encoded — int32
    codes into a host-side dictionary of distinct python tuples (the
    DictionaryBlock-over-ArrayBlock analog; reference spi/block/
    ArrayBlock.java stores offsets+flat values, which here live host-side
    since array columns are off the hot TPC path).  Element values inside
    dictionary entries use IR-constant conventions (decimal -> unscaled
    int, date -> epoch days, varchar -> str)."""

    element: "Type" = None

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype("int32")  # dictionary code

    @property
    def is_dictionary(self) -> bool:
        return True

    @property
    def is_array(self) -> bool:
        return True

    @property
    def orderable(self) -> bool:
        return False

    def __str__(self) -> str:
        return f"array({self.element})"


@dataclasses.dataclass(frozen=True)
class MapType(Type):
    """MAP(key, value) — dictionary-encoded like ArrayType: entries are
    tuples of (key, value) pairs in IR-constant conventions (the
    DictionaryBlock-over-MapBlock analog of spi/block/MapBlock.java)."""

    key: "Type" = None
    value: "Type" = None

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype("int32")

    @property
    def is_dictionary(self) -> bool:
        return True

    @property
    def is_map(self) -> bool:
        return True

    @property
    def orderable(self) -> bool:
        return False

    def __str__(self) -> str:
        return f"map({self.key}, {self.value})"


@dataclasses.dataclass(frozen=True)
class VarcharType(Type):
    """Dictionary-encoded varchar. length is advisory (like VARCHAR(n))."""

    length: Optional[int] = None

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype("int32")  # dictionary code

    @property
    def is_dictionary(self) -> bool:
        return True

    def __str__(self) -> str:
        return "varchar" if self.length is None else f"varchar({self.length})"


BOOLEAN = FixedWidthType("boolean", "bool_")
TINYINT = FixedWidthType("tinyint", "int8")
SMALLINT = FixedWidthType("smallint", "int16")
INTEGER = FixedWidthType("integer", "int32")
BIGINT = FixedWidthType("bigint", "int64")
DOUBLE = FixedWidthType("double", "float64")
REAL = FixedWidthType("real", "float32")
DATE = FixedWidthType("date", "int32")
TIMESTAMP = FixedWidthType("timestamp", "int64")
VARCHAR = VarcharType("varchar")
UNKNOWN = FixedWidthType("unknown", "int8")  # type of NULL literal


def decimal(precision: int, scale: int) -> DecimalType:
    return DecimalType("decimal", precision, scale)


def array_of(element: Type) -> ArrayType:
    return ArrayType("array", element)


def map_of(key: Type, value: Type) -> MapType:
    return MapType("map", key, value)


def varchar(length: Optional[int] = None) -> VarcharType:
    return VarcharType("varchar", length)


_NUMERIC_ORDER = {
    "tinyint": 0,
    "smallint": 1,
    "integer": 2,
    "bigint": 3,
    "real": 5,
    "double": 6,
}


def is_numeric(t: Type) -> bool:
    return t.name in _NUMERIC_ORDER or t.is_decimal


def is_integral(t: Type) -> bool:
    return t.name in ("tinyint", "smallint", "integer", "bigint")


def common_super_type(a: Type, b: Type) -> Type:
    """Result type of mixing a and b in arithmetic/comparison.

    Mirrors the reference's TypeCoercion (sql/analyzer/TypeCoercion.java)
    for the numeric subset we support.
    """
    if a == b:
        return a
    if a.name == "unknown":
        return b
    if b.name == "unknown":
        return a
    if a.is_decimal and b.is_decimal:
        scale = max(a.scale, b.scale)
        intd = max(a.precision - a.scale, b.precision - b.scale)
        return decimal(min(38, intd + scale), scale)
    if a.is_decimal and is_integral(b):
        return common_super_type(a, decimal(18, 0))
    if b.is_decimal and is_integral(a):
        return common_super_type(decimal(18, 0), b)
    if (a.is_decimal and b.name in ("double", "real")) or (
        b.is_decimal and a.name in ("double", "real")
    ):
        return DOUBLE
    if a.name in _NUMERIC_ORDER and b.name in _NUMERIC_ORDER:
        return a if _NUMERIC_ORDER[a.name] >= _NUMERIC_ORDER[b.name] else b
    if a.name == "date" and b.name == "timestamp":
        return TIMESTAMP
    if a.name == "timestamp" and b.name == "date":
        return TIMESTAMP
    if getattr(a, "is_array", False) or getattr(b, "is_array", False):
        if (
            getattr(a, "is_array", False)
            and getattr(b, "is_array", False)
        ):
            return array_of(common_super_type(a.element, b.element))
        raise TypeError(f"no common type for {a} and {b}")
    if a.is_dictionary and b.is_dictionary:
        return VARCHAR
    raise TypeError(f"no common type for {a} and {b}")


def parse_type(s: str) -> Type:
    """Parse a SQL type name like 'decimal(12,2)' or 'array(bigint)'."""
    s = s.strip().lower()
    if s.startswith("array"):
        inner = s[s.index("(") + 1 : s.rindex(")")]
        return array_of(parse_type(inner))
    if s.startswith("map"):
        inner = s[s.index("(") + 1 : s.rindex(")")]
        depth = 0
        for i, ch in enumerate(inner):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
            elif ch == "," and depth == 0:
                return map_of(
                    parse_type(inner[:i]), parse_type(inner[i + 1:])
                )
        raise ValueError(f"bad map type: {s}")
    if s.startswith("decimal"):
        if "(" in s:
            inner = s[s.index("(") + 1 : s.rindex(")")]
            parts = [p.strip() for p in inner.split(",")]
            p = int(parts[0])
            sc = int(parts[1]) if len(parts) > 1 else 0
            return decimal(p, sc)
        return decimal(18, 0)
    if s.startswith("varchar") or s.startswith("char"):
        if "(" in s:
            return varchar(int(s[s.index("(") + 1 : s.rindex(")")]))
        return VARCHAR
    simple = {
        "boolean": BOOLEAN,
        "tinyint": TINYINT,
        "smallint": SMALLINT,
        "integer": INTEGER,
        "int": INTEGER,
        "bigint": BIGINT,
        "double": DOUBLE,
        "real": REAL,
        "date": DATE,
        "timestamp": TIMESTAMP,
        "unknown": UNKNOWN,
    }
    if s in simple:
        return simple[s]
    raise ValueError(f"unknown type: {s}")

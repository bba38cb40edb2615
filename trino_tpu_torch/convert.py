"""Carry state between the JAX package and the port.

The engine has no weights: its state is the loaded tables and their
dictionaries, and what crosses between the engines is pages.  A page
travels as a neutral *state* — names, type names, row count and, per
column, numpy values, validity and dictionary (str entries, or tuples
for array and map columns) — so this module never
imports the JAX package: the caller hands in the other side's page
classes and type parser when converting back.

    state = page_state(jax_page)              # any Page-shaped object
    port_page = page_from_state(state)        # the port's Page
    jax_page = page_from_state(page_state(port_page),
                               page_module=trino_tpu.page,
                               parse_type=trino_tpu.types.parse_type)

`pages_identical` compares two pages byte for byte (dtypes, shapes and
bytes of every values/validity array, dictionaries, names and types).
`assert_pages_match(a, b, rtol)` is the same comparison except for the
values of float64 columns (all of them, or those named in `columns`),
which agree when |x - y| <= rtol * max(|x|, |y|), NaN matching NaN:
float64 results of transcendental functions and floating-point sums
are not bit-reproducible across engines or atomic orders.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from . import page as _page
from . import types as _types


def _entries(d) -> np.ndarray:
    """A dictionary's entries as a 1-D object array: varchar entries as
    str, array entries as tuples of elements and map entries as tuples
    of (key, value) pairs, both in IR-constant form."""
    out = np.empty(len(d), dtype=object)
    out[:] = [x if isinstance(x, tuple) else str(x) for x in d]
    return out


def page_state(page) -> dict:
    """Neutral, numpy-only description of a Page (either package)."""
    cols = []
    for c in page.columns:
        d = c.dictionary
        cols.append({
            "type": str(c.type),
            "values": np.asarray(c.values)[: page.count].copy(),
            "validity": (
                None if c.validity is None
                else np.asarray(c.validity)[: page.count].copy()
            ),
            "dictionary": None if d is None else _entries(d),
        })
    return {"names": list(page.names), "count": int(page.count), "columns": cols}


def page_from_state(
    state: dict, page_module=None, parse_type: Optional[Callable] = None
):
    """Page from a state; the port's Page unless another package's
    `page_module` (with Column/Page) and `parse_type` are given."""
    pm = page_module or _page
    pt = parse_type or _types.parse_type
    cols = [
        pm.Column(pt(c["type"]), c["values"], c["validity"], c["dictionary"])
        for c in state["columns"]
    ]
    return pm.Page(cols, state["count"], list(state["names"]))


def _float_close(x: np.ndarray, y: np.ndarray, rtol: float) -> bool:
    if x.dtype != np.float64 or y.dtype != np.float64 or x.shape != y.shape:
        return False
    both_nan = np.isnan(x) & np.isnan(y)
    same = (x == y) | both_nan
    with np.errstate(invalid="ignore", over="ignore"):
        close = np.abs(x - y) <= rtol * np.maximum(np.abs(x), np.abs(y))
    return bool(np.all(same | close))


def _diff(a: dict, b: dict, rtol: Optional[float] = None,
          columns=None) -> Optional[str]:
    if a["names"] != b["names"]:
        return f"names {a['names']} != {b['names']}"
    if a["count"] != b["count"]:
        return f"row count {a['count']} != {b['count']}"
    for name, ca, cb in zip(a["names"], a["columns"], b["columns"]):
        if ca["type"] != cb["type"]:
            return f"{name}: type {ca['type']} != {cb['type']}"
        for part in ("values", "validity"):
            x, y = ca[part], cb[part]
            if (x is None) != (y is None):
                return f"{name}: {part} present on one side only"
            if x is None:
                continue
            if x.dtype != y.dtype or x.shape != y.shape or x.tobytes() != y.tobytes():
                if (rtol is not None and part == "values"
                        and x.dtype == np.float64
                        and (columns is None or name in columns)
                        and _float_close(x, y, rtol)):
                    continue
                return f"{name}: {part} differ"
        da, db = ca["dictionary"], cb["dictionary"]
        if (da is None) != (db is None) or (
            da is not None and list(da) != list(db)
        ):
            return f"{name}: dictionaries differ"
    return None


def pages_identical(a, b) -> bool:
    return _diff(page_state(a), page_state(b)) is None


def assert_pages_identical(a, b) -> None:
    d = _diff(page_state(a), page_state(b))
    if d is not None:
        raise AssertionError(f"pages differ: {d}")


def pages_match(a, b, rtol: float, columns=None) -> bool:
    return _diff(page_state(a), page_state(b), rtol, columns) is None


def assert_pages_match(a, b, rtol: float, columns=None) -> None:
    """Pages identical byte for byte, except the values of float64
    columns (those named in `columns`, else all), held at relative
    tolerance `rtol`."""
    d = _diff(page_state(a), page_state(b), rtol, columns)
    if d is not None:
        raise AssertionError(f"pages differ (float64 rtol {rtol}): {d}")

"""Carry state between the JAX package and the port.

The engine has no weights: its state is the loaded tables and their
dictionaries, and what crosses between the engines is pages.  A page
travels as a neutral *state* — names, type names, row count and, per
column, numpy values, validity and dictionary — so this module never
imports the JAX package: the caller hands in the other side's page
classes and type parser when converting back.

    state = page_state(jax_page)              # any Page-shaped object
    port_page = page_from_state(state)        # the port's Page
    jax_page = page_from_state(page_state(port_page),
                               page_module=trino_tpu.page,
                               parse_type=trino_tpu.types.parse_type)

`pages_identical` compares two pages byte for byte (dtypes, shapes and
bytes of every values/validity array, dictionaries, names and types).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from . import page as _page
from . import types as _types


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
            "dictionary": (
                None if d is None else np.array([str(x) for x in d], dtype=object)
            ),
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


def _diff(a: dict, b: dict) -> Optional[str]:
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

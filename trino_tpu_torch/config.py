"""Typed configuration + session properties.

Reference parity: airlift @Config binding (369 setters; TaskManagerConfig,
QueryManagerConfig, FeaturesConfig...) and SystemSessionProperties.java
(151 typed session properties) — reduced to the properties this port's
optimizer, analyzer and executor actually read.  Any other name, including
the JAX package's runtime properties (spill, memory, retries, caches,
observatories), raises KeyError at SET time rather than being silently
ignored; values are validated and typed at SET time.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict


@dataclasses.dataclass(frozen=True)
class PropertyMetadata:
    name: str
    description: str
    parse: Callable[[str], Any]
    default: Any


def _bool(s: str) -> bool:
    if str(s).lower() in ("true", "1", "yes"):
        return True
    if str(s).lower() in ("false", "0", "no"):
        return False
    raise ValueError(f"not a boolean: {s}")


def _padding_ladder(s: str) -> str:
    """Validate (but keep as string) the bucketed-batch ABI spec: the
    executor resolves it to an exec.shapes.PaddingLadder lazily so SET
    SESSION stays import-light."""
    from .exec.shapes import parse_ladder_spec

    parse_ladder_spec(str(s))  # raises ValueError on a bad spec
    return str(s).strip().lower()


def _megakernels(s: str) -> str:
    v = str(s).strip().lower()
    if v not in ("auto", "on", "off"):
        raise ValueError(f"megakernels must be auto|on|off, got: {s}")
    return v


def _join_distribution(s: str) -> str:
    v = str(s).strip().lower()
    if v not in ("automatic", "broadcast", "partitioned"):
        raise ValueError(
            "join_distribution_type must be "
            f"automatic|broadcast|partitioned, got: {s}"
        )
    return v


# single source of truth for the automatic join-distribution threshold
# (total build-side rows across all tasks/devices)
BROADCAST_JOIN_THRESHOLD_ROWS = 1 << 20

SESSION_PROPERTIES: Dict[str, PropertyMetadata] = {
    p.name: p
    for p in [
        PropertyMetadata(
            "distributed",
            "execute over the full device mesh instead of one device",
            _bool, False,
        ),
        PropertyMetadata(
            "num_devices",
            "mesh size for distributed execution (0 = all devices)",
            int, 0,
        ),
        PropertyMetadata(
            "join_distribution_type",
            "automatic | broadcast | partitioned "
            "(DetermineJoinDistributionType analog)",
            _join_distribution, "automatic",
        ),
        PropertyMetadata(
            "broadcast_join_threshold_rows",
            "automatic mode: build sides with more estimated rows are "
            "hash-partitioned instead of replicated (join-max-broadcast-"
            "table-size analog, in rows)",
            int, BROADCAST_JOIN_THRESHOLD_ROWS,
        ),
        PropertyMetadata(
            "reorder_joins",
            "stats-based join-graph reordering (ReorderJoins / "
            "EliminateCrossJoins analogs); off keeps the FROM order",
            _bool, True,
        ),
        PropertyMetadata(
            "distinct_agg_rewrite",
            "decompose global count(DISTINCT x) into count over a "
            "hash-partitionable Distinct (scales out / tiles)",
            _bool, True,
        ),
        PropertyMetadata(
            "direct_address_joins",
            "probe stats-proven-unique dense integer build keys through "
            "a direct-address table (one gather) instead of sort-merge",
            _bool, True,
        ),
        PropertyMetadata(
            "compaction",
            "tighten survivors of selective filters/joins into a smaller "
            "static capacity (downstream ops run at the reduced width)",
            _bool, True,
        ),
        PropertyMetadata(
            "fd_group_key_pruning",
            "drop group-by keys functionally dependent (via unique-build "
            "joins) on another key; they return as arbitrary() values",
            _bool, True,
        ),
        PropertyMetadata(
            "memo_optimizer",
            "iterative Memo exploration with cost-compared alternatives "
            "(join order/commutation/distribution); off keeps the greedy "
            "single-pass choices",
            _bool, True,
        ),
        PropertyMetadata(
            "statistics_enabled",
            "cost the plan from collected/connector table statistics "
            "(histograms, NDV); off degrades every table to a bare "
            "row count (statistics-enabled analog)",
            _bool, True,
        ),
        PropertyMetadata(
            "in_list_pushdown",
            "derive discrete-value TupleDomains from IN lists for "
            "connector split/row-group pruning",
            _bool, True,
        ),
        PropertyMetadata(
            "column_pruning",
            "prune unreferenced columns into table scans "
            "(PruneUnreferencedOutputs)",
            _bool, True,
        ),
        PropertyMetadata(
            "scan_cache_enabled",
            "cache device-resident scans across queries (warm-HBM reuse)",
            _bool, True,
        ),
        PropertyMetadata(
            "padding_ladder",
            "bucketed-batch ABI rungs every padded capacity quantizes "
            "onto before tracing: geometric (128*2^k, the default) | "
            "off (legacy next-multiple-of-128) | explicit "
            "comma-separated rung list",
            _padding_ladder, "geometric",
        ),
        PropertyMetadata(
            "padding_ladder_file",
            "census-tuned ladder JSON written by scripts/bucket_ladder.py "
            "--emit; when set (and readable) it overrides padding_ladder; "
            "empty = use the padding_ladder spec",
            str, "",
        ),
        PropertyMetadata(
            "megakernels",
            "fused scan->filter->aggregate megakernel (one pass per "
            "scan column): auto (on for CUDA tensors, off on the CPU) | "
            "on (the plain version on the CPU, for parity tests) | off",
            _megakernels, "auto",
        ),
    ]
}


class SessionProperties:
    """Per-session typed property bag (Session.java + SET SESSION)."""

    def __init__(self, overrides: Dict[str, Any] | None = None):
        self._values: Dict[str, Any] = {}
        for k, v in (overrides or {}).items():
            self.set(k, v)

    def set(self, name: str, value):
        meta = SESSION_PROPERTIES.get(name)
        if meta is None:
            raise KeyError(f"unknown session property: {name}")
        self._values[name] = (
            meta.parse(value) if isinstance(value, str) else value
        )

    def get(self, name: str):
        meta = SESSION_PROPERTIES.get(name)
        if meta is None:
            raise KeyError(f"unknown session property: {name}")
        return self._values.get(name, meta.default)

    def show(self) -> list:
        return [
            (name, str(self.get(name)), str(meta.default), meta.description)
            for name, meta in sorted(SESSION_PROPERTIES.items())
        ]

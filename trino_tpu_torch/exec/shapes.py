"""The engine-wide bucketed-batch ABI: one home for shape quantization.

Every fragment input shape the engine traces is quantized here before
it reaches XLA.  Historically each call site rounded row counts up to
the next multiple of the TPU lane width (128) independently — so every
distinct split size was a distinct padded shape, hence a distinct
compiled program, and the compile cache only helped when traffic
repeated *exact* sizes.  The :class:`PaddingLadder` replaces that with
a small monotone set of rungs (geometric by default, census-tuned via
``scripts/bucket_ladder.py --emit``): arbitrary sizes collapse onto a
handful of shapes per kernel family, bounding both the number of
compiled programs (|ladder| per family) and the padded-vs-actual waste
(≤ the inter-rung ratio, 2x for the geometric ladder).

Correctness does not depend on the rung chosen: executors thread the
true row count alongside the padded buffers (the ``__count__`` traced
scalar) and mask with ``arange(cap) < count``, so any capacity ≥ count
is byte-identical.  The ladder only decides how much slack rides along.

This module must stay import-light (stdlib only): it is imported by
``exec/local.py``, ``exec/streaming.py``, ``parallel/mesh_executor.py``,
``cache/signature.py`` and the observatory, and must never create an
import cycle.

The ``((n + lane - 1) // lane) * lane`` idiom is permitted ONLY in this
file — ``scripts/check_pad_discipline.py`` lints the rest of the tree
for ad-hoc copies.
"""
from __future__ import annotations

import json
from bisect import bisect_left
from typing import Dict, Iterable, Optional, Sequence, Tuple

DEFAULT_LANE = 128

# geometric ladder spans 128 .. ~1B rows; above the top rung quantize()
# continues doubling, so the program count stays bounded at any scale
_GEOMETRIC_TOP = 1 << 30


def lane_align(n: int, lane: int = DEFAULT_LANE) -> int:
    """Round ``n`` up to the next multiple of ``lane`` (min ``lane``).

    The single permitted home of the next-multiple idiom; every other
    module quantizes through a :class:`PaddingLadder` (whose "off" mode
    degenerates to this function).
    """
    n = int(n)
    if n <= lane:
        return lane
    return ((n + lane - 1) // lane) * lane


class PaddingLadder:
    """A monotone set of lane-aligned capacities that row counts
    quantize onto before tracing.

    ``rungs == ()`` is the legacy escape hatch (``padding_ladder=off``):
    :meth:`quantize` degenerates to plain lane alignment and
    :meth:`size` is 0, signalling "unbounded program count" to callers
    that report ladder occupancy.
    """

    __slots__ = ("rungs", "lane", "source")

    def __init__(
        self,
        rungs: Sequence[int] = (),
        lane: int = DEFAULT_LANE,
        source: str = "explicit",
    ):
        lane = max(1, int(lane))
        cleaned = sorted({lane_align(int(r), lane) for r in rungs if int(r) > 0})
        self.rungs: Tuple[int, ...] = tuple(cleaned)
        self.lane = lane
        self.source = source

    @classmethod
    def geometric(
        cls, lane: int = DEFAULT_LANE, top: int = _GEOMETRIC_TOP
    ) -> "PaddingLadder":
        """Default rungs ``lane · 2^k`` up to ``top`` — waste ≤ 2x."""
        rungs = []
        r = lane
        while r <= top:
            rungs.append(r)
            r *= 2
        return cls(rungs, lane=lane, source="geometric")

    def quantize(self, n: int) -> int:
        """Smallest rung ≥ ``n`` (lane-aligned fallback without rungs).

        Above the top rung, capacities continue doubling from it, so a
        census-tuned ladder stays total over inputs larger than
        anything the census saw while keeping the program count
        logarithmic in the overshoot.
        """
        n = int(n)
        rungs = self.rungs
        if not rungs:
            return lane_align(n, self.lane)
        if n <= rungs[0]:
            return rungs[0]
        i = bisect_left(rungs, n)
        if i < len(rungs):
            return rungs[i]
        cap = rungs[-1]
        while cap < n:
            cap *= 2
        return cap

    def size(self) -> int:
        """Rung count — the per-family compiled-program bound (0 = off)."""
        return len(self.rungs)

    def waste(self, n: int) -> float:
        """Padded-vs-actual ratio for one observation (≥ 1.0)."""
        n = int(n)
        if n <= 0:
            return 1.0
        return self.quantize(n) / float(n)

    def describe(self) -> Dict[str, object]:
        return {
            "source": self.source,
            "lane": self.lane,
            "size": self.size(),
            "rungs": list(self.rungs),
        }

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return "PaddingLadder(%s, %d rungs, lane=%d)" % (
            self.source, self.size(), self.lane,
        )


def parse_ladder_spec(
    spec: str, lane: int = DEFAULT_LANE
) -> PaddingLadder:
    """Parse the ``padding_ladder`` session property.

    ``geometric``/``auto``/``on``/empty → the default geometric ladder;
    ``off``/``none``/``lane`` → legacy pure lane alignment; otherwise a
    comma-separated rung list (``"128,1024,8192"``).
    """
    text = (spec or "").strip().lower()
    if text in ("", "geometric", "auto", "on", "default", "true"):
        return PaddingLadder.geometric(lane=lane)
    if text in ("off", "none", "lane", "false"):
        return PaddingLadder((), lane=lane, source="off")
    try:
        rungs = [int(tok) for tok in text.split(",") if tok.strip()]
    except ValueError:
        raise ValueError(
            "padding_ladder must be 'geometric', 'off', or a "
            "comma-separated rung list; got %r" % (spec,)
        )
    if not rungs:
        return PaddingLadder.geometric(lane=lane)
    return PaddingLadder(rungs, lane=lane, source="explicit")


def load_ladder_file(path: str, lane: int = DEFAULT_LANE) -> PaddingLadder:
    """Load a census-tuned ladder written by ``bucket_ladder.py --emit``.

    The file is ``{"ladder": [...], "lane": ...}`` plus advisory fields
    (wasteRatio, observations) that the engine ignores.
    """
    with open(path) as f:
        doc = json.load(f)
    rungs = doc.get("ladder") or ()
    if not rungs:
        raise ValueError("ladder file %s has no rungs" % path)
    return PaddingLadder(
        rungs, lane=int(doc.get("lane") or lane), source="census:%s" % path
    )


def resolve_ladder(config: Optional[dict]) -> PaddingLadder:
    """The executor-facing resolution order for the active ladder.

    1. a :class:`PaddingLadder` already placed in the config (the
       session resolves once and shares the object with every executor
       and streaming tile it spawns);
    2. ``padding_ladder_file`` (census-tuned, from ``--emit``);
    3. the ``padding_ladder`` spec string (default geometric).

    A missing/corrupt ladder file falls back to the spec: a worker must
    boot (and stay compile-bounded) even when the census artifact is
    stale or half-written.
    """
    cfg = config or {}
    existing = cfg.get("padding_ladder")
    if isinstance(existing, PaddingLadder):
        return existing
    path = cfg.get("padding_ladder_file")
    if path:
        try:
            return load_ladder_file(str(path))
        except (OSError, ValueError, KeyError):
            pass
    spec = existing if isinstance(existing, str) else ""
    return parse_ladder_spec(spec)


def ladder_waste(
    observations: Iterable[Tuple[int, int]], ladder: PaddingLadder
) -> Dict[str, float]:
    """Padded-vs-actual waste of ``ladder`` over ``(rows, count)``
    census observations: geometric and arithmetic means, observation-
    weighted.  The serve bench reports this against the ≤ 2x budget.
    """
    import math

    total = 0
    log_sum = 0.0
    lin_sum = 0.0
    for rows, count in observations:
        rows = int(rows)
        count = int(count)
        if rows <= 0 or count <= 0:
            continue
        w = ladder.waste(rows)
        total += count
        log_sum += math.log(w) * count
        lin_sum += w * count
    if not total:
        return {"geomean": 1.0, "mean": 1.0, "observations": 0}
    return {
        "geomean": math.exp(log_sum / total),
        "mean": lin_sum / total,
        "observations": total,
    }

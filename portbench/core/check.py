"""Whether the window's answers are correct.

Every answer the window produced is held to the plain reference of its
template (`portbench/reference/<name>.py`), worked out again from the
benchmark's own copy of the data's formulas, once the window has closed
and the program's state is freed.  The numbers compared, each with its
limit (an exact comparison has the limit 0):

    failed_queries   requests that failed or never came
    wrong_answers    answers that say something else than the reference
    widest_gap_units widest gap of a compared number, in units of its
                     column's last digit
    left_memory_path queries that streamed or spilled where the
                     configuration states that every query stays in memory

With `control`, the reference computed in binary floating point of that
dtype, each answer cast back to its column's scale (rounded half away
from zero), stands in the program's place: what a program returns that
accumulates a DECIMAL in a DOUBLE.  It has to come out as not correct."""
from __future__ import annotations

import time
from fractions import Fraction
from typing import Dict, List, Optional

import torch

from . import qgen

LIMITS = {"failed_queries": 0, "wrong_answers": 0, "widest_gap_units": 0,
          "left_memory_path": 0}
_CONTROL_DTYPES = {"float64": torch.float64, "float32": torch.float32}


def judge(spec, templates: Dict[str, dict], requests: List[dict], data,
          left_memory_path: int, control: Optional[str] = None) -> dict:
    t0 = time.perf_counter()
    by_template: Dict[str, dict] = {}
    for r in requests:
        if r["ok"]:
            by_template.setdefault(r["template"], {})[qgen.params_key(r["params"])] = r["params"]
    wrong, widest, compared = 0, Fraction(0), 0
    for name, sets in sorted(by_template.items()):
        ref = spec.reference(templates[name]["reference"])
        params = [sets[k] for k in sorted(sets)]
        want = ref.expected(data, params)
        stand_in = (ref.control(data, params, _CONTROL_DTYPES[control])
                    if control else None)
        for r in requests:
            if not r["ok"] or r["template"] != name:
                continue
            key = qgen.params_key(r["params"])
            rows = stand_in[key] if stand_in is not None else r["rows"]
            w, g = ref.judge(data, r["params"], want[key], rows)
            wrong += bool(w)
            widest = max(widest, g)
            compared += 1
    numbers = {"failed_queries": sum(1 for r in requests if not r["ok"]),
               "wrong_answers": wrong, "widest_gap_units": float(widest),
               "left_memory_path": left_memory_path}
    return {"numbers": numbers,
            "correct": all(numbers[k] <= LIMITS[k] for k in LIMITS),
            "compared": compared,
            "distinct": sum(len(v) for v in by_template.values()),
            "seconds": time.perf_counter() - t0}

"""The query stream: each request's template and substitution
parameters, within the ranges of the template file (TPC-H's qgen ranges,
spec v3.0.1 section 2.4).

A parameter is one of
    {"kind": "int", "lo": 60, "hi": 120}
    {"kind": "decimal", "lo": "0.02", "hi": "0.09"}   (steps of the last digit)
    {"kind": "date", "lo": "1995-03-01", "hi": "1995-03-31"}   (a day)
    {"kind": "choice", "values": ["AUTOMOBILE", ...]}
and the template's SQL names it as {NAME}.  Every range is a finite
domain of values.

The traffic file's `order` is the sequence of templates a client sends,
one pass after another (TPC-H's power test runs its stream's queries in
the order of the spec's Appendix A); client k starts its passes k places
in.  `--seed` draws the values: for each template's parameter it
shuffles the parameter's domain, and a request takes the value at the
position a fixed base stream gives (uniform over the domain, as qgen
draws).  The pattern of repeated values comes from that base stream, the
same for every seed, so every seed asks the same work of the program's
caches (a value seen before in the run is seen again at the same places)
with other values.  The same seed gives the same stream; each client of
a cell has a base stream of its own.
"""
from __future__ import annotations

import datetime
import decimal
import random
from typing import Dict, Iterator, List, Tuple

# the base streams' seed; streams of different clients must differ
_BASE_SEED = 20_261_018
_CLIENT_STRIDE = 1_000_003


def domain(param: dict) -> List[str]:
    """Every value the parameter takes, in order."""
    kind = param["kind"]
    if kind == "int":
        return [str(v) for v in range(int(param["lo"]), int(param["hi"]) + 1)]
    if kind == "decimal":
        lo, hi = decimal.Decimal(param["lo"]), decimal.Decimal(param["hi"])
        exp = min(lo.as_tuple().exponent, hi.as_tuple().exponent)
        step = decimal.Decimal(1).scaleb(exp)
        return [str(lo + k * step) for k in range(int((hi - lo) / step) + 1)]
    if kind == "date":
        lo = datetime.date.fromisoformat(param["lo"])
        hi = datetime.date.fromisoformat(param["hi"])
        return [(lo + datetime.timedelta(days=k)).isoformat()
                for k in range((hi - lo).days + 1)]
    if kind == "choice":
        return [str(v) for v in param["values"]]
    raise ValueError(f"unknown parameter kind {kind!r}")


class Values:
    """The seed's shuffle of each template parameter's domain."""

    def __init__(self, seed: int, templates: Dict[str, dict]):
        rng = random.Random(int(seed))
        self.order = {}
        for name in sorted(templates):
            for p, spec in sorted(templates[name]["params"].items()):
                vals = domain(spec)
                rng.shuffle(vals)
                self.order[(name, p)] = vals

    def value(self, name: str, param: str, position: int) -> str:
        return self.order[(name, param)][position]

    def warm(self, name: str, template: dict) -> Dict[str, str]:
        """The parameters that warm `name` up: the validation values'
        positions in the domains, shuffled like the stream's."""
        return {p: self.value(name, p, domain(spec).index(template["validation"][p]))
                for p, spec in sorted(template["params"].items())}


def params_key(params: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(params.items()))


def render(template: dict, params: Dict[str, str]) -> str:
    return template["sql"].format(**params)


def stream(values: Values, client: int, order: List[str],
           templates: Dict[str, dict]) -> Iterator[Tuple[str, Dict[str, str]]]:
    """Endless (template name, parameters) for one client: the templates
    of `order`, pass after pass."""
    base = random.Random(_BASE_SEED * _CLIENT_STRIDE + int(client))
    sizes = {(n, p): len(domain(spec)) for n in set(order)
             for p, spec in templates[n]["params"].items()}
    k = int(client)
    while True:
        name = order[k % len(order)]
        k += 1
        yield name, {p: values.value(name, p, base.randrange(sizes[(name, p)]))
                     for p in sorted(templates[name]["params"])}

"""The query stream stays inside TPC-H's qgen ranges and repeats for a
seed."""
import itertools

import pytest

from portbench.core import qgen
from portbench.core.spec import Spec

SPEC = Spec.load()
TRAFFIC = ("power", "q1")


def _templates(traffic):
    t = SPEC.traffic(traffic)
    return t, {n: SPEC.query(n) for n in t["order"]}


# TPC-H v3.0.1 2.4: the substitution parameters' ranges, written out here
# apart from the template files
QGEN = {
    "q1": {"DELTA": [str(d) for d in range(60, 121)]},
    "q3": {"SEGMENT": ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"],
           "DATE": [f"1995-03-{d:02d}" for d in range(1, 32)]},
    "q6": {"DATE": [f"{y}-01-01" for y in range(1993, 1998)],
           "DISCOUNT": [f"0.0{d}" for d in range(2, 10)],
           "QUANTITY": ["24", "25"]},
}


@pytest.mark.parametrize("traffic", TRAFFIC)
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 4_000_000_123])
def test_draws_stay_in_the_spec_ranges(traffic, seed):
    t, tm = _templates(traffic)
    values = qgen.Values(seed, tm)
    for client in range(int(t["clients"])):
        for name, params in itertools.islice(qgen.stream(values, client, t["order"], tm), 300):
            assert set(params) == set(QGEN[name])
            for p, v in params.items():
                assert v in QGEN[name][p], (name, p, v)
                assert v in qgen.domain(tm[name]["params"][p])
    for name, t_ in tm.items():
        assert all(v in QGEN[name][p] for p, v in values.warm(name, t_).items())


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_a_seed_repeats_its_stream(traffic):
    t, tm = _templates(traffic)
    a = list(itertools.islice(qgen.stream(qgen.Values(5, tm), 0, t["order"], tm), 200))
    b = list(itertools.islice(qgen.stream(qgen.Values(5, tm), 0, t["order"], tm), 200))
    c = list(itertools.islice(qgen.stream(qgen.Values(6, tm), 0, t["order"], tm), 200))
    assert a == b
    assert a != c


def test_every_seed_asks_the_same_work():
    """Seeds give the same templates and the same pattern of repeated
    values (the caches see the same hits), with other values."""
    t, tm = _templates("power")

    def shape(seed):
        seen, out = {}, []
        for name, params in itertools.islice(
                qgen.stream(qgen.Values(seed, tm), 0, t["order"], tm), 400):
            out.append((name,) + tuple(seen.setdefault((name, p, v), len(seen))
                                       for p, v in sorted(params.items())))
        return out

    assert shape(1) == shape(99) == shape(2**31 + 3)


def test_templates_follow_the_order_pass_after_pass():
    t, tm = _templates("power")
    assert t["order"] == ["q6", "q3", "q1"]  # TPC-H Appendix A, stream 00, kept to these
    for client in (0, 1):
        names = [n for n, _ in itertools.islice(
            qgen.stream(qgen.Values(1, tm), client, t["order"], tm), 30)]
        assert names == [t["order"][(k + client) % 3] for k in range(30)]


@pytest.mark.parametrize("name", sorted(QGEN))
def test_validation_parameters_render(name):
    t = SPEC.query(name)
    sql = qgen.render(t, t["validation"])
    assert "{" not in sql and all(v in sql for v in t["validation"].values())

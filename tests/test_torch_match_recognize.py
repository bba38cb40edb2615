"""The port's MATCH_RECOGNIZE against the JAX package.

Every test of tests/test_match_recognize.py is replayed through both
packages' sessions (test_torch_dml.replay: the port on the CPU, pages
byte-identical, rejections alike).  The port sorts the rows on the
device where the JAX package sorts with a Python comparator; the extra
statements hold that order to the comparator's where it is easiest to
lose: ties in the ORDER BY keys (source-row order), NULLs in partition
and ORDER BY keys (placed per key), descending keys and varchar keys
(string order, not dictionary codes), over seeded rows.
"""
import os

import numpy as np
import pytest

from test_torch_dml import assert_same_outcome, replay, replayed_tests, unreplayed_statements
from trino_tpu.session import Session as JaxSession
from trino_tpu_torch.session import Session as TorchSession

MR_TESTS = replayed_tests("test_match_recognize.py")


@pytest.mark.parametrize("test", MR_TESTS)
def test_match_recognize_sequences_match_jax(test):
    replay("test_match_recognize.py", test)


def test_every_match_recognize_statement_is_replayed():
    assert unreplayed_statements("test_match_recognize.py", MR_TESTS) == []
    text = open(os.path.join(os.path.dirname(__file__), "test_match_recognize.py")).read()
    assert len(MR_TESTS) == text.count("\ndef test_")


def _rows_sql(rng, n=160):
    syms = ["'zeta'", "'Alpha'", "'beta'", "null", "'beta '"]
    out = []
    for i in range(n):
        sym = syms[int(rng.integers(0, len(syms)))]
        ts = "null" if rng.random() < 0.06 else str(int(rng.integers(0, 40)))
        price = "null" if rng.random() < 0.05 else str(int(rng.integers(1, 30)))
        out.append(f"({sym}, {ts}, {price}, {i})")
    return "insert into t values " + ", ".join(out)


ORDERINGS = {
    "asc_ties_nulls_last": "order by ts",
    "desc_nulls_first": "order by ts desc nulls first",
    "two_keys_mixed": "order by ts asc nulls first, price desc",
    "varchar_order_key": "order by sym, ts",
}


@pytest.fixture(scope="module", params=[0, 1])
def pair(request):
    rng = np.random.default_rng(request.param)
    sessions = (JaxSession(config={"result_cache": False}), TorchSession(device="cpu"))
    insert = _rows_sql(rng)
    for s in sessions:
        s.create_catalog("memory", "memory", {})
        s.execute("create table t (sym varchar, ts bigint, price bigint, id bigint)")
        s.execute(insert)
    return sessions


@pytest.mark.parametrize("order", sorted(ORDERINGS))
def test_device_order_matches_the_comparator(pair, order):
    """ALL ROWS PER MATCH with a pattern every row matches shows the
    whole order the matcher saw, row ids and match numbers included."""
    sql = f"""select * from t match_recognize (
        partition by sym {ORDERINGS[order]}
        measures match_number() as mno, classifier() as cls, last(id) as lid
        all rows per match
        pattern (a b*)
        define b as price >= prev(price) or price is null
    )"""
    assert assert_same_outcome(pair, sql) is not None


@pytest.mark.parametrize("order", sorted(ORDERINGS))
def test_v_shapes_match_jax(pair, order):
    sql = f"""select * from t match_recognize (
        partition by sym {ORDERINGS[order]}
        measures first(id) as first_id, last(down.price) as bottom,
                 last(id) as last_id, match_number() as mno
        one row per match
        after match skip past last row
        pattern (strt down+ up+)
        define down as price < prev(price), up as price > prev(price)
    ) mr order by sym, mno"""
    assert assert_same_outcome(pair, sql) is not None

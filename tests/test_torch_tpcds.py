"""The port's TPC-DS connector and the TPC-DS path against the JAX package.

Every table's generate(table, 0.003) must give the JAX package's
arrays, validity and dictionaries, table by table.  Every statement of
chip_smoke.py's TPC-DS path — the 22 of tests/test_tpcds.py (imported
from that module), its null-FK count, DS-Q27-ROLLUP, DS-AGG and DS-FN —
runs through both packages' `tpcds_session(0.003)` (the port on the
CPU): pages byte-identical, except the float64 values of statements
with a transcendental function or a moment aggregate, held at relative
1e-12 (tests/test_torch_aggregates.py TOLERANT).  The statements of
tests/test_tpcds.py must also agree with its sqlite oracle as that file
checks them.
"""
import numpy as np
import pytest

import chip_smoke
import test_tpcds
import trino_tpu.connectors.tpcds as jtpcds
import trino_tpu_torch.connectors.tpcds as ttpcds
from oracle import assert_rows_match
from test_torch_aggregates import assert_same_pages
from test_tpcds import oracle_conn  # noqa: F401  (the sqlite oracle fixture)
from trino_tpu.session import tpcds_session as jax_session
from trino_tpu_torch.session import tpcds_session as torch_session

SF = test_tpcds.SF
TEST_QUERIES = ["Q3", "Q7", "Q42", "Q52", "Q55", "Q43", "Q27", "Q19", "Q26",
                "Q45", "Q68", "Q79", "Q96", "Q90", "Q33_SUB", "Q13", "Q98",
                "Q65", "Q88_SLICE", "Q37", "Q3_CS", "Q3_WS"]
STATEMENTS = {q: getattr(test_tpcds, q) for q in TEST_QUERIES}
# test_tpcds_q90_am_pm inlines a one-row probe for the web_page table
STATEMENTS["Q90"] = STATEMENTS["Q90"].replace("web_page_probe", "(select 1 wp) wp")
STATEMENTS["NULL-FK"] = chip_smoke._tpcds_sql()["NULL-FK"]
STATEMENTS.update(chip_smoke.DS_EXTRA)
# tests/test_tpcds.py holds these five at assert_rows_match's default
# tolerance, the null-FK count exactly, and the rest at 2e-2
DEFAULT_TOL = ("Q42", "Q52", "Q55", "Q43", "Q27")


@pytest.fixture(scope="module")
def sessions():
    return (jax_session(SF, result_cache=False),
            torch_session(SF, device="cpu"))


def test_chip_smoke_reads_the_test_statements():
    """chip_smoke.py reads tests/test_tpcds.py with ast (it may not import
    the JAX package); what it reads is what the module holds."""
    got = chip_smoke._tpcds_sql()
    assert {k: v for k, v in got.items() if k != "NULL-FK"} == {
        q: STATEMENTS[q] for q in TEST_QUERIES}


@pytest.mark.parametrize("table", sorted(jtpcds.SCHEMAS))
def test_generator_matches_jax(table):
    jv, jok, jd, jn = jtpcds.generate(table, SF)
    tv, tok, td, tn = ttpcds.generate(table, SF)
    assert jn == tn
    assert list(jv) == list(tv) and sorted(jok) == sorted(tok)
    assert sorted(jd) == sorted(td)
    for c in jv:
        assert jv[c].dtype == tv[c].dtype and jv[c].tobytes() == tv[c].tobytes(), c
    for c in jok:
        np.testing.assert_array_equal(jok[c], tok[c])
    for c in jd:
        assert [str(x) for x in jd[c]] == [str(x) for x in td[c]], c
    assert [(c, str(t)) for c, t in ttpcds.SCHEMAS[table]] == [
        (c, str(t)) for c, t in jtpcds.SCHEMAS[table]]


@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_tpcds_statements_match_jax(sessions, name):
    # Q19, Q55 and Q3_WS select no row at this scale, in both packages
    assert_same_pages(sessions, STATEMENTS[name])


@pytest.mark.parametrize("name", TEST_QUERIES + ["NULL-FK"])
def test_tpcds_statements_match_oracle(sessions, oracle_conn, name):  # noqa: F811
    sql = STATEMENTS[name]
    actual = sessions[1].execute(sql).to_pylist()
    expected = oracle_conn.execute(sql).fetchall()
    if name == "NULL-FK":
        assert actual == [tuple(expected[0])]
    elif name in DEFAULT_TOL:
        assert_rows_match(actual, expected)
    else:
        assert_rows_match(actual, expected, tol=2e-2)


def test_rollup_rows_carry_grouping(sessions):
    rows = sessions[1].execute(STATEMENTS["DS-Q27-ROLLUP"]).to_pylist()
    assert {r[2] for r in rows} == {0, 1}
    assert all((r[1] is None) == (r[2] == 1) for r in rows)

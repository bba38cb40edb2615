"""The port's scalar function library against the JAX package.

Every SELECT that tests/test_functions.py runs through its TPC-H
session, and statements for the functions it does not reach, run
through both packages' `tpch_session` (the port on the CPU).  The pages
must be byte-identical (trino_tpu_torch/convert.py) — integers,
decimals, dates, booleans and the derived dictionaries of the string
functions — except the float64 values of transcendental functions, held
at relative 1e-12 (tests/test_torch_aggregates.py TOLERANT).

The module-level tests hold the civil-date helpers to the JAX functions
over every day from 1600 to 2400 exactly, and `_rand` over a fixed
seed bit for bit (a SQL rand() draws its seed per query).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trino_tpu.expr.functions as jfn
import trino_tpu_torch.expr.functions as tfn
from chip_smoke import sql_statements
from test_torch_aggregates import assert_same_pages
from trino_tpu.session import tpch_session as jax_session
from trino_tpu_torch.session import tpch_session as torch_session

SF = 0.001

STATEMENTS = sql_statements("test_functions.py")
O = "from orders order by o_orderkey limit 60"
STATEMENTS.update({
    "trims_and_position":
        "select ltrim(lpad(c_name, 22, ' ')), rtrim(rpad(c_name, 22, ' ')), "
        "strpos(c_name, '#'), strpos(c_name, 'zz'), codepoint(c_mktsegment) "
        "from customer order by c_custkey limit 30",
    "regexp_backreference_and_split_edges":
        "select regexp_replace(c_name, '#(0*)([1-9])', '-$2$1'), "
        "split_part(c_phone, '-', 1), split_part(c_phone, '', 1), "
        "regexp_extract(c_phone, '^(\\d+)-(\\d+)', 1), "
        "regexp_like(c_mktsegment, '^[AB]') from customer order by c_custkey limit 30",
    "concat_two_dictionaries":
        "select concat(n_name, ' / ', r_name), concat(r_name, n_name) "
        "from nation, region where n_regionkey = r_regionkey order by n_nationkey",
    "string_fns_grouped":
        "select upper(o_orderpriority) p, count(*) from orders group by 1 order by 1",
    "logs_and_powers":
        f"select log2(o_totalprice), log(2.5, o_totalprice), ln(o_custkey - 50), "
        f"exp(o_shippriority), pow(o_custkey, 0.5), cbrt(-o_totalprice) {O}",
    "trig_and_hyperbolic":
        "select cos(o_totalprice / 100000), tan(o_custkey), atan(o_custkey), "
        "asin(o_custkey / 100.0), acos(o_custkey / 100.0), sinh(o_custkey / 100.0), "
        f"cosh(o_custkey / 100.0), tanh(o_custkey / 10.0), degrees(o_custkey), "
        f"radians(o_custkey) {O}",
    "rounding_family":
        "select floor(o_totalprice), ceil(o_totalprice), ceiling(o_totalprice / 7), "
        "floor(cast(o_totalprice as double)), ceil(cast(o_totalprice as double)), "
        "truncate(o_totalprice, 1), truncate(cast(o_totalprice as double)), "
        f"sign(o_custkey - 50), sign(cast(o_totalprice as double) - 150000) {O}",
    "double_predicates_and_extremes":
        "select is_nan(cast(o_totalprice as double)), is_finite(o_custkey), "
        "is_infinite(cast(o_totalprice as double) / 0), "
        "greatest(cast(o_totalprice as double), 1.5e5), least(o_custkey, o_orderkey), "
        "width_bucket(cast(o_totalprice as double), 0, 500000, 25), "
        f"sqrt(o_custkey - 50) {O}",
    "date_aliases":
        "select dow(o_orderdate), doy(o_orderdate), "
        "week_of_year(o_orderdate), yow(o_orderdate), day_of_month(o_orderdate), "
        f"extract(quarter from o_orderdate) {O}",
    "date_trunc_add_diff_units":
        "select date_trunc('day', o_orderdate), date_add('quarter', 5, o_orderdate), "
        "date_add('month', -13, o_orderdate), "
        "date_diff('quarter', date '1994-02-28', o_orderdate), "
        "date_diff('week', o_orderdate, date '1996-01-01'), "
        f"last_day_of_month(date_add('day', 40, o_orderdate)) {O}",
    "date_functions_grouped":
        "select day_of_week(o_orderdate) d, date_trunc('quarter', o_orderdate) q, "
        "count(*) from orders group by 1, 2 order by 1, 2",
})


@pytest.fixture(scope="module")
def sessions():
    return (jax_session(SF, result_cache=False),
            torch_session(SF, device="cpu"))


@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_function_statements_match_jax(sessions, name):
    assert_same_pages(sessions, STATEMENTS[name])


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


DAYS = np.arange(jfn.days_from_civil(1600, 1, 1), jfn.days_from_civil(2400, 1, 1),
                 dtype=np.int64)


def test_civil_date_helpers_match_jax():
    jd, td = jnp.asarray(DAYS), torch.as_tensor(DAYS)
    for a, b in zip(jfn.civil_from_days(jd), tfn.civil_from_days(td)):
        np.testing.assert_array_equal(_np(a), _np(b))
    for a, b in zip(jfn._iso_week_parts(jd), tfn._iso_week_parts(td)):
        np.testing.assert_array_equal(_np(a), _np(b))
    y, m, d = (_np(x) for x in tfn.civil_from_days(td))
    np.testing.assert_array_equal(
        _np(tfn.days_from_civil_v(torch.as_tensor(y), torch.as_tensor(m),
                                  torch.as_tensor(d))), DAYS)
    np.testing.assert_array_equal(
        _np(jfn._days_in_month(jnp.asarray(y), jnp.asarray(m))),
        _np(tfn._days_in_month(torch.as_tensor(y), torch.as_tensor(m))))


@pytest.mark.parametrize("seed", [0, 12345, 2**62 + 17, -(2**63)])
def test_rand_matches_jax_for_a_fixed_seed(seed):
    n = 5000
    j, jok = jfn._rand(None, [(jnp.full(n, seed, dtype=jnp.int64), None)], None)
    t, tok = tfn._rand(None, [(torch.full((n,), seed, dtype=torch.int64), None)], None)
    assert _np(j).tobytes() == _np(t).tobytes()
    assert _np(tok).all() and ((_np(t) >= 0) & (_np(t) < 1)).all()


def test_rand_through_sql_is_uniform_and_fresh():
    ts = torch_session(SF, device="cpu")
    a = ts.execute("select rand() from orders").to_pylist()
    b = ts.execute("select rand() from orders").to_pylist()
    assert a != b and all(0 <= r[0] < 1 for r in a)


def test_unported_functions_are_refused_by_name():
    """The JSON, URL, hash and array functions wait for expr/arrays.py:
    the port's analyzer does not register them."""
    from trino_tpu_torch.sql.analyzer import SemanticError

    ts = torch_session(SF, device="cpu")
    for fn in ("md5(n_name)", "split(n_name, 'A')", "json_extract_scalar(n_name, '$.a')"):
        with pytest.raises(SemanticError, match="unknown function: " + fn.split("(")[0]):
            ts.execute(f"select {fn} from nation")

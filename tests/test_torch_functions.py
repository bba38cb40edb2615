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
from test_torch_dml import replay
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


CLIENT_TESTS = ["test_json_extract_scalar", "test_json_array_functions",
                "test_url_functions", "test_digest_functions", "test_levenshtein"]


@pytest.mark.parametrize("test", CLIENT_TESTS)
def test_json_url_digest_statements_match_jax(test):
    """The JSON, URL, digest, base64/hex, crc32 and levenshtein tests of
    tests/test_client_features.py, replayed through both packages."""
    replay("test_client_features.py", test)


FORMER_REFUSALS = {
    "md5": "select md5(n_name), sha1(n_name), sha512(n_comment) from nation",
    "split": "select split(n_name, 'A'), cardinality(split(n_comment, ' ')) from nation",
    "json_extract_scalar":
        "select json_extract_scalar(concat('{\"n\": \"', n_name, '\", \"r\": 1}'), '$.n'), "
        "json_extract_scalar(concat('{\"n\": ', n_name, '}'), '$.n'),json_extract_scalar(concat('{\"a\": [\"', n_name, '\"]}'), "
        "'$.a[0]') from nation order by n_nationkey",
}
STATEMENTS_2 = {
    "unixtime_pair":
        "select from_unixtime(o_custkey * 1000), to_unixtime(from_unixtime(o_orderkey)), "
        "to_unixtime(from_unixtime(o_totalprice)) from orders order by o_orderkey limit 40",
    "url_parts_over_columns":
        "select url_extract_host(concat('https://', c_mktsegment, '.example.com:8/p/?q=1#f')), "
        "url_extract_port(concat('http://h:', substr(c_phone, 1, 2), '/x')), "
        "url_extract_parameter(concat('http://h/?a=1&b=', c_name, '&c'), 'b'), "
        "url_extract_query(concat('http://h/p?x=', c_mktsegment)), "
        "url_extract_path(concat('http://h/', c_name)), "
        "url_extract_fragment(concat('http://h/#', c_phone)), "
        "url_encode(c_address), url_decode(url_encode(c_address)) "
        "from customer order by c_custkey limit 50",
    "digests_and_encodings_grouped":
        "select crc32(c_mktsegment), to_hex(c_mktsegment), to_base64(c_mktsegment), "
        "from_base64(to_base64(c_mktsegment)), count(*), count(distinct md5(c_name)), "
        "sum(crc32(c_phone)) from customer group by 1, 2, 3, 4 order by 1",
    "json_functions_over_columns":
        "select json_array_length(concat('[', replace(c_phone, '-', ','), ']')), "
        "json_array_contains(concat('[', replace(c_phone, '-', ','), ']'), 25), "
        "json_size(concat('{\"a\": {\"b\": \"', c_name, '\"}}'), '$.a'), "
        "json_format(concat('{\"k\":  \"', c_mktsegment, '\"}')), "
        "json_extract(concat('{\"a\": [', replace(c_phone, '-', ','), ']}'), '$.a'), "
        "json_extract_scalar(concat('{\"a\": [', replace(c_phone, '-', ','), ']}'), '$.a[2]') "
        "from customer order by c_custkey limit 50",
    "levenshtein_grouped":
        "select levenshtein_distance(n_name, 'GERMANY') d, count(*) from nation "
        "group by 1 order by 1",
}


@pytest.mark.parametrize("name", sorted(FORMER_REFUSALS))
def test_formerly_refused_functions_match_jax(sessions, name):
    """md5, split and json_extract_scalar were refused as unknown until
    the JSON/URL/hash/array slice; they now answer as the JAX package
    does, over dictionary columns and derived dictionaries."""
    assert_same_pages(sessions, FORMER_REFUSALS[name])


@pytest.mark.parametrize("name", sorted(STATEMENTS_2))
def test_json_url_hash_unixtime_statements_match_jax(sessions, name):
    assert_same_pages(sessions, STATEMENTS_2[name])


def test_unknown_functions_are_refused_alike(sessions):
    """A name neither package registers is refused at analysis, with the
    same message."""
    from trino_tpu.sql.analyzer import SemanticError as JError
    from trino_tpu_torch.sql.analyzer import SemanticError as TError

    js, ts = sessions
    for fn in ("json_parse(n_name)", "sha3(n_name)", "array_concat(split(n_name, 'A'))"):
        name = fn.split("(")[0]
        with pytest.raises(JError, match="unknown function: " + name):
            js.execute(f"select {fn} from nation")
        with pytest.raises(TError, match="unknown function: " + name):
            ts.execute(f"select {fn} from nation")

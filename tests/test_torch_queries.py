"""The statements of tests/test_queries.py through both packages.

Every SQL statement each test of tests/test_queries.py runs — the
`check(session, oracle_conn, sql, ...)` calls and the literal
`session.execute(...)` calls outside `pytest.raises` — is read from
that file's source with ast (so the SQL is the reference test's own
text) and run through the JAX package's session and the port's (on the
CPU) at the same scale: the pages must be byte-identical
(trino_tpu_torch/convert.py), and a `check` statement must also agree
with the sqlite oracle (tests/oracle.py) with that call's ordering and
tolerance.  One parametrised case per reference test.
"""
import ast
import os
import sqlite3

import pytest

from oracle import assert_rows_match, load_tpch
from trino_tpu.session import tpch_session as jax_session
from trino_tpu_torch import convert
from trino_tpu_torch.session import tpch_session as torch_session

SF = 0.001
SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_queries.py")


def _statements():
    """{test name: [(kind, sql, oracle_sql or None, ordered, tol)]}: kind
    "check" (against the oracle too), "execute" or "explain"."""
    with open(SOURCE) as f:
        tree = ast.parse(f.read())
    out = {}
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef) and fn.name.startswith("test_")):
            continue
        consts = {}
        for n in ast.walk(fn):
            if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name):
                v = _value(n.value, consts)
                if isinstance(v, str):
                    consts[n.targets[0].id] = v
        rejected = {id(c) for w in ast.walk(fn) if isinstance(w, ast.With)
                    and any("raises" in ast.unparse(i.context_expr) for i in w.items)
                    for c in ast.walk(w)}
        found = []
        for call in ast.walk(fn):
            if not isinstance(call, ast.Call) or id(call) in rejected:
                continue
            f = call.func
            if isinstance(f, ast.Name) and f.id == "check":
                args = [_value(a, consts) for a in call.args[2:]]
                kw = {k.arg: _value(k.value, consts) for k in call.keywords}
                oracle_sql = args[1] if len(args) > 1 else kw.get("oracle_sql")
                found.append(("check", args[0], oracle_sql, kw.get("ordered", True),
                              kw.get("tol", 1e-2)))
            elif (isinstance(f, ast.Attribute) and f.attr in ("execute", "explain")
                  and getattr(f.value, "id", None) == "session" and call.args):
                sql = _value(call.args[0], consts)
                if isinstance(sql, str):
                    found.append((f.attr, sql, None, True, 0.0))
        out[fn.name] = found
    return out


def _value(node, consts):
    """A string expression of the test's source: literals, the test's own
    string variables, f-strings over them, `if ... else` and `.replace`."""
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    if isinstance(node, ast.JoinedStr):
        parts = [_value(p.value, consts) if isinstance(p, ast.FormattedValue)
                 else p.value for p in node.values]
        return None if None in parts else "".join(str(p) for p in parts)
    if isinstance(node, ast.IfExp):
        test = _value(node.test, consts)
        return _value(node.body if test else node.orelse, consts)
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "replace"):
        base = _value(node.func.value, consts)
        args = [_value(a, consts) for a in node.args]
        if isinstance(base, str) and all(isinstance(a, str) for a in args):
            return base.replace(*args)
        return None
    try:
        return ast.literal_eval(node)
    except ValueError:
        return None


STATEMENTS = _statements()


def _right_full_join() -> bool:
    try:
        conn = sqlite3.connect(":memory:")
        conn.execute("create table a(x)")
        conn.execute("create table b(y)")
        conn.execute("select * from a right join b on x = y").fetchall()
        return True
    except sqlite3.OperationalError:
        return False


@pytest.fixture(scope="module")
def sessions():
    return (jax_session(SF, result_cache=False),
            torch_session(SF, device="cpu", result_cache=False))


@pytest.fixture(scope="module")
def oracle_conn():
    conn = sqlite3.connect(":memory:")
    load_tpch(conn, SF, ["region", "nation", "customer", "orders", "lineitem",
                         "supplier", "part", "partsupp"])
    return conn


def test_every_reference_test_is_replayed():
    assert len(STATEMENTS) == 39
    assert all(STATEMENTS.values()), [t for t, v in STATEMENTS.items() if not v]


@pytest.mark.parametrize("test", sorted(STATEMENTS))
def test_query_statements_match_jax_and_oracle(sessions, oracle_conn, test):
    js, ts = sessions
    for kind, sql, oracle_sql, ordered, tol in STATEMENTS[test]:
        if kind == "explain":
            assert js.explain(sql) == ts.explain(sql)
            continue
        page = ts.execute(sql)
        convert.assert_pages_identical(js.execute(sql), page)
        if kind != "check":
            continue
        if " right join " in sql.lower() or " full " in sql.lower():
            if not _right_full_join():
                continue  # the host sqlite predates RIGHT/FULL JOIN
        expected = oracle_conn.execute(oracle_sql or sql).fetchall()
        assert_rows_match(page.to_pylist(), expected, tol=tol, ordered=ordered)

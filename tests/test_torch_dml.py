"""The port's writes, DDL and TABLESAMPLE against the JAX package.

Every statement sequence of tests/test_dml.py, the memory-connector and
TABLESAMPLE tests of tests/test_session_features.py run through both
packages' sessions (the port on the CPU, the JAX package with its
result cache off), statement by statement: each result page must be
byte-identical (trino_tpu_torch/convert.py), a statement the JAX package
rejects must raise the same exception type with the same message in the
port, and at the end every memory table of both sessions must be stored
byte-identically.  The sequences are read from the test files' source
(replay_events), so they stay the JAX tests' own.

Beside them: a WHERE over a sampled table, a read-after-write with the
scan cache on, the page sink's column-wise rebuild against the row path
on seeded pages, and the sample's mask against the JAX package's
splitmix64 of the row positions.
"""
import ast
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trino_tpu.exec.local as jlocal
import trino_tpu.session as jsession
import trino_tpu.types as JT
import trino_tpu_torch.exec.local as tlocal
import trino_tpu_torch.session as tsession
import trino_tpu_torch.types as TT
from trino_tpu_torch import convert
from trino_tpu_torch.connectors import memory as tmemory
from trino_tpu_torch.page import column_from_pylist

TESTS = os.path.dirname(os.path.abspath(__file__))


# -- reading a JAX test's session events from its source ----------------------


def _module(filename):
    with open(os.path.join(TESTS, filename)) as f:
        return ast.parse(f.read())


def _value(node, env):
    """A literal argument: constants, lists/tuples/dicts of them, T.<type>
    (as ("type", name)), f-strings and names bound to such values."""
    if isinstance(node, ast.Attribute) and getattr(node.value, "id", None) == "T":
        return ("type", node.attr)
    if isinstance(node, ast.Name):
        return env[node.id]
    if isinstance(node, ast.JoinedStr):
        out = []
        for part in node.values:
            if isinstance(part, ast.FormattedValue):
                out.append(str(_value(part.value, env)))
            else:
                out.append(part.value)
        return "".join(out)
    if isinstance(node, (ast.List, ast.Tuple)):
        return [_value(x, env) for x in node.elts]
    if isinstance(node, ast.Dict):
        return {_value(k, env): _value(v, env) for k, v in zip(node.keys, node.values)}
    return ast.literal_eval(node)


def _events(fn, helpers, rename=None, consts=None):
    """The session events of one function body, in source order:
    ("new", var, (kind, arg)) for `var = Session()` / tpch_session(sf),
    ("catalog", var, args), ("sql", var, text), ("table", var, (catalog,
    name, schema, data)) for the memory connector's Python API; calls of
    module helpers taking a session are inlined."""
    rename = rename or {}

    def var(node):
        name = getattr(node, "id", None)
        return rename.get(name, name)

    env, conns = dict(consts or {}), {}
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            tgt, val = node.targets[0].id, node.value
            f = getattr(val, "func", None)
            if isinstance(val, ast.Constant):
                env[tgt] = val.value
            elif (isinstance(f, ast.Attribute) and f.attr == "get"
                  and isinstance(f.value, ast.Attribute)
                  and f.value.attr == "catalogs"):
                conns[tgt] = (var(f.value.value), _value(val.args[0], env))
    found = []
    for node in ast.walk(fn):
        at = (getattr(node, "lineno", 0), getattr(node, "col_offset", 0))
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Call)
                and getattr(node.value.func, "id", None) in ("Session", "tpch_session")):
            args = node.value.args
            found.append((at, ("new", var(node.targets[0]), (
                node.value.func.id, _value(args[0], env) if args else None))))
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "execute" and node.args:
            try:
                text = _value(node.args[0], env)
            except (KeyError, ValueError):
                text = None  # computed text: only an oracle's, checked in replay
            found.append((at, ("sql", var(f.value), text)))
        elif isinstance(f, ast.Name) and f.id in ("rows", "run") and len(node.args) >= 2:
            found.append((at, ("sql", var(node.args[0]), _value(node.args[1], env))))
        elif isinstance(f, ast.Attribute) and f.attr == "create_catalog":
            found.append((at, ("catalog", var(f.value),
                               [_value(a, env) for a in node.args])))
        elif (isinstance(f, ast.Attribute) and f.attr == "create_table"
              and getattr(f.value, "id", None) in conns):
            sess, cat = conns[f.value.id]
            found.append((at, ("table", sess, (cat, *[_value(a, env) for a in node.args]))))
        elif isinstance(f, ast.Name) and f.id in helpers:
            h = helpers[f.id]
            sub = _events(h, helpers, {h.args.args[0].arg: var(node.args[0])},
                          consts)
            found.extend((at + (i,), e) for i, e in enumerate(sub))
    found.sort(key=lambda x: x[0])
    return [e for _, e in found]


def replay_events(filename, test):
    """Events of tests/<filename>::<test>, its `session` fixture's first."""
    mod = _module(filename)
    fns = {n.name: n for n in mod.body if isinstance(n, ast.FunctionDef)}
    helpers = {k: v for k, v in fns.items()
               if k.startswith("_") and v.args.args}
    consts = {n.targets[0].id: n.value.value for n in mod.body
              if isinstance(n, ast.Assign) and isinstance(n.value, ast.Constant)
              and isinstance(n.targets[0], ast.Name)}
    fn = fns[test]
    events = []
    if "session" in [a.arg for a in fn.args.args] and "session" in fns:
        fx = fns["session"]
        ret = [n for n in ast.walk(fx) if isinstance(n, ast.Return)][0].value
        if isinstance(ret, ast.Call):  # return tpch_session(sf)
            events.append(("new", "session",
                           (ret.func.id, _value(ret.args[0], consts))))
        else:
            events.extend(_events(fx, helpers, {ret.id: "session"}, consts))
    return events + _events(fn, helpers, consts=consts)


def replayed_tests(filename, skip=()):
    """Every test function of tests/<filename> that runs a statement."""
    mod = _module(filename)
    return [n.name for n in mod.body if isinstance(n, ast.FunctionDef)
            and n.name.startswith("test_") and n.name not in skip
            and any(e[0] == "sql" for e in replay_events(filename, n.name))]


_SQL = ("select", "insert", "create", "delete", "update", "merge", "drop",
        "show", "values")


def unreplayed_statements(filename, tests):
    """SQL string constants of tests/<filename> that no replayed event of
    `tests` runs (f-strings count by their evaluated text)."""
    replayed = {e[2] for t in tests for e in replay_events(filename, t)
                if e[0] == "sql"}
    mod = _module(filename)
    texts = [n.value for n in ast.walk(mod)
             if isinstance(n, ast.Constant) and isinstance(n.value, str)
             and n.value.lstrip().lower().startswith(_SQL)]
    return [t for t in texts if t not in replayed
            and not any(t in r for r in replayed)]


# -- running them through both packages ---------------------------------------


def _sessions(kind, arg):
    if kind == "tpch_session":
        return (jsession.tpch_session(arg, result_cache=False),
                tsession.tpch_session(arg, device="cpu"))
    return (jsession.Session(config={"result_cache": False}),
            tsession.Session(device="cpu"))


def _schema(spec, Tmod):
    return [(c, getattr(Tmod, t[1])) for c, t in spec]


def _outcome(s, sql):
    try:
        return s.execute(sql), None
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return None, e


def assert_same_outcome(pair, sql, check=convert.assert_pages_identical):
    """Both sessions' outcome of `sql`: identical pages, or the same
    exception type with the same message.  Returns the port's page."""
    (a, ea), (b, eb) = _outcome(pair[0], sql), _outcome(pair[1], sql)
    if ea is not None or eb is not None:
        assert ea is not None and eb is not None, (sql, ea, eb)
        assert (type(ea).__name__, str(ea)) == (type(eb).__name__, str(eb)), sql
        return None
    check(a, b)
    return b


def replay(filename, test, check=convert.assert_pages_identical):
    """Run one JAX test's events through both packages; returns the
    session pairs by variable name."""
    pairs = {}
    for kind, name, arg in replay_events(filename, test):
        if kind == "new":
            pairs[name] = _sessions(*arg)
        elif kind == "catalog":
            for s in pairs[name]:
                s.create_catalog(*arg)
        elif kind == "table":
            cat, table, spec, data = arg
            for s, Tmod in zip(pairs[name], (JT, TT)):
                s.catalogs.get(cat).create_table(table, _schema(spec, Tmod), data)
        elif name in pairs:  # not a session (e.g. a sqlite oracle)
            assert arg is not None, f"{test}: a session statement's text is computed"
            assert_same_outcome(pairs[name], arg, check)
    for js, ts in pairs.values():
        assert_memory_tables_identical(js, ts)
    return pairs


def assert_memory_tables_identical(js, ts):
    for name in ts.catalogs.names():
        tc = ts.catalogs.get(name)
        if not isinstance(tc, tmemory.MemoryConnector):
            continue
        jc = js.catalogs.get(name)
        assert sorted(jc.store.tables) == sorted(tc.store.tables)
        for t, page in tc.store.tables.items():
            convert.assert_pages_identical(jc.store.tables[t], page)


DML_TESTS = replayed_tests("test_dml.py")
SESSION_TESTS = ["test_memory_connector", "test_tablesample",
                 "test_tablesample_after_alias"]


@pytest.mark.parametrize("test", DML_TESTS)
def test_dml_sequences_match_jax(test):
    replay("test_dml.py", test)


@pytest.mark.parametrize("test", SESSION_TESTS)
def test_session_feature_sequences_match_jax(test):
    replay("test_session_features.py", test)


def test_every_dml_statement_is_replayed():
    """The extraction reaches every statement of test_dml.py and of the
    session-feature tests it replays."""
    assert unreplayed_statements("test_dml.py", DML_TESTS) == []
    text = open(os.path.join(TESTS, "test_dml.py")).read()
    assert len(DML_TESTS) == text.count("\ndef test_")
    events = [e for t in SESSION_TESTS
              for e in replay_events("test_session_features.py", t)]
    assert sum(e[0] == "sql" for e in events) == 7
    assert ("table", "s", ("mem", "people", [["name", ("type", "VARCHAR")],
            ["age", ("type", "BIGINT")]],
            {"name": ["ada", "bob", None], "age": [30, 25, 99]})) in events


def test_memory_tables_are_compared():
    """assert_memory_tables_identical reaches the sessions' tables."""
    (js, ts), = replay("test_dml.py", "test_ctas").values()
    assert sorted(ts.catalogs.get("memory").store.tables) == ["dst", "src"]
    js.execute("insert into dst values (1, 'z')")
    with pytest.raises(AssertionError):
        assert_memory_tables_identical(js, ts)


# -- TABLESAMPLE ---------------------------------------------------------------


SAMPLED = [
    "select count(*), sum(o_totalprice) from orders tablesample bernoulli (30) "
    "where o_orderstatus = 'F'",
    "select o_orderpriority, count(*) from orders tablesample bernoulli (50) "
    "where o_totalprice > 100000 and o_orderdate < date '1995-01-01' "
    "group by o_orderpriority order by o_orderpriority",
    "select l_returnflag, count(*), sum(l_quantity) from lineitem "
    "tablesample system (25) where l_shipdate >= date '1994-01-01' "
    "group by l_returnflag order by l_returnflag",
    "select count(*) from orders tablesample bernoulli (0)",
    "select o_orderkey from orders tablesample bernoulli (2) "
    "where o_custkey < 200 order by o_orderkey",
]


@pytest.fixture(scope="module")
def tpch_pair():
    return (jsession.tpch_session(0.01, result_cache=False),
            tsession.tpch_session(0.01, device="cpu"))


@pytest.mark.parametrize("i", range(len(SAMPLED)))
def test_sampled_where_matches_jax(tpch_pair, i):
    """A WHERE over a sampled table keeps the rows the sample keeps by
    their positions in the scan, not in what the filter leaves."""
    page = assert_same_outcome(tpch_pair, SAMPLED[i])
    assert page is not None


@pytest.mark.parametrize("fraction", [0.0, 0.1, 0.5, 0.999, 1.0])
def test_sample_mask_matches_jax(fraction):
    n = 20000
    rng = np.random.default_rng(3)
    sel = rng.random(n) < 0.9
    jb = jlocal.Batch({}, jnp.asarray(sel))
    stub = types.SimpleNamespace(visit=lambda node: jb)
    node = types.SimpleNamespace(source=None, fraction=fraction)
    want = np.asarray(jlocal._TraceCtx._visit_sample(stub, node).sel)
    got = tlocal.sample_keep(n, fraction, torch.device("cpu")).numpy() & sel
    np.testing.assert_array_equal(want, got)


# -- read after write ----------------------------------------------------------


def test_read_after_write_with_the_scan_cache_on():
    """Each write bumps the table's data version, so the next scan
    misses the cache (keyed by it) and reads the new rows; the write
    drops the table's old entries, and other tables' entries stay."""
    s = tsession.Session(device="cpu")
    s.create_catalog("memory", "memory", {})
    s.create_catalog("tpch", "tpch", {"tpch.scale-factor": 0.001})
    assert s.properties.get("scan_cache_enabled")
    s.execute("create table t as select n_nationkey k, n_name v from tpch.tpch.nation")
    s.execute("select count(*) from tpch.tpch.region")
    cache = s._scan_cache
    seen = []
    for sql in ("insert into t values (100, 'X'), (101, null)",
                "delete from t where k < 5",
                "update t set v = 'Y' where k >= 100",
                "merge into t a using (select 7 k, 'M' v) b on a.k = b.k "
                "when matched then update set v = b.v"):
        before = s.execute("select count(*), sum(k), count(v) from t").to_pylist()
        assert any(key[1] == "t" for key in cache.entries)
        s.execute(sql)
        assert not any(key[1] == "t" for key in cache.entries)
        after = s.execute("select count(*), sum(k), count(v) from t").to_pylist()
        seen.append((before, after))
    assert seen[0] == ([(25, 300, 25)], [(27, 501, 26)])
    assert seen[1][1] == [(22, 491, 21)]
    assert s.execute("select v from t where k >= 100 order by k").to_pylist() == [
        ("Y",), ("Y",)]
    assert s.execute("select v from t where k = 7").to_pylist() == [("M",)]
    assert any(key[1] == "region" for key in cache.entries)


# -- the page sink's column-wise rebuild ----------------------------------------


def _seeded_columns(rng, n, typ):
    ok = rng.random(n) < 0.8
    if typ.is_dictionary:
        words = np.array([f"w{i}" for i in range(7)] + ["w1"], dtype=object)
        codes = rng.integers(-1, len(words), n).astype(np.int32)
        return tmemory.Column(typ, codes, ok, words)
    if typ.is_decimal:
        v = rng.integers(-10**17, 10**17, n)
        v[::3] //= 10**6
        v[5::7] = rng.choice([10**15, -(10**15), 10**15 - 1, 123456789012345678], n // 7 + 1)[
            : len(v[5::7])]
    elif typ.name == "double":
        v = rng.normal(size=n) * 1e5
        v[::11] = np.nan
    elif typ.name == "boolean":
        v = rng.random(n) < 0.5
    else:
        v = rng.integers(-(2**31), 2**31, n)
    return tmemory.Column(typ, v.astype(typ.np_dtype), None if ok.all() else ok)


@pytest.mark.parametrize("typ", [TT.BIGINT, TT.INTEGER, TT.DOUBLE, TT.BOOLEAN,
                                 TT.DATE, TT.VARCHAR, TT.decimal(18, 2),
                                 TT.decimal(12, 0)])
@pytest.mark.parametrize("seed", [0, 1])
def test_sink_rebuild_matches_the_row_path(typ, seed, monkeypatch):
    """rebuild_column gives what column_from_pylist over the pieces'
    Python values gives (the JAX package's sink), NULL slots, a piece
    the write leaves out, large decimals and negative codes included."""
    rng = np.random.default_rng(seed)
    pieces = [(_seeded_columns(rng, n, typ), n) for n in (40, 0, 25)]
    pieces.insert(1, (None, 9))
    got = tmemory.rebuild_column(typ, pieces)
    monkeypatch.setattr(tmemory, "_DISTINCT_MIN", 0)  # keep every reading
    cache = tmemory.OrderedDict()
    for _ in range(2):  # reading the pieces' dictionaries, then reusing them
        cached = tmemory.rebuild_column(typ, pieces, cache)
        convert.assert_pages_identical(tmemory.Page([got], len(got), ["x"]),
                                       tmemory.Page([cached], len(cached), ["x"]))
    assert len(cache) == (2 if typ.is_dictionary else 0)  # two pieces with rows
    data = []
    for col, n in pieces:
        data.extend([None] * n if col is None else col.to_python(n))
    want = column_from_pylist(typ, data)
    page = lambda c: tmemory.Page([c], len(data), ["x"])  # noqa: E731
    convert.assert_pages_identical(page(want), page(got))


@pytest.mark.parametrize("n,k", [(0, 3), (10, 3), (70000, 5), (300000, 120000)])
def test_first_appearance_matches_a_full_sort(n, k):
    """The sink's chunked first-appearance order equals the order of a
    full np.unique(return_index) over all rows."""
    rng = np.random.default_rng(n)
    u = rng.integers(0, k, n)
    ids, first = np.unique(u, return_index=True)
    want = ids[np.argsort(first, kind="stable")]
    np.testing.assert_array_equal(tmemory._first_appearance(u, k), want)

"""The port's statement-protocol server against the JAX package's.

Every case of tests/test_server.py runs twice, through both packages'
servers over the same SQL: the JAX package's case as its own file runs
it, and the same case with its imports of ``trino_tpu`` rebound to
``trino_tpu_torch`` on the CPU (``replay_module``).  Each run records
what its clients returned (StatementClient.execute, the embedded DB-API
connection), and the two records must be equal: the same statements,
columns and rows, exact types exactly and doubles to 1e-12.  A case the
JAX package fails still has to pass on the port (its record is then not
compared).  Beside them, the port's /v1/statement documents (columns,
types, the paging of nextUri) are held to the JAX coordinator's, and
the entry points refuse to run on the CPU unless asked.

``replay_module`` is shared by the other server-path replays
(test_torch_distributed.py, test_torch_client.py, test_torch_cluster.py,
test_torch_observability.py).
"""
import ast
import contextlib
import functools
import inspect
import json
import math
import os
import sys
import urllib.request

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))

# -- the port bound to the CPU ----------------------------------------------


def _port_shims():
    """Port objects that take a device, bound to device="cpu", by identity
    of the unbound object (an import of it in a replayed case resolves to
    its bound version)."""
    import trino_tpu_torch.cli as tcli
    import trino_tpu_torch.session as tsession
    import trino_tpu_torch.testing.runner as trunner
    from trino_tpu_torch.server.coordinator import CoordinatorServer
    from trino_tpu_torch.server.worker import WorkerServer

    def cli_main(argv=None):
        return tcli.main(list(argv or []) + ["--device", "cpu"])

    out = {}
    for obj in (tsession.tpch_session, tsession.tpcds_session, tsession.Session,
                trunner.DistributedQueryRunner, trunner.spawn_subprocess_worker,
                trunner.SubprocessCoordinator, CoordinatorServer, WorkerServer):
        out[id(obj)] = functools.partial(obj, device="cpu")
    out[id(tcli.main)] = cli_main
    return out


def _shim(obj):
    return _port_shims().get(id(obj), obj)


class _Missing:
    """A name of a module the port does not have yet."""

    def __init__(self, name):
        self.name = name

    def __call__(self, *a, **k):
        raise NotImplementedError(f"{self.name} is not ported")


class _PortImports(ast.NodeTransformer):
    """Rebind a test module's imports of trino_tpu to trino_tpu_torch, each
    imported name through _shim, and "trino_tpu.*" strings (monkeypatch
    targets) to the port's modules."""

    def _rebind(self, node, names):
        # a name the port does not have (a module it left out) binds
        # placeholders: only the cases not replayed use it
        missing = "\n".join(f"    {n} = __missing__({n!r})" for n in names)
        guard = ast.parse(f"try:\n    pass\nexcept ImportError:\n{missing}").body[0]
        guard.body = [node]
        return [guard] + [ast.parse(f"{n} = __shim__({n})").body[0] for n in names]

    def visit_ImportFrom(self, node):
        mod = node.module or ""
        if mod == "trino_tpu" or mod.startswith("trino_tpu."):
            node.module = "trino_tpu_torch" + mod[len("trino_tpu"):]
            return self._rebind(node, [a.asname or a.name for a in node.names])
        return node

    def visit_Import(self, node):
        for a in node.names:
            if a.name == "trino_tpu" or a.name.startswith("trino_tpu."):
                if a.asname is None and "." in a.name:
                    raise ValueError(f"bare import of {a.name} cannot be rebound")
                a.asname = a.asname or "trino_tpu"
                a.name = "trino_tpu_torch" + a.name[len("trino_tpu"):]
        return node

    def visit_Constant(self, node):
        if isinstance(node.value, str) and node.value.startswith("trino_tpu."):
            node.value = "trino_tpu_torch" + node.value[len("trino_tpu"):]
        return node


# -- recording what the clients returned -------------------------------------


def _recording(pkg: str, rec: list):
    """Patch the package's StatementClient.execute and the embedded DB-API
    path to append (sql, columns, rows) or (sql, error) to rec."""
    import importlib

    client = importlib.import_module(f"{pkg}.client.client")
    dbapi = importlib.import_module(f"{pkg}.client.dbapi")
    stack = contextlib.ExitStack()

    def wrap(orig, embedded):
        def run(self, sql):
            if embedded and self._client is not None:
                return orig(self, sql)
            try:
                cols, rows = orig(self, sql)
            except Exception as e:
                rec.append((sql, "error", type(e).__name__))
                raise
            rec.append((sql, [(c["name"], c.get("type")) for c in cols],
                        [list(r) for r in rows]))
            return cols, rows
        return run

    for cls, attr, embedded in ((client.StatementClient, "execute", False),
                                (dbapi.Connection, "_run", True)):
        orig = getattr(cls, attr)
        setattr(cls, attr, wrap(orig, embedded))
        stack.callback(setattr, cls, attr, orig)
    return stack


def _same_value(a, b):
    if isinstance(a, float) or isinstance(b, float):
        if a is None or b is None:
            return a is b
        if math.isnan(a) and math.isnan(b):
            return True
        return math.isclose(a, b, rel_tol=1e-12, abs_tol=1e-12)
    return type(a) is type(b) and a == b


def _same_rows(ja, pa):
    return len(ja) == len(pa) and all(
        len(x) == len(y) and all(_same_value(u, v) for u, v in zip(x, y))
        for x, y in zip(ja, pa))


def assert_same_records(jax_rec, port_rec):
    """Both packages' clients saw the same statements and results; rows of
    a statement that ran more than once concurrently match as a multiset.
    Statements over the engine's live state (system.*) answer differently
    by design (each package counts its own queries, nodes, metrics): only
    their columns are compared."""
    assert sorted(r[0] for r in jax_rec) == sorted(r[0] for r in port_rec), (
        [r[0] for r in jax_rec], [r[0] for r in port_rec])
    pending = list(port_rec)
    for j in jax_rec:
        live = "system." in j[0].lower()
        for i, p in enumerate(pending):
            if p[0] != j[0]:
                continue
            if j[1] == "error" or p[1] == "error":
                ok = j[1] == p[1]
            else:
                ok = j[1] == p[1] and (live or _same_rows(j[2], p[2]))
            if ok:
                pending.pop(i)
                break
        else:
            raise AssertionError(f"no port result matches the JAX result of "
                                 f"{j[0]!r}: {j[1:]!r}")


# -- replaying a JAX test module ---------------------------------------------


def _fixture_info(fn: ast.FunctionDef):
    for d in fn.decorator_list:
        call = d if isinstance(d, ast.Call) else None
        target = call.func if call else d
        if ast.unparse(target) in ("pytest.fixture", "fixture"):
            kw = {k.arg: ast.literal_eval(k.value) for k in (call.keywords if call else [])}
            return kw
    return None


def _exec_module(filename: str, port: bool):
    """Execute a test module's source with its fixtures and tests as plain
    functions: returns (namespace, {fixture: kwargs}, [(test, decorators)])."""
    with open(os.path.join(TESTS, filename)) as f:
        tree = ast.parse(f.read())
    fixtures, tests = {}, []
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            info = _fixture_info(node)
            if info is not None:
                fixtures[node.name] = info
                node.decorator_list = []
            elif node.name.startswith("test_"):
                tests.append((node.name, [ast.unparse(d) for d in node.decorator_list],
                              node.lineno))
                node.decorator_list = []
    if port:
        tree = ast.fix_missing_locations(_PortImports().visit(tree))
    ns = {"__name__": f"_replay_{'port' if port else 'jax'}_{filename[:-3]}",
          "__file__": os.path.join(TESTS, filename), "__shim__": _shim,
          "__missing__": _Missing}
    exec(compile(tree, os.path.join(TESTS, filename), "exec"), ns)
    return ns, fixtures, tests


_BUILTIN_SPLIT = ("tmp_path",)


def replay_module(filename: str, select=None, skip=(), target=None, distinct=(),
                  jax=True):
    """Define, in the calling test module, one test per case of
    tests/<filename> (those named or at the lines in `select`, none in
    `skip`) that runs the JAX case and the port's replay of it and
    compares their client records.  The module's fixtures are defined
    twice, as jax_<module>_<name> and port_<module>_<name>.  A case
    named or at a line in `distinct` runs closed-loop traffic whose
    number of statements follows the clock: its records are compared as
    sets of distinct records (every result either package saw, the other
    saw too).  With jax=False only the port's replay runs (the caller
    compares it with the JAX package some other way), and only the
    port_<module>_<name> fixtures are defined."""
    target = target if target is not None else sys._getframe(1).f_globals
    jns, jfix, jtests = _exec_module(filename, port=False)
    pns, _pfix, _ = _exec_module(filename, port=True)
    stem = filename[:-3]
    sides = (("jax", jns), ("port", pns)) if jax else (("port", pns),)

    def arg_names(fn):
        return list(inspect.signature(fn).parameters)

    for name, info in jfix.items():
        for side, ns in sides:
            fn = ns[name]
            params = arg_names(fn)
            call_args = ", ".join(
                f"{p}={side}_{stem}_{p}" if p in jfix else
                (f"{p}={p} / '{side}'" if p in _BUILTIN_SPLIT else f"{p}={p}")
                for p in params)
            fparams = ", ".join(f"{side}_{stem}_{p}" if p in jfix else p
                                for p in params)
            gen = inspect.isgeneratorfunction(fn)
            body = (f"    yield from _fn({call_args})\n" if gen
                    else f"    return _fn({call_args})\n")
            src = (f"def _fixture({fparams}):\n{body}")
            env = {"_fn": fn}
            exec(src, env)
            kw = dict(info)
            kw["name"] = f"{side}_{stem}_{name}"
            target[f"_{side}_{stem}_{name}"] = pytest.fixture(**kw)(env["_fixture"])

    for name, decorators, line in jtests:
        if select is not None and name not in select and line not in select:
            continue
        if name in skip or line in skip:
            continue
        jfn, pfn = jns[name], pns[name]
        params = arg_names(jfn)
        wparams = []
        for p in params:
            if p in jfix:
                wparams += [f"{side}_{stem}_{p}" for side, _ns in sides]
            else:
                wparams.append(p)

        def kwargs_src(side):
            return "{" + ", ".join(
                f"{p!r}: {side}_{stem}_{p}" if p in jfix else
                (f"{p!r}: _split({p}, {side!r})" if p in _BUILTIN_SPLIT else f"{p!r}: {p}")
                for p in params) + "}"

        by_set = name in distinct or line in distinct
        call = (f"_run_pair(_jfn, {kwargs_src('jax')}, _pfn, {kwargs_src('port')},"
                f" distinct={by_set})" if jax else
                f"_run_port(_pfn, {kwargs_src('port')})")
        src = "".join(f"@{d}\n" for d in decorators) + (
            f"def {name}({', '.join(wparams)}):\n    {call}\n")
        env = dict(jns)
        env.update({"_jfn": jfn, "_pfn": pfn, "_run_pair": run_pair,
                    "_run_port": run_port, "_split": _split})
        exec(src, env)
        fn = env[name]
        fn.__doc__ = (f"tests/{filename}:{line} through both packages' servers."
                      if jax else f"tests/{filename}:{line} through the port.")
        target[name] = fn


def _split(tmp_path, side):
    d = tmp_path / side
    d.mkdir(exist_ok=True)
    return d


def _distinct(rec):
    return {repr(r) for r in rec}


@contextlib.contextmanager
def _private_tmp():
    """A temporary directory of the case's own as the process's (and its
    children's) temp dir: what a case writes under the default temp dir
    (the FTE spool trees, addressed by the cases' fixed query ids) can
    meet neither the other package's run of the case, nor a task thread
    it left running, nor the same test file run by another process."""
    import shutil
    import tempfile

    saved = tempfile.tempdir, os.environ.get("TMPDIR")
    d = tempfile.mkdtemp(prefix="replay_")
    tempfile.tempdir = d
    os.environ["TMPDIR"] = d
    try:
        yield d
    finally:
        tempfile.tempdir = saved[0]
        if saved[1] is None:
            os.environ.pop("TMPDIR", None)
        else:
            os.environ["TMPDIR"] = saved[1]
        shutil.rmtree(d, ignore_errors=True)


def run_port(pfn, pkw):
    """Run the port's replay of a case under a temp dir of its own."""
    with _private_tmp():
        pfn(**pkw)


def run_pair(jfn, jkw, pfn, pkw, distinct=False):
    """Run the JAX case, then the port's, each under a temp dir of its
    own; the port must pass, and when the JAX case passed too their
    client records must be equal (as sets of distinct records, with
    ``distinct``)."""
    jrec, prec = [], []
    jax_error = None
    with _recording("trino_tpu", jrec), _private_tmp():
        try:
            jfn(**jkw)
        except Exception as e:  # the reference's own failure: see above
            jax_error = e
    with _recording("trino_tpu_torch", prec), _private_tmp():
        pfn(**pkw)
    if jax_error is None:
        if distinct:
            assert prec and _distinct(jrec) == _distinct(prec), (
                _distinct(jrec) ^ _distinct(prec))
        else:
            assert_same_records(jrec, prec)


replay_module("test_server.py")


# -- the statement documents -------------------------------------------------


@pytest.fixture(scope="module")
def both_servers():
    from trino_tpu.server.coordinator import CoordinatorServer as JServer
    from trino_tpu.session import tpch_session as jsession
    from trino_tpu_torch.server.coordinator import CoordinatorServer as TServer
    from trino_tpu_torch.session import tpch_session as tsession

    js = JServer(jsession(0.001, client_page_rows=500)).start()
    ts = TServer(tsession(0.001, device="cpu", client_page_rows=500),
                 device="cpu").start()
    yield js, ts
    js.stop()
    ts.stop()


def _documents(uri, sql):
    """Every document of one statement: the POST's, then each nextUri's
    (ids, slugs and timings removed: they differ by construction)."""
    req = urllib.request.Request(f"{uri}/v1/statement", data=sql.encode(),
                                 method="POST")
    with urllib.request.urlopen(req) as r:
        doc = json.load(r)
    docs = []
    while True:
        docs.append(doc)
        nxt = doc.get("nextUri")
        if not nxt:
            return docs
        with urllib.request.urlopen(uri + nxt) as r:
            doc = json.load(r)


def _finished(docs):
    """The FINISHED documents' columns, data and the token of each nextUri
    (the statement pages under client_page_rows)."""
    out = []
    for d in docs:
        if d["stats"]["state"] != "FINISHED":
            continue
        nxt = d.get("nextUri")
        out.append({"columns": d.get("columns"), "data": d.get("data"),
                    "next": nxt and nxt.rsplit("/", 1)[-1],
                    "processedRows": d["stats"].get("processedRows")})
    return out


@pytest.mark.parametrize("sql", [
    "select o_orderkey, o_orderdate, o_totalprice, o_orderstatus, o_comment "
    "from orders order by o_orderkey",
    "select n_name, n_regionkey, cast(n_nationkey as double) / 7 as r from nation "
    "order by n_name",
    "select l_returnflag, sum(l_extendedprice * (1 - l_discount)) as s, "
    "avg(l_quantity) as q, count(*) from lineitem group by 1 order by 1",
    "select nope from orders",
])
def test_statement_documents_match_jax(both_servers, sql):
    js, ts = both_servers
    jd, td = _documents(js.uri, sql), _documents(ts.uri, sql)
    jf, tf = _finished(jd), _finished(td)
    if not jf:  # a failed statement: the error document's shape
        assert jd[-1]["stats"]["state"] == td[-1]["stats"]["state"] == "FAILED"
        assert {k for k in jd[-1]["error"]} == {k for k in td[-1]["error"]}
        assert jd[-1]["error"]["message"] == td[-1]["error"]["message"]
        return
    assert len(jf) == len(tf) > 0
    for a, b in zip(jf, tf):
        assert a["columns"] == b["columns"]
        assert a["next"] == b["next"] and a["processedRows"] == b["processedRows"]
        assert _same_rows(a["data"], b["data"])
    assert sum(len(a["data"]) for a in jf) == jf[0]["processedRows"]


# -- the entry points refuse the CPU unless asked ----------------------------


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    import torch

    from trino_tpu_torch import cli
    from trino_tpu_torch.server.coordinator import CoordinatorServer
    from trino_tpu_torch.server.worker import WorkerServer
    from trino_tpu_torch.session import tpch_session
    from trino_tpu_torch.testing import DistributedQueryRunner
    from trino_tpu_torch.testing.runner import _build_catalogs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cats = _build_catalogs([("tpch", "tpch", {"tpch.scale-factor": 0.001})])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WorkerServer(cats)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CoordinatorServer(tpch_session(0.001, device="cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedQueryRunner(workers=1)
    assert cli.main(["--sf", "0.001", "-e", "select 1"]) == 1
    # asked for the CPU, each of them runs there
    w = WorkerServer(cats, device="cpu")
    assert w.device.type == "cpu" and w.supervisor.device.type == "cpu"
    w.httpd.server_close()
    srv = CoordinatorServer(tpch_session(0.001, device="cpu"), device="cpu")
    srv.httpd.server_close()
    with pytest.raises(ValueError, match="needs a session on that device"):
        CoordinatorServer(tpch_session(0.001, device="cpu"), device="meta")

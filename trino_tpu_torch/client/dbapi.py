"""DB-API 2.0 (PEP 249) driver — the JDBC-driver analog.

Counterpart of trino_tpu/client/dbapi.py (copied).

Reference parity: client/trino-jdbc (TrinoDriver/TrinoConnection/
TrinoResultSet built over the statement protocol).  Python programs use
this the way Java programs use the JDBC driver:

    import trino_tpu_torch.client.dbapi as dbapi
    conn = dbapi.connect("http://127.0.0.1:8080", user="alice")
    cur = conn.cursor()
    cur.execute("select * from nation where n_regionkey = ?", (3,))
    rows = cur.fetchall()

Parameters use qmark style and are bound client-side with literal
substitution (strings escaped), like the reference's simple prepared-
statement emulation before server-side EXECUTE.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

apilevel = "2.0"
threadsafety = 1  # threads may share the module, not connections
paramstyle = "qmark"


class Error(Exception):
    pass


class InterfaceError(Error):
    pass


class DatabaseError(Error):
    pass


class ProgrammingError(DatabaseError):
    pass


def _quote(value) -> str:
    if value is None:
        return "NULL"
    if isinstance(value, bool):
        return "TRUE" if value else "FALSE"
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, (list, tuple)):
        return "ARRAY[" + ", ".join(_quote(v) for v in value) + "]"
    return "'" + str(value).replace("'", "''") + "'"


def _bind(sql: str, params: Sequence) -> str:
    """qmark substitution outside string literals."""
    out = []
    it = iter(params)
    in_str = False
    i = 0
    while i < len(sql):
        ch = sql[i]
        if ch == "'":
            in_str = not in_str
            out.append(ch)
        elif ch == "?" and not in_str:
            try:
                out.append(_quote(next(it)))
            except StopIteration:
                raise ProgrammingError("not enough parameters") from None
        else:
            out.append(ch)
        i += 1
    leftover = sum(1 for _ in it)
    if leftover:
        raise ProgrammingError(f"{leftover} unused parameter(s)")
    return "".join(out)


class Cursor:
    arraysize = 1

    def __init__(self, connection: "Connection"):
        self.connection = connection
        self.description: Optional[List[tuple]] = None
        self.rowcount = -1
        self._rows: List[tuple] = []
        self._pos = 0
        self._closed = False

    # -- execution ------------------------------------------------------
    def execute(self, operation: str, parameters: Sequence = ()) -> "Cursor":
        if self._closed:
            raise InterfaceError("cursor is closed")
        sql = _bind(operation, parameters or ())
        try:
            cols, rows = self.connection._run(sql)
        except Error:
            raise
        except Exception as e:
            raise DatabaseError(str(e)) from e
        self.description = [
            (c["name"], c.get("type", "unknown"), None, None, None, None,
             None)
            for c in cols
        ]
        self._rows = [tuple(r) for r in rows]
        self._pos = 0
        self.rowcount = len(self._rows)
        return self

    def executemany(self, operation: str, seq_of_parameters) -> "Cursor":
        for p in seq_of_parameters:
            self.execute(operation, p)
        return self

    # -- fetching -------------------------------------------------------
    def fetchone(self) -> Optional[tuple]:
        if self._pos >= len(self._rows):
            return None
        row = self._rows[self._pos]
        self._pos += 1
        return row

    def fetchmany(self, size: Optional[int] = None) -> List[tuple]:
        n = size if size is not None else self.arraysize
        out = self._rows[self._pos : self._pos + n]
        self._pos += len(out)
        return out

    def fetchall(self) -> List[tuple]:
        out = self._rows[self._pos :]
        self._pos = len(self._rows)
        return out

    def __iter__(self):
        while True:
            row = self.fetchone()
            if row is None:
                return
            yield row

    def close(self):
        self._closed = True

    # no-ops required by PEP 249
    def setinputsizes(self, sizes):
        pass

    def setoutputsize(self, size, column=None):
        pass


class Connection:
    def __init__(self, target, user: str = "dbapi",
                 password: Optional[str] = None, source: str = ""):
        self._closed = False
        self._session = None
        self._client = None
        if isinstance(target, str):
            from .client import StatementClient

            self._client = StatementClient(
                target, user=user, password=password, source=source
            )
        else:  # in-process Session (the PlanTester-style embedded mode)
            self._session = target
            self._user = user

    def _run(self, sql: str) -> Tuple[List[dict], List[list]]:
        if self._closed:
            raise InterfaceError("connection is closed")
        if self._client is not None:
            return self._client.execute(sql)
        page = self._session.execute(sql, user=self._user)
        types = [c.type for c in page.columns]
        cols = [
            {"name": n, "type": str(t)}
            for n, t in zip(page.names, types)
        ]
        return cols, [list(r) for r in page.to_pylist()]

    def cursor(self) -> Cursor:
        if self._closed:
            raise InterfaceError("connection is closed")
        return Cursor(self)

    def commit(self):
        pass  # autocommit (per-statement transactions)

    def rollback(self):
        raise DatabaseError("rollback is not supported (autocommit)")

    def close(self):
        self._closed = True


def connect(target, user: str = "dbapi", password: Optional[str] = None,
            source: str = "") -> Connection:
    """target: server URI ('http://host:port') or an in-process Session."""
    return Connection(target, user, password, source)

"""The port's scan layer (trino_tpu_torch/exec/scan.py): every way a
scan's columns reach the device gives the lanes of an uncached host read.

One case a path: a host read uploaded, lanes generated on the device, a
cache hit, a column filled into a cached entry, a streamed tile's lanes
staged by the prefetch thread, and a mesh shard's.  Each case's
lineitem lanes (concatenated over tiles or shards, in split order) equal
those of a session with the scan cache and device generation off, and
its `scan_load` spans carry the attributes its path sets.
"""
import numpy as np
import pytest

from trino_tpu_torch.exec import scan
from trino_tpu_torch.plan import nodes as P
from trino_tpu_torch.session import tpch_session

SF = 0.01
SQL = "select sum(l_quantity), sum(l_extendedprice) from lineitem"
COLUMNS = ("l_quantity", "l_extendedprice")
SHARDS = 4

# path -> (session properties, a query run first, the attributes of
# each lineitem scan_load span, the columns generated on the device)
CASES = {
    "host-upload": ({"device_generation": False}, None, {"cache": "miss"}, None),
    "device-generation": ({}, None, {"cache": "miss"}, set(COLUMNS)),
    "cache-hit": ({}, SQL, {"cache": "hit"}, None),
    "column-fill": ({}, "select sum(l_quantity) from lineitem",
                    {"cache": "miss", "filled": 1}, {"l_extendedprice"}),
    "streamed-tile": ({"query_max_memory_bytes": 300_000}, None,
                      {"cache": "uncached"}, set(COLUMNS)),
    "mesh-shard": ({"distributed": True, "num_devices": SHARDS}, None,
                   {"cache": "miss"}, set(COLUMNS)),
}


def _capture(monkeypatch):
    """Every lineitem leaf's lanes as `LoadedScan.lanes` returns them, by
    column, with whether a prefetch had staged them."""
    calls = []
    real = scan.LoadedScan.lanes

    def lanes(self, ex):
        staged = self.staged is not None
        out = real(self, ex)
        if isinstance(self.node, P.TableScan) and self.node.table == "lineitem":
            col_of = dict(self.node.assignments)
            calls.append((staged, {col_of[s]: (v.cpu().numpy(), ok.cpu().numpy())
                                   for s, (v, ok) in out.items()}))
        return out

    monkeypatch.setattr(scan.LoadedScan, "lanes", lanes)
    return calls


def _spans(s, name, table="lineitem"):
    return [sp for sp in s.tracer.spans
            if sp.name == name and sp.attributes.get("table") == table]


def _concat(parts):
    return {c: tuple(np.concatenate([p[c][i] for p in parts]) for i in (0, 1))
            for c in COLUMNS}


@pytest.fixture(scope="module")
def uncached():
    s = tpch_session(SF, device="cpu", result_cache=False,
                     scan_cache_enabled=False, device_generation=False)
    s.tracer.clear()
    with pytest.MonkeyPatch.context() as mp:
        calls = _capture(mp)
        page = s.execute(SQL)
    (load,) = _spans(s, "scan_load")
    assert load.attributes["cache"] == "uncached"
    ((staged, lanes),) = calls
    assert not staged
    return page.to_pylist(), lanes, load.attributes["rows"]


@pytest.mark.parametrize("path", sorted(CASES))
def test_every_scan_path_gives_the_uncached_lanes(monkeypatch, uncached, path):
    props, first, attrs, generated = CASES[path]
    want_rows, want_lanes, total = uncached
    s = tpch_session(SF, device="cpu", result_cache=False, **props)
    if first is not None:
        s.execute(first)
    s.tracer.clear()
    calls = _capture(monkeypatch)
    assert s.execute(SQL).to_pylist() == want_rows
    prof = s.last_kernel_profile
    loads = _spans(s, "scan_load")
    for load in loads:
        assert {k: load.attributes.get(k) for k in attrs} == attrs
        assert ("filled" in load.attributes) == ("filled" in attrs)
    assert sum(load.attributes["rows"] for load in loads) == total
    made = [set(g.attributes["columns"].split(",")) for g in _spans(s, "scan_generate")]
    if path == "streamed-tile":
        # each tile's lanes made on the prefetch thread, then handed over
        tiles = sum(prof["streamedTiles"].values())
        assert tiles > 1 and len(loads) == tiles == prof["preuploads"]
        assert len(calls) == 2 * tiles
        calls = [c for c in calls if c[0]]  # the visits, in tile order
        assert len(calls) == tiles
        assert made == [generated] * tiles
    elif path == "mesh-shard":
        assert len(loads) == len(calls) == SHARDS
        assert made == [generated] * SHARDS
    else:
        assert len(loads) == len(calls) == 1 and not calls[0][0]
        assert made == ([generated] if generated else [])
    got = _concat([lanes for _, lanes in calls])
    for c in COLUMNS:
        for g, w in zip(got[c], want_lanes[c]):
            assert np.array_equal(g, w), (path, c)

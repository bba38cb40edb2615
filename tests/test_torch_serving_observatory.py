"""The port's serving observatory against the JAX package's.

Every case of tests/test_serving_observatory.py replayed through both
packages (test_torch_server.replay_module: the same case, the port's
imports rebound to trino_tpu_torch on the CPU, the clients' records
compared): the census rollup and its overflow bucket, the two-segment
store across restarts and torn tails, the history backfill, the SLO
burn journal and the doctor's ranking of it, per-tenant objectives, the
three system tables, the coordinator's feed of the census, the SLOs and
the /v1/signatures, /v1/affinity and /v1/slo routes, and the serve-smoke
SLO gate (scripts/check_serve_smoke.py imports nothing of either
package, so its replay runs the same script source).

Beside them, a serving-observatory directory written by one package's
observatory merges in the other's to the same census and SLO rows.
"""
import pytest

from test_torch_server import replay_module

replay_module("test_serving_observatory.py")


def _feed(so, directory):
    obs = so.ServingObservatory(str(directory), name="writer")
    for i in range(8):
        obs.observe_query(
            signature="sig-%d" % (i % 3), tenant=("etl", "bi")[i % 2],
            query_id="q%d" % i, latency_s=0.05 * (i + 1), ok=i != 5,
            device_wall_s=0.01 * i, host_wall_s=0.002 * i,
            drift_ratio=1.0 + i, cache_hit=bool(i % 2),
            cache_stored=i == 0, families=["fam%d" % (i % 2)],
            node_id="node-1", ts=1000.0 + i, quiet=True,
        )
    obs.sync()
    obs.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_observatory_directories_cross_between_the_packages(tmp_path, writer):
    import trino_tpu.obs.serving_observatory as jso
    import trino_tpu_torch.obs.serving_observatory as tso

    _feed(jso if writer == "jax" else tso, tmp_path)
    assert jso.read_observatory_dir(str(tmp_path)) == \
        tso.read_observatory_dir(str(tmp_path))
    ja = jso.ServingObservatory(str(tmp_path), name="reader")
    ta = tso.ServingObservatory(str(tmp_path), name="reader")
    try:
        rows = ta.signature_rows()
        assert len(rows) == 3 and sum(r["count"] for r in rows) == 8
        assert rows == ja.signature_rows()
        assert ta.slo_rows(now=1010.0) == ja.slo_rows(now=1010.0)
    finally:
        ja.close()
        ta.close()

"""The port's server-path observability against the JAX package's.

tests/test_observability.py replayed through both packages
(test_torch_server.replay_module): the Prometheus exposition, W3C
traceparent propagation, the OTLP file export, HttpEventListener, and
over a two-worker cluster the metrics on every node, the trace joined
across nodes, the query profile endpoint and system.runtime.metrics.
EXPLAIN ANALYZE's kernel profile (the TPU's compile and padding text) is
the single-session path's, held to the JAX package by
test_torch_opstats.py.
"""
from test_torch_server import replay_module

replay_module("test_observability.py", skip=[386])

"""The port's services (verifier and proxy) and SQL routines against the
JAX package's.

Every case of tests/test_services.py replayed through both packages
(test_torch_server.replay_module: the same case, the port's imports
rebound to trino_tpu_torch on the CPU, the clients' records compared):
CREATE / DROP FUNCTION and the SHOW statements, the verifier between two
sessions and between two coordinators over HTTP, the proxy forwarding
statements and credentials, and the OTLP file exporter.
"""
from test_torch_server import replay_module

replay_module("test_services.py")

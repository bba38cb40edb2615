"""The port's DB-API driver against the JAX package's.

The DB-API cases of tests/test_client_features.py (embedded over an
in-process session and over HTTP to a coordinator; qmark parameters,
escaping, iteration, errors, a DML round trip), replayed through both
packages (test_torch_server.replay_module): each case passes on the port
and both drivers return the same rows.
"""
from test_torch_server import replay_module

replay_module("test_client_features.py", select=[26, 37, 53, 63, 71, 81, 94, 104])

"""The port's resource groups, admission, cluster memory and HTTP
authentication against the JAX package's.

Replayed through both packages' servers (test_torch_server.replay_module):
the resource-group, admission and HTTP-auth cases of
tests/test_cluster_features.py; every case of tests/test_serving.py,
the doctor's overload rules and the autoscaler's scale-out and scale-in
with zero failed queries (its new workers are subprocess workers on the
runner's device; its closed-loop sessions run as many statements as the
clock allows, so its records compare as distinct results) included; the
killer, cluster-memory and admission
cases of
tests/test_memory.py, with its end-to-end low-memory killer.
"""
from test_torch_server import replay_module

replay_module("test_cluster_features.py", select=[29, 42, 50, 71, 87, 194])
replay_module("test_serving.py", distinct=[321])
replay_module("test_memory.py", select=[175, 193, 208, 223, 239, 269, 296, 302,
                                        314, 329, 435])

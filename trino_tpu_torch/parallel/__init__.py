"""Execution of one query over a mesh of logical shards.

Counterpart of trino_tpu/parallel/: the mesh executor
(mesh_executor.py), the hash and range repartition (shuffle.py) and the
collectives the exchanges are made of (collectives.py).  One process
drives every shard in lockstep; the collectives are functions over the
shards' tensors.
"""

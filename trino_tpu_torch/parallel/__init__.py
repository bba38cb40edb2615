"""Execution of one query over a mesh of logical shards.

Counterpart of trino_tpu/parallel/: the mesh executor
(mesh_executor.py), the hash and range repartition (shuffle.py) and the
collectives the exchanges are made of (collectives.py).  One process
drives every shard in lockstep; the collectives are functions over the
shards' tensors.  A worker of a multi-host cluster runs a
slice-eligible fragment task over its own shards
(CrossHostFragmentExecutor).
"""
from .mesh_executor import (  # noqa: F401
    CrossHostFragmentExecutor,
    MeshExecutor,
    default_mesh,
    slice_eligible,
)

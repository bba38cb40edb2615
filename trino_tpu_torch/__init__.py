"""trino_tpu_torch — the PyTorch/CUDA port of trino_tpu for NVIDIA Hopper.

A second package beside the JAX reference (trino_tpu/): the same SQL
frontend (copied, pure Python), the same logical plans, and an eager
PyTorch executor whose hot kernels are written by hand in CUDA C++ for
sm_90a (csrc/, built with nvcc at first use).  The port imports torch
and never jax or trino_tpu.  Entry points (session.tpch_session) run on
the CUDA card unless the caller asks for device="cpu".
"""

__version__ = "0.1.0"

"""lara-tpu-torch: the lara-tpu solver ported to PyTorch and CUDA.

A second package beside the JAX reference ``lara_tpu``: the same CLI flags,
inputs and output bytes, with the batched subgradient solver in eager
PyTorch, the hybrid backend (device DP + native host bookkeeping) for the
host-matching modes, and hand-written CUDA kernels for Hopper (``csrc/``):
the forward wavefront DP (K1), its traceback (K2), the greedy lookahead
matching (K3), and the grid-stepped (K1-grid, K2-grid) and resident (K-res)
layouts of the DP.  Host code that imports no JAX (input, output,
interaction models, the scalar mirror, the native bookkeeping) is imported
from ``lara_tpu``.  This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"

"""lara-tpu-torch: the lara-tpu solver ported to PyTorch and CUDA.

A second package beside the JAX reference ``lara_tpu``: the same CLI flags,
inputs and output bytes, with the batched subgradient solver in eager
PyTorch, the hybrid backend (device DP + native host bookkeeping) for the
host-matching modes, and hand-written CUDA kernels for Hopper (``csrc/``):
the forward wavefront DP (K1), its traceback (K2), the greedy lookahead
matching (K3), the grid-stepped (K1-grid, K2-grid) and resident (K-res)
layouts of the DP, the edge filter (K4), and the chain of dependent
wavefront steps that the card microbenchmark ``benchmark`` times (KB).
The host code (input, output, interaction models,
the scalar mirror, the native bookkeeping) is the port's own copy of the
JAX package's, under the same module names.  This package imports
``torch``, never ``jax`` and nothing of ``lara_tpu``.
"""

__version__ = "0.1.0"

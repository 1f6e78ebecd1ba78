"""lara-tpu-torch: the lara-tpu solver ported to PyTorch and CUDA.

A second package beside the JAX reference ``lara_tpu``: the same CLI flags,
inputs and output bytes, with the batched subgradient solver in eager
PyTorch and three hand-written CUDA kernels for Hopper (``csrc/``): the
forward wavefront DP (K1), its traceback (K2) and the greedy lookahead
matching (K3).  Host code that imports no JAX (input, output, interaction
models, the scalar mirror) is imported from ``lara_tpu``.  This package
imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"

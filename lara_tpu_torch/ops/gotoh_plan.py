"""Which wavefront DP kernels an alignment call launches.

Counterpart of ``_use_stream`` (``lara_tpu/ops/gotoh_pallas.py:622``),
``align_plan`` (``:687``) and ``_align_dchunk``
(``lara_tpu/solver/device_solver.py:81-96``), with the same switches and
the same precedence:

* ``LARA_DP_GRID=1``: K1-grid + K2-grid, K1's and K2's kernels over the
  grid variant's layouts (pre-skewed scores in, diagonal-major codes of
  ``Dp`` rows out), one launch each (``csrc/gotoh_dp.cu``);
* else ``LARA_DP_RESIDENT=1``: K-res, forward sweep and traceback in one
  CTA per pair with the direction codes in shared memory
  (``csrc/gotoh_resident.cu``), where the pair fits the card's opt-in
  shared memory; a pair that does not fit takes the default, as the JAX
  plan falls back to the stream kernels when its VMEM cap is below one lane;
* else the default K1 + K2 (``csrc/gotoh_dp.cu``).

The plan is arithmetic on the bucket's shape, made before any launch.  The
JAX plan's VMEM halving of ``dchunk`` has no counterpart: on the card
``dchunk`` only pads the grid variant's codes to ``Dp`` rows (D rounded up
to ``dchunk``), and no valid output depends on it.
"""

from __future__ import annotations

import os
from typing import NamedTuple

STREAM, GRID, RESIDENT = "stream", "grid", "resident"

#: ``dchunk`` of the hybrid backend, which calls the DP with the JAX
#: default (``align_pssm_batch_pallas``'s ``dchunk=8``)
DEFAULT_DCHUNK = 8

#: opt-in shared memory per block of an H100 (cudaDevAttrMaxSharedMemory
#: PerBlockOptin), the limit a plan on the CPU is made against
H100_SMEM_OPTIN = 232448


class Plan(NamedTuple):
    variant: str  # STREAM, GRID or RESIDENT
    dchunk: int   # the grid variant's codes pad to a multiple of it


def fused_dchunk(la_max: int, lb_max: int) -> int:
    """The fused solver's ``dchunk``: 8 up to ``la_max + lb_max = 512``,
    else 32; ``LARA_DCHUNK`` overrides it."""
    override = os.environ.get("LARA_DCHUNK")
    if override:
        value = int(override)
        if value <= 0:
            raise ValueError(
                f"LARA_DCHUNK must be a positive int, got {override!r}")
        return value
    return 8 if la_max + lb_max <= 512 else 32


def resident_bytes(la_max: int, lb_max: int) -> int:
    """Shared memory one K-res CTA needs: nine wavefront rings of W int32,
    three terminal values and D * W int8 direction codes
    (``gotoh_resident.cu::resident_bytes``)."""
    width = la_max + 1
    num_diag = la_max + lb_max + 1
    return (9 * width + 3) * 4 + num_diag * width


def choose(la_max: int, lb_max: int, smem_limit: int,
           dchunk: int = DEFAULT_DCHUNK) -> Plan:
    """The variant for a ``[B, la_max, lb_max]`` call on a device whose
    opt-in shared memory per block is ``smem_limit`` bytes."""
    if os.environ.get("LARA_DP_GRID"):
        return Plan(GRID, dchunk)
    if os.environ.get("LARA_DP_RESIDENT") \
            and resident_bytes(la_max, lb_max) <= smem_limit:
        return Plan(RESIDENT, dchunk)
    return Plan(STREAM, dchunk)

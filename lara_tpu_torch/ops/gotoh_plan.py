"""Which wavefront DP kernels an alignment call launches.

Counterpart of ``_use_stream`` (``lara_tpu/ops/gotoh_pallas.py:622``),
``align_plan`` (``:687``) and ``_align_dchunk``
(``lara_tpu/solver/device_solver.py:81-96``), with the same switches and
the same precedence:

* ``LARA_DP_GRID=1``: K1-grid + K2-grid, K1's and K2's kernels over the
  grid variant's layouts (pre-skewed scores in, diagonal-major codes of
  ``Dp`` rows out), one launch each (``csrc/gotoh_dp.cu``);
* else ``LARA_DP_RESIDENT=1``: K-res, K1's forward sweep and K2's walk in
  one CTA per pair with the direction codes in shared memory
  (``csrc/gotoh_dp.cu``), where the pair fits the card's opt-in shared
  memory (:func:`resident_warps`); a pair that does not fit takes the
  default, as the JAX plan falls back to the stream kernels when its VMEM
  cap is below one lane;
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

#: K1's constants (``csrc/gotoh_dp.cu``): warps per CTA at most, cells in
#: a ring between strips, steps per block, and the slots of a lane's score
#: ring (three chunks of 32)
K1_MAX_WARPS = 16
K1_RING = 88
K1_SUB = 8
K1_TILE_COLS = 96
#: ints of shared memory per warp of K1's sweep: the score rings of its 32
#: rows and its input ring of (M, H, V) cells in 64-bit words
K1_WARP_INTS = 32 * K1_TILE_COLS + 6 * K1_RING


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


def schedule_safe(la_max: int, lb_max: int, warps: int) -> bool:
    """Whether K1's strip schedule always finishes with ``warps`` warps per
    pair.  A warp takes strips k, k + warps, ..., and a strip waits for room
    in its consumer's ring; with more strips than warps, the last warp's
    strip waits on a strip that the first warp has not started yet, and
    the chain closes once a row is longer than about warps * (ring + 28 -
    steps per block).  The launchers refuse what this refuses
    (``csrc/gotoh_dp.cu::ring_safe``), with a margin under the point where a
    model of the schedule stalls (``tests/test_torch_gotoh.py``)."""
    strips = (la_max + 32) // 32
    return strips <= warps or warps * (K1_RING + 28 - K1_SUB) >= lb_max + 32


def resident_pitch(lb_max: int) -> int:
    """Words per row of K-res's codes: the least odd number past the last
    word a lane stores, ``(lb_max + 31) // 4`` (odd, so that a warp step's
    32 stores, one per row, fall in 32 banks)."""
    return ((lb_max + 31) // 4 + 1) | 1


def resident_bytes(la_max: int, lb_max: int, warps: int) -> int:
    """Shared memory of one K-res CTA of ``warps`` warps: K1's rings
    (:data:`K1_WARP_INTS` and a count per warp), the three terminal
    values, then from a 16-byte boundary the codes, ``la_max + 1`` rows of
    :func:`resident_pitch` words (``gotoh_dp.cu::resident_bytes``)."""
    head = -(-(warps * (K1_WARP_INTS + 1) + 3) // 4) * 4
    return 4 * (head + (la_max + 1) * resident_pitch(lb_max))


def resident_warps(la_max: int, lb_max: int, smem_limit: int) -> int:
    """K-res's warps per pair on a device whose opt-in shared memory per
    block is ``smem_limit`` bytes: one per strip of 32 rows, at most
    :data:`K1_MAX_WARPS`, as many as fit beside the codes; 0 where the pair
    does not fit (no warp fits, or the strip schedule of those that fit
    could stall: :func:`schedule_safe`)."""
    warps = min(K1_MAX_WARPS, (la_max + 32) // 32)
    while warps and resident_bytes(la_max, lb_max, warps) > smem_limit:
        warps -= 1
    return warps if warps and schedule_safe(la_max, lb_max, warps) else 0


def choose(la_max: int, lb_max: int, smem_limit: int,
           dchunk: int = DEFAULT_DCHUNK) -> Plan:
    """The variant for a ``[B, la_max, lb_max]`` call on a device whose
    opt-in shared memory per block is ``smem_limit`` bytes."""
    if os.environ.get("LARA_DP_GRID"):
        return Plan(GRID, dchunk)
    if os.environ.get("LARA_DP_RESIDENT") \
            and resident_warps(la_max, lb_max, smem_limit):
        return Plan(RESIDENT, dchunk)
    return Plan(STREAM, dchunk)

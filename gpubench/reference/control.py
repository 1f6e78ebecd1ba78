"""The control of the benchmark's output check: the reference put in the
program's place and computed in the nearest precision below the one the
configurations state.  The solver's one float computation is the
subgradient step and dual update, in float32 (``subgradient_solver.hpp:
265-271``); the control rounds each of its float32 values to bfloat16 (round
to nearest even), the half-precision dual update a later change might try.
Everything else of the reference is integer and stays as it is."""

from __future__ import annotations

import numpy as np


def to_bfloat16(value) -> np.float32:
    """``value`` as float32, rounded to the nearest bfloat16 (ties to even),
    returned as a float32 that holds the bfloat16 value exactly."""
    bits = np.asarray(np.float32(value)).view(np.uint32).item()
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return np.array([bits], dtype=np.uint32).view(np.float32)[0]

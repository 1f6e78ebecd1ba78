"""The run parameters that the reference reads, from a configuration's
``params`` (the CLI's defaults where a key is absent): the fields of the
port's ``params.Parameters`` that the solver uses, converted to fixed point
as ``parameters.hpp:303-314`` converts them."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from gpubench.reference.ribosum import ribosum65n_fixed
from gpubench.reference.types import f2i


@dataclass
class Parameters:
    num_iterations: int = 500
    max_nondecr_iterations: int = 50
    step_size_factor: float = 1.0
    matching: int = 5
    suboptimal_diff: float = 40.0
    balance: float = 1.0
    balance_auto: bool = False
    sequence_scale: float = 0.0
    gap_extend: float = -2.0
    gap_open: float = -6.0
    precise_bpp: bool = False
    score_matrix: np.ndarray = field(default_factory=ribosum65n_fixed)

    @property
    def gap_open_int(self) -> np.int32:
        return f2i(self.gap_open)

    @property
    def gap_extend_int(self) -> np.int32:
        return f2i(self.gap_extend)


def effective_balance(params: Parameters, identity: float) -> float:
    """The structural-score weight for one pair: ``-b <float>`` as given;
    ``-b auto`` keyed on the pair's ``avSeqId`` as the port's
    ``interactions.effective_balance`` keys it (1.0 at >= 0.8, 0.25 at
    >= 0, else 0.5)."""
    if not params.balance_auto:
        return float(params.balance)
    if identity >= 0.8:
        return 1.0
    return 0.25 if identity >= 0.0 else 0.5

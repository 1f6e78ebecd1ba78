"""Carry solver state across from the JAX package and back.

Given the same numpy inputs, ``lara_tpu.solver.device_solver`` and
:mod:`lara_tpu_torch.solver.device_solver` compute on identical state:
:func:`model_to_torch` uploads a ``BatchModel`` of numpy (or JAX) arrays,
:func:`carry_to_torch` a solver carry, and :func:`carry_to_numpy` brings a
carry of either package back as numpy arrays for comparison.  Both packages'
``BatchModel`` and ``_Carry`` have the same fields in the same order.
"""

from __future__ import annotations

import numpy as np
import torch

from lara_tpu_torch.solver.device_solver import BatchModel, _Carry


def _tensor(value, device: torch.device) -> torch.Tensor:
    # a copy: arrays exported by JAX are read-only
    return torch.from_numpy(np.array(value)).to(device)


def model_to_torch(model, device: torch.device) -> BatchModel:
    return BatchModel(*(_tensor(v, device) for v in model))


def carry_to_torch(carry, device: torch.device) -> _Carry:
    return _Carry(*(_tensor(v, device) for v in carry))


def carry_to_numpy(carry) -> _Carry:
    return _Carry(*(
        v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        for v in carry))

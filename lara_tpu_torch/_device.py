"""Device selection for the port.

``LARA_PLATFORM`` is the JAX package's platform knob, read here with torch
values: unset or ``gpu`` selects a card and raises when CUDA is missing;
``cpu`` runs the kernels' plain versions on the CPU.  There is no silent
fallback from the card to the CPU.  A card is always named by its index
(``cuda:0``): the kernels launch on the calling thread's current card, and
:func:`lara_tpu_torch._build.require` holds each tensor's card against it.
"""

from __future__ import annotations

import os

import torch


def resolve_device() -> torch.device:
    """The current card, by index, or the CPU under ``LARA_PLATFORM=cpu``."""
    platform = os.environ.get("LARA_PLATFORM", "") or "gpu"
    if platform == "gpu":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "LARA_PLATFORM is unset or 'gpu', which needs CUDA, but "
                "torch.cuda.is_available() is False; set LARA_PLATFORM=cpu "
                "to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    if platform == "cpu":
        return torch.device("cpu")
    raise ValueError(
        f"LARA_PLATFORM={platform!r}: the PyTorch port takes 'gpu' or 'cpu'")

"""Verbosity-gated stderr logging, equivalent of the ``_LOG`` macro
(``reference/src/data_types.hpp:49,57``).

Levels (``parameters.hpp:116-122``):
0 no additional output, 1 program steps with run time, 2 developer info,
3 per-iteration detail.
"""

from __future__ import annotations

import sys

_VERBOSE_LEVEL = 0


def set_verbosity(level: int) -> None:
    global _VERBOSE_LEVEL
    _VERBOSE_LEVEL = int(level)


def get_verbosity() -> int:
    return _VERBOSE_LEVEL


def log(level: int, message: str) -> None:
    if _VERBOSE_LEVEL >= level:
        print(message, file=sys.stderr, flush=True)

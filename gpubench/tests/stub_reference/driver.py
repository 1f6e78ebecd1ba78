"""The frozen reference's ``driver``, re-exported, with the score of the
pair of records 0 and 1 of a family one higher."""

import dataclasses

from gpubench.reference import driver as _frozen
from gpubench.reference.driver import *  # noqa: F401,F403


def solve_pair(a, b, params, indices, **kwargs):
    result = _frozen.solve_pair(a, b, params, indices, **kwargs)
    if sorted(indices) == [0, 1]:
        result = dataclasses.replace(result, score=result.score + 1)
    return result

"""Crafted inputs of KI-tail (the iteration's last kernel,
``iteration_cuda.tail``, and its plain version ``device_solver.tail_plain``)
for the port's own scripts (``chip_smoke.py``) and tests: one carry that
holds every kind of lane the kernel treats apart.
"""

from __future__ import annotations

import numpy as np
import torch

#: ``max_nondecr`` for which :func:`tail_inputs` makes lanes halve
MAX_NONDECR = 5


def tail_inputs(b, d, slots, seed, dev, remaining=None):
    """A carry and this iteration's alignment, KI-lines' and K3's outputs
    for KI-tail alone (``device_solver._Carry``, ``gotoh.Traceback``,
    ``device_solver._Lines``, ``RoundsResult``), made from ``seed``: lanes
    active or not, ``count`` 0, 2 or more, ``nondecr`` about
    :data:`MAX_NONDECR` so that lanes halve, a fifth of the lanes whose
    bounds stay at +-INFINITY (``best_upper - best_lower`` wraps), upper
    bounds above every lower one (no lane ends on
    ``best_upper == best_lower``); ``remaining`` (default 1 to 3 at
    random) the iterations left on every lane."""
    from lara_tpu_torch.ops import gotoh
    from lara_tpu_torch.solver import device_solver
    from lara_tpu_torch.solver.matching_device import RoundsResult
    from lara_tpu_torch.types import INFINITY

    rng = np.random.default_rng(seed)
    inf = int(INFINITY)

    def ints(lo, hi, shape=(b,)):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(
            np.int32)).to(dev)

    def bools(p, shape=(b,)):
        return torch.from_numpy(rng.random(shape) < p).to(dev)

    wrap = bools(0.2)
    lower = ints(-9000, 0)
    carry = device_solver._init_carry(b, d, slots, np.float32(1.0), 500, dev)
    c = carry._replace(
        dual=ints(-60, 60, (b, d)),
        step_factor=torch.from_numpy(rng.uniform(0.01, 2.0, b).astype(
            np.float32)).to(dev),
        nondecr=ints(MAX_NONDECR - 2, MAX_NONDECR + 2),
        remaining=ints(1, 4) if remaining is None else torch.full(
            (b,), remaining, dtype=torch.int32, device=dev),
        lane_active=bools(0.8), best_score=ints(-9000, 9000),
        best_partner=ints(-1, 60, (b, slots)),
        best_nlines=ints(0, slots), best_matched=bools(0.5, (b, slots)),
        best_lower=torch.where(wrap, -inf, lower),
        best_upper=torch.where(wrap, inf, lower + ints(100_000, 200_000)),
        iterations=ints(0, 400))
    tb = gotoh.Traceback(
        upper=torch.where(wrap, inf, ints(100_000, 400_000)),
        partner=ints(-1, 60, (b, slots)), n_lines=ints(0, slots),
        gap_score=ints(-900, 0),
        seq_part=torch.where(wrap, -inf - 1_000_000, ints(-9000, 9000)),
        lines=gotoh.no_lines(b, dev))
    count = ints(1, 200) * 2
    count[::3] = 0
    ln = device_solver._Lines(
        slot_edge=torch.zeros((b, slots), dtype=torch.int32, device=dev),
        sg=ints(-1, 2, (b, d)), count=count,
        consistent_sum=ints(0, 900),
        matched_cons_slot=bools(0.5, (b, slots)),
        cand_q=torch.zeros((b, 1), dtype=torch.bool, device=dev))
    match = RoundsResult(score=ints(0, 900),
                         used_slot=bools(0.5, (b, slots)))
    return c, tb, ln, match


def lane_kinds(c, ln, nxt):
    """How many active lanes of the carry ``c`` (with KI-lines' ``ln``)
    halve, have ``count`` 0, have ``count`` > 1 and keep wrapping bounds
    in the next carry ``nxt``, and how many lanes are inactive."""
    from lara_tpu_torch.types import INFINITY

    act = c.lane_active
    inf = int(INFINITY)
    return {"inactive": int((~act).sum()),
            "halving": int((act & (nxt.step_factor != c.step_factor)).sum()),
            "count 0": int((act & (ln.count == 0)).sum()),
            "count > 1": int((act & (ln.count > 1)).sum()),
            "wrapping": int((act & (nxt.best_upper == inf)
                             & (nxt.best_lower == -inf)).sum())}

"""Hybrid solver: batched device DP + native host bookkeeping + work stealing.

Counterpart of :mod:`lara_tpu.solver.hybrid_driver`.  Each subgradient
iteration splits across the hardware the way the work is shaped:

* **device**: the batched Gotoh DP + traceback with the ordered line list
  (:func:`lara_tpu_torch.ops.gotoh_cuda.align_pssm_batch` with
  ``emit_lines=True``; K1 + K2 by default, the grid or resident kernels
  under ``LARA_DP_GRID`` / ``LARA_DP_RESIDENT``),
* **host (C++)**: per-pair sparse bookkeeping -- priority-queue maxima,
  subgradients, exact (blossom, ``-m 0``) or greedy matching, dual updates,
  incremental PSSM refresh -- in the port's native ``lagrange_host``
  library (:mod:`lara_tpu_torch.native.lagrange`), on a pool of threads,
* **work stealing**: a lane whose pair converges is refilled from the
  pending queue at once (``subgradient_solver.hpp:298-307``).

Per iteration one pinned host row per lane goes up (the sparse PSSM
updates, their count, la and lb) and one packed ``[lanes, 3 + 2 * lcap]``
int32 array comes down (upper, gap, n_lines, lines).  The device keeps the
lanes' PSSM planes in one flat buffer of ``lanes * LA * LB + 1`` int32 whose
last slot absorbs the unused update slots.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from lara_tpu_torch.native.lagrange import PairSolver
from lara_tpu_torch.ops import gotoh_cuda
from lara_tpu_torch.params import Parameters
from lara_tpu_torch.solver import device_driver
from lara_tpu_torch.solver.reference_driver import PairResult
from lara_tpu_torch.types import PSSM_INIT
from lara_tpu_torch.utils import log, timing

I32 = torch.int32

#: per-lane sparse PSSM update capacity per iteration; a lane that overflows
#: it re-uploads its whole plane
UPD_CAP = 512

#: batched iterations (device step + host step) run since the last reset
turns = 0


def solve_all(store, pairs: Sequence[Tuple[int, int]], params: Parameters,
              device: torch.device, max_lanes: int = 512
              ) -> Iterator[PairResult]:
    """Solve all pairs, bucket by bucket, each bucket on up to
    ``max_lanes`` lanes with refill."""
    for (la_max, lb_max), bucket_pairs in device_driver.buckets_of(store,
                                                                   pairs):
        lanes = max(1, min(max_lanes, device_driver.CELL_BUDGET
                           // (la_max * lb_max)))
        yield from _solve_bucket(store, bucket_pairs, params, la_max, lb_max,
                                 lanes, device)


class _DeviceStep:
    """The device side of one bucket: the flat PSSM buffer, the per-lane
    update rows and the DP."""

    def __init__(self, pssm_host: np.ndarray, params: Parameters,
                 device: torch.device):
        lanes, la_max, lb_max = pssm_host.shape
        self.shape = (lanes, la_max, lb_max)
        self.ne = la_max * lb_max
        self.lcap = min(la_max, lb_max)
        self.go = int(params.gap_open_int)
        self.ge = int(params.gap_extend_int)
        self.plan = gotoh_cuda.plan_for(la_max, lb_max, device)
        self.pssm = torch.from_numpy(np.concatenate(
            [pssm_host.reshape(-1), np.zeros(1, np.int32)])).to(device)
        # host row per lane: UPD_CAP indices, UPD_CAP values, count, la, lb;
        # pinned on the card, and rewritten only after the download's sync
        self.host_in = torch.zeros((lanes, 2 * UPD_CAP + 3), dtype=I32,
                                   pin_memory=device.type == "cuda")
        rows = self.host_in.numpy()
        #: the native steps write a lane's sparse updates here
        self.upd_idx = rows[:, :UPD_CAP]
        self.upd_val = rows[:, UPD_CAP:2 * UPD_CAP]
        self.upd_n = rows[:, 2 * UPD_CAP]
        self._lens = rows[:, 2 * UPD_CAP + 1:]
        self.seq0 = torch.zeros(self.shape, dtype=I32, device=device)
        self.lane_off = (torch.arange(lanes, dtype=I32, device=device)
                         * self.ne)[:, None]
        self.slot = torch.arange(UPD_CAP, dtype=I32, device=device)[None, :]

    def set_plane(self, lane: int, plane: np.ndarray) -> None:
        """Full-plane upload of one lane (after an update overflow)."""
        self.pssm[lane * self.ne:(lane + 1) * self.ne].copy_(
            torch.from_numpy(plane.reshape(-1)))

    def run(self, las: np.ndarray, lbs: np.ndarray) -> np.ndarray:
        """Apply the sparse updates, run the DP with lines on lanes of
        lengths (las, lbs), download (upper, gap, n_lines, lines) as one
        [lanes, 3 + 2 * lcap] array."""
        lanes = self.shape[0]
        self._lens[:, 0] = las
        self._lens[:, 1] = lbs
        rows = self.host_in.to(self.pssm.device, non_blocking=True)
        uidx = rows[:, :UPD_CAP]
        uval = rows[:, UPD_CAP:2 * UPD_CAP]
        count = rows[:, 2 * UPD_CAP]
        valid = self.slot < count[:, None]
        flat = torch.where(valid, uidx + self.lane_off, lanes * self.ne)
        self.pssm.index_put_((flat.reshape(-1).long(),),
                             torch.where(valid, uval, 0).reshape(-1))
        tb = gotoh_cuda.align_pssm_batch(
            self.pssm[:lanes * self.ne].view(self.shape),
            rows[:, -2].contiguous(), rows[:, -1].contiguous(), self.go,
            self.ge, self.shape[1], self.shape[2], self.seq0,
            emit_lines=True, plan=self.plan)
        packed = torch.cat([tb.upper[:, None], tb.gap_score[:, None],
                            tb.n_lines[:, None],
                            tb.lines.reshape(lanes, 2 * self.lcap)], dim=1)
        return packed.cpu().numpy()


def _solve_bucket(store, bucket_pairs, params: Parameters, la_max: int,
                  lb_max: int, lanes: int, device: torch.device
                  ) -> Iterator[PairResult]:
    global turns
    lanes = min(lanes, len(bucket_pairs))
    log(2, f"     hybrid bucket: {len(bucket_pairs)} pairs, {lanes} lanes, "
           f"{la_max}x{lb_max}")
    lcap = min(la_max, lb_max)

    # model prefetch: build in chunks so lane refills rarely wait on the host
    pending = list(bucket_pairs)
    model_cache: List = []

    def refill_cache():
        nonlocal pending
        if not model_cache and pending:
            chunk = pending[:max(lanes, 64)]
            pending = pending[len(chunk):]
            models, _ = device_driver._filter_and_build(
                store, chunk, params, la_max, lb_max, device)
            model_cache.extend(zip(chunk, models))

    pssm_host = np.full((lanes, la_max, lb_max), int(PSSM_INIT), np.int32)
    needs_full = np.zeros(lanes, bool)
    slots: List = [None] * lanes  # (pair, PairSolver) or None
    lane_active = np.zeros(lanes, bool)
    las = np.ones(lanes, np.int32)
    lbs = np.ones(lanes, np.int32)

    def fill_lane(k: int) -> None:
        refill_cache()
        if not model_cache:
            return
        pair, model = model_cache.pop(0)
        pssm_host[k] = int(PSSM_INIT)
        slots[k] = (pair, PairSolver(model, params, pssm_host[k]))
        las[k], lbs[k] = model.la, model.lb
        lane_active[k] = True
        needs_full[k] = True

    for k in range(lanes):
        fill_lane(k)
    step = _DeviceStep(pssm_host, params, device)
    needs_full[:] = False  # the initial upload covered the planes
    upd_n = step.upd_n

    # -j caps the host worker pool (0 = autodetect), as in the reference's
    # thread-count resolution (parameters.hpp:124-129)
    threads = int(params.threads) or (os.cpu_count() or 1)
    pool = ThreadPoolExecutor(max_workers=max(1, min(threads, 16, lanes)))
    try:
        while lane_active.any():
            with timing.phase("hybrid device step"):
                for k in np.nonzero(needs_full)[0]:
                    step.set_plane(int(k), pssm_host[k])
                    needs_full[k] = False
                out = step.run(las, lbs)
            turns += 1
            upper = out[:, 0]
            gap = out[:, 1]
            n_lines = out[:, 2]
            lines = out[:, 3:].reshape(lanes, lcap, 2)
            upd_n[:] = 0

            def do_step(k: int) -> int:
                _pair, solver = slots[k]
                status, count = solver.step_sparse(
                    lines[k, : n_lines[k]], int(gap[k]), int(upper[k]),
                    step.upd_idx[k], step.upd_val[k])
                if count < 0:
                    needs_full[k] = True
                    upd_n[k] = 0
                else:
                    upd_n[k] = count
                return status

            active_idx = [k for k in range(lanes) if lane_active[k]]
            with timing.phase("hybrid host step"):
                statuses = list(pool.map(do_step, active_idx))
            for k, status in zip(active_idx, statuses):
                if status != 1:
                    continue
                (ia, ib), solver = slots[k]
                columns, best_lower, best_upper, iters = solver.result(params)
                solver.close()
                slots[k] = None
                lane_active[k] = False
                las[k] = lbs[k] = 1
                upd_n[k] = 0
                if ia > ib:
                    columns = [(y, x, w) for (x, y, w) in columns]
                yield PairResult(
                    seq_indices=(min(ia, ib), max(ia, ib)),
                    columns=columns,
                    score=best_lower,
                    iterations=iters,
                    best_upper=best_upper,
                    best_lower=best_lower,
                )
                fill_lane(k)  # work stealing: refill at once
    finally:
        pool.shutdown(wait=False)
        for slot in slots:
            if slot is not None:
                slot[1].close()

"""K3 on the card: the greedy lookahead matching rounds loop.

:func:`rounds_loop_cuda` launches the kernel of ``csrc/matching.cu`` for
CUDA tensors or raises; it has the contract of
:func:`lara_tpu_torch.solver.matching_device.rounds_loop`, its plain version.
The kernel runs one warp per lane; :func:`plan` sizes its ring of staged
columns and its set of kept endpoints from the queue's width.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lara_tpu_torch import _build
from lara_tpu_torch.solver.matching_device import RoundsResult

I32 = torch.int32

#: the ring of staged columns per lane: a power of two in this range, the
#: whole row where it fits (``kRingMin``, ``kRingMax`` in the kernel)
RING_MIN, RING_MAX = 128, 2048
#: the kept-endpoint set: a power of two of at least four entries per
#: column and ``TABLE_MIN``, in shared memory up to ``SMEM_TABLE_MAX``
#: entries (a queue of up to 4096 columns) and in a global scratch beyond
TABLE_MIN, SMEM_TABLE_MAX = 64, 16384


class KernelPlan(NamedTuple):
    ring: int             # columns staged per lane
    table: int            # entries of the kept-endpoint set per lane
    table_in_smem: bool   # else a [B, table] int32 scratch on the card


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def plan(width: int) -> KernelPlan:
    """The kernel's ring and set sizes for a queue of ``width`` columns.
    At most ``width`` columns are kept, two endpoints each, so the set is at
    most half full: every probe ends, most at the first entry."""
    ring = min(max(_pow2_at_least(width), RING_MIN), RING_MAX)
    table = max(_pow2_at_least(4 * width), TABLE_MIN)
    return KernelPlan(ring, table, table <= SMEM_TABLE_MAX)


def rounds_loop_cuda(lq, mq, wq, live, line_edges,
                     lookahead: int) -> RoundsResult:
    """``lq/mq/wq`` [B, W] int32 queue-ordered columns (any ids), ``live``
    [B, W] bool, ``line_edges`` [B, S] int32 edge id per line slot (a value
    no column holds for invalid slots).  Returns (score [B], used_slot [B,
    S]).  An empty batch launches nothing."""
    if not lq.is_cuda:
        raise ValueError("rounds_loop_cuda needs CUDA tensors")
    b, width = lq.shape
    slots = line_edges.shape[1]
    dev = lq.device
    for name, t in (("lq", lq), ("mq", mq), ("wq", wq)):
        _build.require(t, name, I32, (b, width), dev)
    _build.require(live, "live", torch.bool, (b, width), dev)
    _build.require(line_edges, "line_edges", I32, (b, slots), dev)
    lh = max(1, min(int(lookahead), 8))
    score = torch.empty((b,), dtype=I32, device=dev)
    used = torch.empty((b, slots), dtype=torch.bool, device=dev)
    if b == 0:
        return RoundsResult(score=score, used_slot=used)
    kp = plan(width)
    table = None if kp.table_in_smem else torch.empty(
        (b, kp.table), dtype=I32, device=dev)
    rc = _build.library().lara_matching_rounds(
        lq.data_ptr(), mq.data_ptr(), wq.data_ptr(), live.data_ptr(),
        line_edges.data_ptr(), b, width, slots, lh, kp.ring, kp.table,
        None if table is None else table.data_ptr(), score.data_ptr(),
        used.data_ptr(), _build.stream_of(lq))
    _build.check(rc, "matching_rounds")
    _build.count("matching_rounds")
    return RoundsResult(score=score, used_slot=used)

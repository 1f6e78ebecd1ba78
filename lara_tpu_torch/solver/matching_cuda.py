"""K3 on the card: the greedy lookahead matching rounds loop.

:func:`rounds_loop_cuda` launches the kernel of ``csrc/matching.cu`` for
CUDA tensors or raises; it has the contract of
:func:`lara_tpu_torch.solver.matching_device.rounds_loop`, its plain version.
"""

from __future__ import annotations

import torch

from lara_tpu_torch import _build
from lara_tpu_torch.solver.matching_device import RoundsResult

I32 = torch.int32


def rounds_loop_cuda(lq, mq, wq, live, line_edges,
                     lookahead: int) -> RoundsResult:
    """``lq/mq/wq`` [B, W] int32 queue-ordered columns, ``live`` [B, W]
    bool, ``line_edges`` [B, S] int32 flat edge id per line slot (a value no
    column holds for invalid slots).  Returns (score [B], used_slot [B, S])."""
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
    blocked = torch.empty((b, width), dtype=torch.uint8, device=dev)
    rc = _build.library().lara_matching_rounds(
        lq.data_ptr(), mq.data_ptr(), wq.data_ptr(), live.data_ptr(),
        line_edges.data_ptr(), b, width, slots, lh, blocked.data_ptr(),
        score.data_ptr(), used.data_ptr(), _build.stream_of(lq))
    _build.check(rc, "matching_rounds")
    _build.count("matching_rounds")
    return RoundsResult(score=score, used_slot=used)

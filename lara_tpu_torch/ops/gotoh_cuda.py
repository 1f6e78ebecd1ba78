"""K1 (forward wavefront) and K2 (traceback) on the card.

``align_pssm_batch`` is the port's per-iteration alignment: the
``emit_lines=False`` contract of
``lara_tpu.ops.gotoh_pallas.align_pssm_batch_pallas`` (the dense partner
map, upper bound, line count, gap score and the seq-score sum over the
matched cells).  A CUDA tensor launches the kernels of ``csrc/gotoh_dp.cu``
or raises; a CPU tensor takes the plain versions of
:mod:`lara_tpu_torch.ops.gotoh`.

Preconditions the kernels trust (the driver guarantees them):
``1 <= la <= la_max`` and ``1 <= lb <= lb_max`` in every lane.
"""

from __future__ import annotations

import torch

from lara_tpu_torch import _build
from lara_tpu_torch.ops import gotoh
from lara_tpu_torch.ops.gotoh import Traceback

I32 = torch.int32


def dp_forward(pssm: torch.Tensor, la: torch.Tensor, lb: torch.Tensor,
               go: int, ge: int):
    """(dirs [B, D, W] int8, finals [3, B] int32) for a [B, LA, LB] int32
    score grid; K1 on the card."""
    if not pssm.is_cuda:
        return gotoh.dp_forward(pssm, la, lb, go, ge)
    b, la_max, lb_max = pssm.shape
    dev = pssm.device
    _build.require(pssm, "pssm", I32, (b, la_max, lb_max), dev)
    _build.require(la, "la", I32, (b,), dev)
    _build.require(lb, "lb", I32, (b,), dev)
    dirs = torch.empty((b, la_max + lb_max + 1, la_max + 1),
                       dtype=torch.int8, device=dev)
    finals = torch.empty((3, b), dtype=I32, device=dev)
    rc = _build.library().lara_gotoh_dp(
        pssm.data_ptr(), la.data_ptr(), lb.data_ptr(), b, la_max, lb_max,
        int(go), int(ge), dirs.data_ptr(), finals.data_ptr(),
        _build.stream_of(pssm))
    _build.check(rc, "gotoh_dp")
    _build.launches["gotoh_dp"] += 1
    return dirs, finals


def dp_traceback(dirs: torch.Tensor, finals: torch.Tensor, la: torch.Tensor,
                 lb: torch.Tensor, go: int, ge: int,
                 seq_score: torch.Tensor) -> Traceback:
    """Traceback from (la, lb) over K1's codes; K2 on the card.
    ``seq_score`` is [B, LA, LB] int32."""
    if not dirs.is_cuda:
        return gotoh.dp_traceback(dirs, finals, la, lb, go, ge, seq_score)
    b, num_diag, width = dirs.shape
    la_max = width - 1
    lb_max = num_diag - width
    dev = dirs.device
    _build.require(dirs, "dirs", torch.int8, (b, num_diag, width), dev)
    _build.require(finals, "finals", I32, (3, b), dev)
    _build.require(la, "la", I32, (b,), dev)
    _build.require(lb, "lb", I32, (b,), dev)
    _build.require(seq_score, "seq_score", I32, (b, la_max, lb_max), dev)
    partner = torch.empty((b, la_max), dtype=I32, device=dev)
    scalars = torch.empty((4, b), dtype=I32, device=dev)
    rc = _build.library().lara_gotoh_tb(
        dirs.data_ptr(), finals.data_ptr(), la.data_ptr(), lb.data_ptr(),
        seq_score.data_ptr(), b, la_max, lb_max, int(go), int(ge),
        partner.data_ptr(), scalars.data_ptr(), _build.stream_of(dirs))
    _build.check(rc, "gotoh_tb")
    _build.launches["gotoh_tb"] += 1
    return Traceback(upper=scalars[0], partner=partner, n_lines=scalars[2],
                     gap_score=scalars[1], seq_part=scalars[3])


def align_pssm_batch(pssm: torch.Tensor, la: torch.Tensor, lb: torch.Tensor,
                     go: int, ge: int, la_max: int, lb_max: int,
                     seq_score: torch.Tensor) -> Traceback:
    """Batched per-iteration ``globalAlignment``
    (``subgradient_solver.hpp:223-225``) plus line and gap extraction:
    K1 then K2 on the card, their plain versions on the CPU."""
    if not pssm.is_cuda:
        return gotoh.align_pssm_batch(pssm, la, lb, go, ge, la_max, lb_max,
                                      seq_score)
    if tuple(pssm.shape[1:]) != (la_max, lb_max):
        raise ValueError(f"pssm is {tuple(pssm.shape)}, expected "
                         f"[B, {la_max}, {lb_max}]")
    dirs, finals = dp_forward(pssm, la, lb, go, ge)
    return dp_traceback(dirs, finals, la, lb, go, ge,
                        seq_score.reshape(pssm.shape))

"""The wavefront DP and traceback kernels on the card, and their dispatch.

``align_pssm_batch`` is the port's per-iteration alignment, the contract of
``lara_tpu.ops.gotoh_pallas.align_pssm_batch_pallas``: the dense partner
map, upper bound, line count, gap score and the seq-score sum over the
matched cells, plus the ordered line list with ``emit_lines=True``.  A plan
(:mod:`lara_tpu_torch.ops.gotoh_plan`) picks the kernels:

* default: K1 (:func:`dp_forward`) + K2 (:func:`dp_traceback`),
  ``csrc/gotoh_dp.cu``;
* ``LARA_DP_GRID=1``: K1-grid (:func:`dp_forward_grid`, also behind
  :func:`gotoh_scan`) + K2-grid (:func:`dp_traceback_grid`),
  ``csrc/gotoh_grid.cu``;
* ``LARA_DP_RESIDENT=1``: K-res (:func:`align_resident`),
  ``csrc/gotoh_resident.cu``.

Every wrapper launches its kernel for CUDA tensors, or raises; for CPU
tensors it runs the plain version from :mod:`lara_tpu_torch.ops.gotoh`.

Preconditions the kernels trust (``device_driver`` and ``hybrid_driver``
guarantee them):
``1 <= la <= la_max`` and ``1 <= lb <= lb_max`` in every lane.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from lara_tpu.types import PSSM_INIT
from lara_tpu_torch import _build
from lara_tpu_torch.ops import gotoh, gotoh_plan
from lara_tpu_torch.ops.gotoh import Traceback

I32 = torch.int32


def _require_lanes(la, lb, b, dev) -> None:
    _build.require(la, "la", I32, (b,), dev)
    _build.require(lb, "lb", I32, (b,), dev)


def dp_forward(pssm: torch.Tensor, la: torch.Tensor, lb: torch.Tensor,
               go: int, ge: int):
    """(dirs [B, D, W] int8, finals [3, B] int32) for a [B, LA, LB] int32
    score grid; K1 on the card."""
    if not pssm.is_cuda:
        return gotoh.dp_forward(pssm, la, lb, go, ge)
    b, la_max, lb_max = pssm.shape
    dev = pssm.device
    _build.require(pssm, "pssm", I32, (b, la_max, lb_max), dev)
    _require_lanes(la, lb, b, dev)
    dirs = torch.empty((b, la_max + lb_max + 1, la_max + 1),
                       dtype=torch.int8, device=dev)
    finals = torch.empty((3, b), dtype=I32, device=dev)
    rc = _build.library().lara_gotoh_dp(
        pssm.data_ptr(), la.data_ptr(), lb.data_ptr(), b, la_max, lb_max,
        int(go), int(ge), dirs.data_ptr(), finals.data_ptr(),
        _build.stream_of(pssm))
    _build.check(rc, "gotoh_dp")
    _build.count("gotoh_dp")
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
    _require_lanes(la, lb, b, dev)
    _build.require(seq_score, "seq_score", I32, (b, la_max, lb_max), dev)
    partner = torch.empty((b, la_max), dtype=I32, device=dev)
    scalars = torch.empty((4, b), dtype=I32, device=dev)
    rc = _build.library().lara_gotoh_tb(
        dirs.data_ptr(), finals.data_ptr(), la.data_ptr(), lb.data_ptr(),
        seq_score.data_ptr(), b, la_max, lb_max, int(go), int(ge),
        partner.data_ptr(), scalars.data_ptr(), _build.stream_of(dirs))
    _build.check(rc, "gotoh_tb")
    _build.count("gotoh_tb")
    return _traceback_of(partner, scalars)


def _traceback_of(partner: torch.Tensor, scalars: torch.Tensor) -> Traceback:
    """A Traceback from a kernel's partner [B, LA] and scalars [4, B]
    (upper, gap, n_lines, seq)."""
    return Traceback(upper=scalars[0], partner=partner, n_lines=scalars[2],
                     gap_score=scalars[1], seq_part=scalars[3],
                     lines=gotoh.no_lines(partner.shape[0], partner.device))


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def dp_forward_grid(skewed: torch.Tensor, la: torch.Tensor, lb: torch.Tensor,
                    go: int, ge: int, dchunk: int):
    """(dirs [Dp, B, W] int8, finals [3, B] int32) over pre-skewed scores
    [D, B, W] int32, Dp = D rounded up to ``dchunk`` (rows beyond D are
    padding): K1-grid on the card, one launch per ``dchunk`` diagonals."""
    num_diag, b, width = skewed.shape
    num_rows = _round_up(num_diag, dchunk)
    if not skewed.is_cuda:
        res = gotoh.gotoh_scan(skewed, la, lb, go, ge, width - 1,
                               emit="dirs")
        dirs = torch.zeros((num_rows, b, width), dtype=torch.int8)
        dirs[:num_diag] = res.aux.to(torch.int8)
        return dirs, torch.stack([res.final_m, res.final_h, res.final_v])
    dev = skewed.device
    _build.require(skewed, "skewed", I32, (num_diag, b, width), dev)
    _require_lanes(la, lb, b, dev)
    state = torch.empty((b, 9 * width), dtype=I32, device=dev)
    dirs = torch.empty((num_rows, b, width), dtype=torch.int8, device=dev)
    finals = torch.empty((3, b), dtype=I32, device=dev)
    lib, stream = _build.library(), _build.stream_of(skewed)
    for d0 in range(0, num_rows, dchunk):
        rc = lib.lara_gotoh_grid_dp(
            skewed.data_ptr(), la.data_ptr(), lb.data_ptr(), b, width, d0,
            dchunk, int(go), int(ge), state.data_ptr(), dirs.data_ptr(),
            finals.data_ptr(), stream)
        _build.check(rc, "gotoh_grid_dp")
        _build.count("gotoh_grid_dp")
    return dirs, finals


def gotoh_scan(skewed: torch.Tensor, la: torch.Tensor, lb: torch.Tensor,
               go: int, ge: int, dchunk: int = gotoh_plan.DEFAULT_DCHUNK
               ) -> gotoh.DPResult:
    """Counterpart of ``lara_tpu.ops.gotoh_pallas.gotoh_scan_pallas``:
    (final_m, final_h, final_v [B], dirs [Dp, B, W] int8) for pre-skewed
    scores [D, B, W]; K1-grid on the card."""
    dirs, finals = dp_forward_grid(skewed, la, lb, go, ge, dchunk)
    return gotoh.DPResult(finals[0], finals[1], finals[2], dirs)


def dp_traceback_grid(dirs: torch.Tensor, finals: torch.Tensor,
                      la: torch.Tensor, lb: torch.Tensor, go: int, ge: int,
                      seq_score: torch.Tensor, dchunk: int) -> Traceback:
    """Traceback over K1-grid's dirs [Dp, B, W]; K2-grid on the card, one
    launch per ``dchunk`` diagonals from the last block to the first.
    ``seq_score`` is [B, LA, LB] int32."""
    num_rows, b, width = dirs.shape
    la_max = width - 1
    lb_max = seq_score.shape[2]
    if not dirs.is_cuda:
        by_lane = dirs[:la_max + lb_max + 1].permute(1, 0, 2).contiguous()
        return gotoh.dp_traceback(by_lane, finals, la, lb, go, ge, seq_score)
    dev = dirs.device
    if num_rows % dchunk or num_rows < la_max + lb_max + 1:
        raise ValueError(f"dirs has {num_rows} rows, not the {la_max} x "
                         f"{lb_max} diagonals rounded up to {dchunk}")
    _build.require(dirs, "dirs", torch.int8, (num_rows, b, width), dev)
    _build.require(finals, "finals", I32, (3, b), dev)
    _require_lanes(la, lb, b, dev)
    _build.require(seq_score, "seq_score", I32, (b, la_max, lb_max), dev)
    walker = torch.empty((6, b), dtype=I32, device=dev)
    partner = torch.empty((b, la_max), dtype=I32, device=dev)
    scalars = torch.empty((4, b), dtype=I32, device=dev)
    lib, stream = _build.library(), _build.stream_of(dirs)
    for d_lo in range(num_rows - dchunk, -1, -dchunk):
        rc = lib.lara_gotoh_grid_tb(
            dirs.data_ptr(), finals.data_ptr(), la.data_ptr(), lb.data_ptr(),
            seq_score.data_ptr(), b, la_max, lb_max, d_lo,
            int(d_lo == num_rows - dchunk), int(go), int(ge),
            walker.data_ptr(), partner.data_ptr(), scalars.data_ptr(),
            stream)
        _build.check(rc, "gotoh_grid_tb")
        _build.count("gotoh_grid_tb")
    return _traceback_of(partner, scalars)


def align_resident(pssm: torch.Tensor, la: torch.Tensor, lb: torch.Tensor,
                   go: int, ge: int, seq_score: torch.Tensor) -> Traceback:
    """Forward sweep and traceback of a [B, LA, LB] int32 score grid in one
    CTA per pair, the codes in shared memory: K-res on the card.  The
    caller's plan has checked that the pair fits."""
    if not pssm.is_cuda:
        dirs, finals = gotoh.dp_forward(pssm, la, lb, go, ge)
        return gotoh.dp_traceback(dirs, finals, la, lb, go, ge, seq_score)
    b, la_max, lb_max = pssm.shape
    dev = pssm.device
    _build.require(pssm, "pssm", I32, (b, la_max, lb_max), dev)
    _require_lanes(la, lb, b, dev)
    _build.require(seq_score, "seq_score", I32, (b, la_max, lb_max), dev)
    partner = torch.empty((b, la_max), dtype=I32, device=dev)
    scalars = torch.empty((4, b), dtype=I32, device=dev)
    rc = _build.library().lara_gotoh_resident(
        pssm.data_ptr(), la.data_ptr(), lb.data_ptr(), seq_score.data_ptr(),
        b, la_max, lb_max, int(go), int(ge), partner.data_ptr(),
        scalars.data_ptr(), _build.stream_of(pssm))
    _build.check(rc, "gotoh_resident")
    _build.count("gotoh_resident")
    return _traceback_of(partner, scalars)


@functools.lru_cache(maxsize=None)
def _card_smem_optin(index: int) -> int:
    value = ctypes.c_int(0)
    _build.check(_build.library().lara_smem_optin(index, ctypes.byref(value)),
                 "smem_optin")
    return value.value


def smem_optin(device: torch.device) -> int:
    """Opt-in shared memory per block of ``device``
    (``cudaDevAttrMaxSharedMemoryPerBlockOptin``); on the CPU the H100's,
    so that a CPU run takes the card's plan."""
    if device.type != "cuda":
        return gotoh_plan.H100_SMEM_OPTIN
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return _card_smem_optin(index)


def plan_for(la_max: int, lb_max: int, device: torch.device,
             dchunk: int = gotoh_plan.DEFAULT_DCHUNK) -> gotoh_plan.Plan:
    """The plan of a [B, la_max, lb_max] call on ``device``."""
    return gotoh_plan.choose(la_max, lb_max, smem_optin(device), dchunk)


def align_pssm_batch(pssm: torch.Tensor, la: torch.Tensor, lb: torch.Tensor,
                     go: int, ge: int, la_max: int, lb_max: int,
                     seq_score: torch.Tensor, emit_lines: bool = False,
                     plan: gotoh_plan.Plan = None) -> Traceback:
    """Batched per-iteration ``globalAlignment``
    (``subgradient_solver.hpp:223-225``) plus line and gap extraction, by
    ``plan`` (made here from the environment if not given).  With
    ``emit_lines`` the result carries the ordered line list."""
    if tuple(pssm.shape[1:]) != (la_max, lb_max):
        raise ValueError(f"pssm is {tuple(pssm.shape)}, expected "
                         f"[B, {la_max}, {lb_max}]")
    if plan is None:
        plan = plan_for(la_max, lb_max, pssm.device)
    seq_score = seq_score.reshape(pssm.shape)
    if plan.variant == gotoh_plan.GRID:
        skewed = gotoh.skew_scores(pssm, int(PSSM_INIT))
        dirs, finals = dp_forward_grid(skewed, la, lb, go, ge, plan.dchunk)
        tb = dp_traceback_grid(dirs, finals, la, lb, go, ge, seq_score,
                               plan.dchunk)
    elif plan.variant == gotoh_plan.RESIDENT:
        tb = align_resident(pssm, la, lb, go, ge, seq_score)
    else:
        dirs, finals = dp_forward(pssm, la, lb, go, ge)
        tb = dp_traceback(dirs, finals, la, lb, go, ge, seq_score)
    if emit_lines:
        tb = tb._replace(lines=gotoh.compact_lines(
            tb.partner, tb.n_lines, min(la_max, lb_max)))
    return tb

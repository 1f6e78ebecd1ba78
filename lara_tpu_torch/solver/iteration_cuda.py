"""KI-head, KI-lines and KI-tail on the card: the fused solver's iteration
body around the DP and K3.

Each wrapper launches its kernel of ``csrc/iteration.cu`` for CUDA tensors
and raises on what the kernel does not take; it has the contract of its
plain version in :mod:`lara_tpu_torch.solver.device_solver`
(:func:`~lara_tpu_torch.solver.device_solver.head_plain`,
:func:`~lara_tpu_torch.solver.device_solver.lines_plain`,
:func:`~lara_tpu_torch.solver.device_solver.tail_plain`), which
``device_solver._iteration`` runs for CPU tensors.  An output may be the
carry's own tensor (the dispatch graph's static carry, updated in place).
"""

from __future__ import annotations

import ctypes

import torch

from lara_tpu_torch import _build

I32 = torch.int32
BOOL = torch.bool

#: the carry fields KI-tail reads and writes, in ``_Carry``'s order less
#: ``dual_at_queue`` (KI-head's)
TAIL_CARRY = ("dual", "step_factor", "nondecr", "remaining", "lane_active",
              "best_lower", "best_upper", "best_score", "best_partner",
              "best_nlines", "best_matched", "iterations")


def _require_rows(tensors, dtype, shape, dev) -> None:
    for name, t in tensors:
        _build.require(t, name, dtype, shape, dev)


def _smem_check(name: str, nbytes: int, dev: torch.device) -> None:
    from lara_tpu_torch.ops import gotoh_cuda

    limit = gotoh_cuda.smem_optin(dev)
    if nbytes > limit:
        raise ValueError(f"{name} needs {nbytes} bytes of shared memory per "
                         f"lane, more than the card's {limit}")


def head(model, st, c, dual_at_queue=None):
    """KI-head: ``device_solver._Head`` of ``(model, st, c)``, writing the
    run-start cells of ``st.pssm``.  ``dual_at_queue``, where given, gets
    the new ``dual_at_queue`` (it may be ``c.dual_at_queue``)."""
    from lara_tpu_torch.solver.device_solver import _Head

    b, d = model.dual_l.shape
    ne = model.seq_score.shape[1]
    dev = model.dual_l.device
    _require_rows((("sscore", model.sscore), ("dual", c.dual),
                   ("dual_at_queue", c.dual_at_queue),
                   ("dual_l", model.dual_l)), I32, (b, d), dev)
    _build.require(model.dvalid, "dvalid", BOOL, (b, d), dev)
    _build.require(c.lane_active, "lane_active", BOOL, (b,), dev)
    _build.require(model.seq_score, "seq_score", I32, (b, ne), dev)
    _build.require(model.active, "active", BOOL, (b, ne), dev)
    if st.pssm.numel() != b * ne:
        raise ValueError(f"pssm has {tuple(st.pssm.shape)}, not {b} x {ne} "
                         "cells")
    _build.require(st.pssm, "pssm", I32, st.pssm.shape, dev)
    steps = len(st.same_masks)
    if not 0 < steps <= 30:
        raise ValueError(f"KI-head runs 1 to 30 doubling passes, not {steps}")
    _smem_check("KI-head", 16 * d, dev)
    if dual_at_queue is None:
        dual_at_queue = torch.empty((b, d), dtype=I32, device=dev)
    _build.require(dual_at_queue, "dual_at_queue out", I32, (b, d), dev)
    run_p = torch.empty((b, d), dtype=I32, device=dev)
    run_idx = torch.empty((b, d), dtype=I32, device=dev)
    is_top = torch.empty((b, d), dtype=BOOL, device=dev)
    if b:
        rc = _build.library().lara_iteration_head(
            model.sscore.data_ptr(), c.dual.data_ptr(),
            c.dual_at_queue.data_ptr(), model.dvalid.data_ptr(),
            model.dual_l.data_ptr(), c.lane_active.data_ptr(),
            model.seq_score.data_ptr(), model.active.data_ptr(), b, d, ne,
            steps, dual_at_queue.data_ptr(), run_p.data_ptr(),
            run_idx.data_ptr(), is_top.data_ptr(), st.pssm.data_ptr(),
            _build.stream_of(c.dual))
        _build.check(rc, "iteration_head")
        _build.count("iteration_head")
    return _Head(dual_at_queue, run_p, run_idx, is_top)


def lines(model, st, c, hd, partner, lb_max: int):
    """KI-lines: ``device_solver._Lines`` from the head ``hd`` and the
    alignment's ``partner`` [B, S]."""
    from lara_tpu_torch.solver.device_solver import _Lines

    b, d = model.dual_l.shape
    ne = model.seq_score.shape[1]
    slots = partner.shape[1]
    cw = st.lq.shape[1]
    dev = model.dual_l.device
    _require_rows((("dual_l", model.dual_l), ("dual_m", model.dual_m),
                   ("rev", model.rev), ("sscore", model.sscore),
                   ("dual", c.dual), ("run_p", hd.run_p),
                   ("run_idx", hd.run_idx)), I32, (b, d), dev)
    _build.require(model.dvalid, "dvalid", BOOL, (b, d), dev)
    _build.require(hd.is_top, "is_top", BOOL, (b, d), dev)
    _build.require(partner, "partner", I32, (b, slots), dev)
    _require_rows((("lq", st.lq), ("mq", st.mq)), I32, (b, cw), dev)
    _build.require(st.nc_base, "nc_base", I32, (b,), dev)
    _build.require(c.lane_active, "lane_active", BOOL, (b,), dev)
    _smem_check("KI-lines", 5 * slots + d, dev)
    slot_edge = torch.empty((b, slots), dtype=I32, device=dev)
    sg = torch.empty((b, d), dtype=I32, device=dev)
    count = torch.empty((b,), dtype=I32, device=dev)
    consistent_sum = torch.empty((b,), dtype=I32, device=dev)
    matched_cons_slot = torch.empty((b, slots), dtype=BOOL, device=dev)
    cand_q = torch.empty((b, cw), dtype=BOOL, device=dev)
    if b:
        rc = _build.library().lara_iteration_lines(
            partner.data_ptr(), model.dual_l.data_ptr(),
            model.dual_m.data_ptr(), model.rev.data_ptr(),
            model.dvalid.data_ptr(), model.sscore.data_ptr(),
            c.dual.data_ptr(), hd.run_p.data_ptr(), hd.run_idx.data_ptr(),
            hd.is_top.data_ptr(), st.lq.data_ptr(), st.mq.data_ptr(),
            st.nc_base.data_ptr(), c.lane_active.data_ptr(), b, d, slots, cw,
            int(lb_max), ne, slot_edge.data_ptr(), sg.data_ptr(),
            count.data_ptr(), consistent_sum.data_ptr(),
            matched_cons_slot.data_ptr(), cand_q.data_ptr(),
            _build.stream_of(c.dual))
        _build.check(rc, "iteration_lines")
        _build.count("iteration_lines")
    return _Lines(slot_edge, sg, count, consistent_sum, matched_cons_slot,
                  cand_q)


def tail(c, dual_at_queue, tb, ln, match_res, max_nondecr: int, out=None):
    """KI-tail: the next ``device_solver._Carry`` from the carry ``c``, the
    new ``dual_at_queue`` (KI-head's), the alignment ``tb``, KI-lines'
    ``ln`` and K3's ``match_res``; into ``out`` where given (it may be
    ``c``), else into new tensors."""
    from lara_tpu_torch.solver.device_solver import _Carry

    b, d = c.dual.shape
    slots = c.best_partner.shape[1]
    dev = c.dual.device
    shapes = {"dual": (b, d), "best_partner": (b, slots),
              "best_matched": (b, slots)}
    dtypes = {"step_factor": torch.float32, "lane_active": BOOL,
              "best_matched": BOOL}
    carry = c._asdict()
    if out is None:
        new = {f: torch.empty_like(carry[f]) for f in TAIL_CARRY}
    else:
        new = {f: getattr(out, f) for f in TAIL_CARRY}
    for f in TAIL_CARRY:
        for t, which in ((carry[f], f), (new[f], f"{f} out")):
            _build.require(t, which, dtypes.get(f, I32), shapes.get(f, (b,)),
                           dev)
    inputs = (("upper", tb.upper, I32, (b,)),
              ("gap_score", tb.gap_score, I32, (b,)),
              ("n_lines", tb.n_lines, I32, (b,)),
              ("seq_part", tb.seq_part, I32, (b,)),
              ("partner", tb.partner, I32, (b, slots)),
              ("match score", match_res.score, I32, (b,)),
              ("used_slot", match_res.used_slot, BOOL, (b, slots)),
              ("sg", ln.sg, I32, (b, d)), ("count", ln.count, I32, (b,)),
              ("consistent_sum", ln.consistent_sum, I32, (b,)),
              ("matched_cons_slot", ln.matched_cons_slot, BOOL, (b, slots)))
    for name, t, dtype, shape in inputs:
        _build.require(t, name, dtype, shape, dev)
    _build.require(dual_at_queue, "dual_at_queue", I32, (b, d), dev)
    ptrs = [carry[f].data_ptr() for f in TAIL_CARRY] \
        + [t.data_ptr() for _, t, _, _ in inputs] \
        + [new[f].data_ptr() for f in TAIL_CARRY]
    if b:
        array = (ctypes.c_void_p * len(ptrs))(*ptrs)
        rc = _build.library().lara_iteration_tail(
            array, len(ptrs), b, d, slots, int(max_nondecr),
            _build.stream_of(c.dual))
        _build.check(rc, "iteration_tail")
        _build.count("iteration_tail")
    return _Carry(dual_at_queue=dual_at_queue, **new)

"""The batched subgradient solver in PyTorch.

Counterpart of :mod:`lara_tpu.solver.device_solver`: one batch of pairwise
Lagrangian problems iterates PSSM assembly, the wavefront DP and traceback
(K1 + K2), subgradient extraction, greedy matching (K3), bound bookkeeping
and the dual update, with converged lanes frozen under masks
(``/root/reference/src/subgradient_solver.hpp:206-331``).

The dual table is edge-major (sorted by (l, m), one contiguous run per
alignment edge, partner ids ascending within a run).  Where the JAX body
works around the TPU's memory system, this port takes the GPU form:

* the PSSM grid, where(active, seq_score, PSSM_INIT), is built once per
  model (``_prepare``), and each iteration writes max(run top, 0) into its
  run-start cells alone (the JAX ``e_cap == 0`` semantics); the sort plus
  int8-limb matmul placement and the scatter-max branch are TPU forms and
  are not ported,
* line membership of an entry is a gather, ``partner[l // LB] == l % LB``,
  in place of the [B, D, S] compare-reduce (equal everywhere: slot a's line
  edge is a * LB + partner[a], and partner < LB),
* ``pick[rev]`` is a gather in place of the key sort,
* the consistent-branch slot marks are two scatters in place of the
  [B, D, S] compare.

The run-top tie-break (``_run_top``) and the float32 dual update keep the
reference's operation order.

On the card an iteration (:func:`_iteration`) is six kernels: KI-head, the
DP (K1 + K2, or the plan's), KI-lines, K3 and KI-tail; the three of the
body are ``csrc/iteration.cu``
(:mod:`lara_tpu_torch.solver.iteration_cuda`), and on the CPU their plain
versions run, :func:`head_plain`, :func:`lines_plain` and
:func:`tail_plain`, the body's sections as the JAX body has them.  One
iteration holds no host synchronisation.  A dispatch is one launch of a CUDA
graph that loops over a captured iteration while iterations are left and
a lane is active (:mod:`lara_tpu_torch.solver.dispatch_graph`): the
counterpart of the JAX package's one jitted ``while_loop``, with the same
trip count, and the results of the eager loop, bit for bit.  On the CPU a dispatch is the eager
loop (:func:`_eager_dispatch`), which stops as soon as no lane is active,
since the read is free there.  :func:`solve_batch` reads each dispatch's
any-lane-active flag one dispatch late, as the JAX package does: the next
dispatch is queued before the flag comes to the host.  ``LARA_CHUNK`` sets
the iterations per dispatch (:func:`dispatch_size`).
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Tuple

import torch

from lara_tpu_torch.types import INFINITY, PSSM_INIT
from lara_tpu_torch.ops import gotoh_cuda, gotoh_plan
from lara_tpu_torch.solver import iteration_cuda
from lara_tpu_torch.solver.matching_device import greedy_matching_queue
from lara_tpu_torch.utils import timing

I32 = torch.int32
F32 = torch.float32
NEG_INF = -int(INFINITY)
#: iterations per dispatch: the any-lane-active flag is read between them
DISPATCH = 125


def dispatch_size() -> int:
    """Iterations per dispatch: ``DISPATCH``, or ``LARA_CHUNK`` where set
    (the JAX solver's knob; there a value <= 0 never ends the loop, here it
    raises ``ValueError``)."""
    override = os.environ.get("LARA_CHUNK")
    if not override:
        return DISPATCH
    value = int(override)
    if value <= 0:
        raise ValueError(
            f"LARA_CHUNK must be a positive int, got {override!r}")
    return value


class BatchModel(NamedTuple):
    """Static per-batch problem data (padded), on one device.

    Invariant: every row of ``rev`` is an involution of [0, D) (identity on
    padded entries)."""

    seq_score: torch.Tensor  # [B, NE] int32 (flat la*lb grid padded to LA*LB)
    active: torch.Tensor     # [B, NE] bool
    dual_l: torch.Tensor     # [B, D] int32
    dual_m: torch.Tensor     # [B, D] int32
    sscore: torch.Tensor     # [B, D] int32
    rev: torch.Tensor        # [B, D] int32
    dvalid: torch.Tensor     # [B, D] bool
    qrank: torch.Tensor      # [B, D] int32
    la: torch.Tensor         # [B] int32
    lb: torch.Tensor         # [B] int32


class BatchResult(NamedTuple):
    best_upper: torch.Tensor     # [B] int32
    best_lower: torch.Tensor     # [B] int32
    best_partner: torch.Tensor   # [B, LA_MAX] int32: partner[a] = b or -1
    best_nlines: torch.Tensor    # [B] int32
    best_matched: torch.Tensor   # [B, LA_MAX] bool (per position slot)
    dual_at_queue: torch.Tensor  # [B, D] int32
    iterations: torch.Tensor     # [B] int32


class _Carry(NamedTuple):
    dual: torch.Tensor
    dual_at_queue: torch.Tensor
    step_factor: torch.Tensor
    nondecr: torch.Tensor
    remaining: torch.Tensor
    lane_active: torch.Tensor
    best_lower: torch.Tensor
    best_upper: torch.Tensor
    best_score: torch.Tensor
    best_partner: torch.Tensor
    best_nlines: torch.Tensor
    best_matched: torch.Tensor
    iterations: torch.Tensor


def _init_carry(b: int, d: int, la_max: int, step_factor0,
                num_iterations: int, device: torch.device) -> _Carry:
    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    return _Carry(
        dual=full((b, d), 0, I32),
        dual_at_queue=full((b, d), 0, I32),
        step_factor=full((b,), float(step_factor0), F32),
        nondecr=full((b,), 0, I32),
        remaining=full((b,), num_iterations, I32),
        lane_active=full((b,), True, torch.bool),
        best_lower=full((b,), NEG_INF, I32),
        best_upper=full((b,), -NEG_INF, I32),
        best_score=full((b,), NEG_INF, I32),
        best_partner=full((b, la_max), -1, I32),
        best_nlines=full((b,), 0, I32),
        best_matched=full((b, la_max), False, torch.bool),
        iterations=full((b,), 0, I32),
    )


def _result_of(final: _Carry) -> BatchResult:
    return BatchResult(
        best_upper=final.best_upper,
        best_lower=final.best_lower,
        best_partner=final.best_partner,
        best_nlines=final.best_nlines,
        best_matched=final.best_matched,
        dual_at_queue=final.dual_at_queue,
        iterations=final.iterations,
    )


def _shift_right(x: torch.Tensor, s: int, fill) -> torch.Tensor:
    return torch.cat([torch.full_like(x[:, :s], fill), x[:, :-s]], dim=1)


def _shift_left(x: torch.Tensor, s: int, fill) -> torch.Tensor:
    return torch.cat([x[:, s:], torch.full_like(x[:, :s], fill)], dim=1)


def _same_segment_masks(seg: torch.Tensor, steps: int):
    """For each doubling shift 2^k, whether the neighbour 2^k to the
    left/right lies in the same edge run (loop-invariant)."""
    masks = []
    s = 1
    for _ in range(steps):
        masks.append((_shift_right(seg, s, -1) == seg,
                      _shift_left(seg, s, -1) == seg))
        s *= 2
    return masks


def _packed_mask(same_masks) -> torch.Tensor:
    """``same_masks`` as one int64 per entry: bit 2k is the left neighbour
    2^k away in the same run, bit 2k + 1 the right one (KI-head's mask;
    at most 30 shifts, so 60 bits)."""
    r0 = same_masks[0][0]
    packed = torch.zeros(r0.shape, dtype=torch.int64, device=r0.device)
    for k, (same_r, same_l) in enumerate(same_masks):
        packed |= (same_r.long() << (2 * k)) | (same_l.long() << (2 * k + 1))
    return packed


def _run_top(p, idx, same_masks, p_fill, idx_fill):
    """Segmented doubling scan with the queue-top monoid: max profit, ties
    to the smallest entry index (== smallest partner id within a run), the
    reference's per-edge priority-queue top (``lagrange.hpp:121,305-309``).
    Returns (run max p, index of the top entry) at every position."""

    def combine(p1, i1, p2, i2):
        take1 = (p1 > p2) | ((p1 == p2) & (i1 <= i2))
        return torch.where(take1, p1, p2), torch.where(take1, i1, i2)

    fp, fi = p, idx
    bp_, bi = p, idx
    s = 1
    for (same_r, same_l) in same_masks:
        fp, fi = combine(
            fp, fi,
            torch.where(same_r, _shift_right(fp, s, p_fill), p_fill),
            torch.where(same_r, _shift_right(fi, s, idx_fill), idx_fill))
        bp_, bi = combine(
            bp_, bi,
            torch.where(same_l, _shift_left(bp_, s, p_fill), p_fill),
            torch.where(same_l, _shift_left(bi, s, idx_fill), idx_fill))
        s *= 2
    return combine(fp, fi, bp_, bi)


def solve_batch(model: BatchModel, go, ge, step_factor0, la_max: int,
                lb_max: int, num_iterations: int, max_nondecr: int,
                lookahead: int, scan_steps: int = 0) -> BatchResult:
    """Solve in dispatches of :func:`dispatch_size` iterations; the carry
    stays on the device between dispatches.  Each dispatch's
    any-lane-active flag is read after the next one is queued
    (``lara_tpu/solver/device_solver.py:284-297``): the solve ends one
    dispatch after the one in which the last lane finished, and that
    dispatch runs no iteration.  The host's wait on a flag is the phase
    "dispatch flag wait (host)"."""
    dispatch = dispatch_size()
    b = model.seq_score.shape[0]
    d = model.dual_l.shape[1]
    carry = _init_carry(b, d, la_max, step_factor0, num_iterations,
                        model.seq_score.device)
    total = 0
    pending = None  # the flag of the dispatch before, on its way
    while total < num_iterations:
        steps = min(dispatch, num_iterations - total)
        carry = solve_batch_chunk(model, carry, go, ge, la_max, lb_max,
                                  steps, max_nondecr, lookahead, scan_steps)
        total += steps
        if pending is not None:
            with timing.phase("dispatch flag wait (host)"):
                alive = pending.read()
            if not alive:
                break
        pending = _Flag(carry.lane_active) if total < num_iterations \
            else None
    return _result_of(carry)


class _Flag:
    """``lane_active.any()`` on its way to the host: on the card, a copy
    into pinned memory behind an event on the current stream, waited for
    only by :meth:`read`."""

    def __init__(self, lane_active: torch.Tensor):
        self._any = lane_active.any()
        self._done = None
        if lane_active.is_cuda:
            host = torch.empty((), dtype=torch.bool, pin_memory=True)
            host.copy_(self._any, non_blocking=True)
            self._any = host
            self._done = torch.cuda.Event()
            self._done.record(torch.cuda.current_stream(lane_active.device))

    def read(self) -> bool:
        if self._done is not None:
            self._done.synchronize()
        return bool(self._any)


class _Static(NamedTuple):
    """Loop-invariant data of one dispatch."""

    same_masks: List[Tuple[torch.Tensor, torch.Tensor]]
    seg_mask: torch.Tensor   # [B, D] int64: same_masks packed
    iota_d: torch.Tensor     # [B, D]
    start_dst: torch.Tensor  # [B, D] run-start cell, NE elsewhere
    lq: torch.Tensor         # [B, CW] queue-ordered l < m candidates
    mq: torch.Tensor
    wq: torch.Tensor
    nc_base: torch.Tensor    # [B] candidate count
    iota_cw: torch.Tensor    # [1, CW]
    slot_base: torch.Tensor  # [1, S]
    plan: gotoh_plan.Plan    # the DP kernels (LARA_DP_GRID/RESIDENT)
    # [B, LA, LB] the PSSM grid: where(active, seq_score, PSSM_INIT) once,
    # its run-start cells rewritten by every iteration's KI-head
    pssm: torch.Tensor


def _prepare(model: BatchModel, la_max: int, lb_max: int,
             scan_steps: int) -> _Static:
    b, ne = model.seq_score.shape
    d = model.dual_l.shape[1]
    dev = model.dual_l.device
    full_depth = max(1, (d - 1).bit_length())
    steps = full_depth if scan_steps <= 0 else min(scan_steps, full_depth)
    iota_d = torch.arange(d, device=dev, dtype=I32).expand(b, d)
    prev_l = torch.cat([torch.full_like(model.dual_l[:, :1], -1),
                        model.dual_l[:, :-1]], dim=1)
    is_start = model.dvalid & (model.dual_l != prev_l)
    start_dst = torch.where(is_start, model.dual_l, ne).long()
    # matching queue, statically ordered once per dispatch (the queue key
    # never involves duals, matching.hpp:149-151): order by qrank, then
    # compact the l < m half (each undirected interaction enters the queue
    # once); keys are unique in both sorts
    order = torch.argsort(model.qrank, dim=1)
    lq_s = model.dual_l.gather(1, order)
    mq_s = model.dual_m.gather(1, order)
    wq_s = (2 * model.sscore).gather(1, order)
    cand = (model.dvalid & (model.dual_l < model.dual_m)).gather(1, order)
    ckey = torch.where(cand, iota_d, d + iota_d)
    corder = torch.argsort(ckey, dim=1)
    cw = max(1, d // 2)
    corder = corder[:, :cw]
    same_masks = _same_segment_masks(model.dual_l, steps)
    return _Static(
        same_masks=same_masks,
        seg_mask=_packed_mask(same_masks),
        iota_d=iota_d,
        start_dst=start_dst,
        lq=lq_s.gather(1, corder).contiguous(),
        mq=mq_s.gather(1, corder).contiguous(),
        wq=wq_s.gather(1, corder).contiguous(),
        nc_base=cand.sum(1, dtype=I32),
        iota_cw=torch.arange(cw, device=dev, dtype=I32)[None, :],
        slot_base=(torch.arange(la_max, device=dev, dtype=I32)
                   * lb_max)[None, :],
        plan=gotoh_cuda.plan_for(la_max, lb_max, dev,
                                 gotoh_plan.fused_dchunk(la_max, lb_max)),
        pssm=torch.where(model.active, model.seq_score,
                         int(PSSM_INIT)).reshape(b, la_max, lb_max),
    )


def _in_lines(edge: torch.Tensor, partner: torch.Tensor,
              lb_max: int) -> torch.Tensor:
    """Whether each flat edge id (a * LB + b) is a line of the current
    alignment: ``partner[a] == b``."""
    return partner.gather(1, (edge // lb_max).long()) == edge % lb_max


def _section(name: str):
    """A ``torch.profiler`` range over one section of the iteration body
    (``lara.<name>``): sections in ``LARA_PROFILE`` traces, and
    ``chip_smoke.py``'s device time by section.  Host code only: a graph's
    replays run none of it."""
    return torch.profiler.record_function(f"lara.{name}")


class _Head(NamedTuple):
    """What KI-head hands on: the carry's new ``dual_at_queue`` and the
    per-edge queue top of every entry."""

    dual_at_queue: torch.Tensor  # [B, D] int32
    run_p: torch.Tensor          # [B, D] int32 top profit of the run
    run_idx: torch.Tensor        # [B, D] int32 index of the top entry
    is_top: torch.Tensor         # [B, D] bool


class _Lines(NamedTuple):
    """What KI-lines hands on to K3 and KI-tail."""

    slot_edge: torch.Tensor          # [B, S] int32 line edge id, NE if none
    sg: torch.Tensor                 # [B, D] int32 subgradient
    count: torch.Tensor              # [B] int32 subgradient norm
    consistent_sum: torch.Tensor     # [B] int32
    matched_cons_slot: torch.Tensor  # [B, S] bool
    cand_q: torch.Tensor             # [B, CW] bool K3's live columns


def head_plain(model: BatchModel, st: _Static, c: _Carry) -> _Head:
    """KI-head's plain version (JAX body ``:452-506``): the queue top of
    every edge's run and the PSSM.  Writes the run-start cells of
    ``st.pssm``; every other cell keeps its loop-invariant value."""
    b, ne = model.seq_score.shape
    act = c.lane_active
    with _section("run_top"):
        dual_at_queue = torch.where(act[:, None], c.dual, c.dual_at_queue)

        # ---- per-edge queue top: capped segmented doubling scan ----
        profits = model.sscore + c.dual
        masked = torch.where(model.dvalid, profits, NEG_INF)
        d = model.dual_l.shape[1]
        run_p, run_idx = _run_top(masked, st.iota_d, st.same_masks, NEG_INF,
                                  d)
        is_top = model.dvalid & (profits == run_p)

    with _section("pssm"):
        # ---- PSSM grid: max(run max, 0) of each edge at its cell (run
        # starts carry the full-run aggregate); every other cell is
        # where(active, seq_score, PSSM_INIT), as ``_prepare`` left it ----
        lane, entry = torch.nonzero((st.start_dst >= 0) & (st.start_dst < ne),
                                    as_tuple=True)
        cell = st.start_dst[lane, entry]
        grid = st.pssm.view(b, ne)
        grid[lane, cell] = torch.where(
            model.active[lane, cell],
            model.seq_score[lane, cell] + torch.clamp(run_p[lane, entry],
                                                      min=0),
            int(PSSM_INIT))
    return _Head(dual_at_queue, run_p, run_idx, is_top)


def lines_plain(model: BatchModel, st: _Static, c: _Carry, head: _Head,
                partner: torch.Tensor, lb_max: int) -> _Lines:
    """KI-lines' plain version (JAX body ``:514-582``): line membership,
    subgradients, the consistent branch and K3's candidate mask, from the
    alignment's ``partner`` [B, S]."""
    ne = model.seq_score.shape[1]
    la_max = partner.shape[1]
    act = c.lane_active
    with _section("membership"):
        slot_valid = partner >= 0
        slot_edge = torch.where(slot_valid, st.slot_base + partner, ne)

        # ---- line membership per entry (gathers) ----
        l_in = _in_lines(model.dual_l, partner, lb_max)
        m_in = _in_lines(model.dual_m, partner, lb_max)
        l_in_q = _in_lines(st.lq, partner, lb_max)
        m_in_q = _in_lines(st.mq, partner, lb_max)

        # ---- subgradients (lagrange.hpp:343-374): cycle(i) = pick(rev(i))
        pick = l_in & (head.run_p >= 0) & head.is_top
        pick_rev = pick.gather(1, model.rev.long())
        sg_pos = pick & ~pick_rev
        sg = sg_pos.to(I32) - (pick_rev & ~pick).to(I32)
        count = 2 * sg_pos.sum(1, dtype=I32)
        any_sg = count > 0

    with _section("consistent"):
        # ---- consistent branch (lagrange.hpp:397-409): entry-level, at the
        # unique top entry of each run ----
        profits = model.sscore + c.dual
        is_top_exact = model.dvalid & (st.iota_d == head.run_idx)
        tis_entry = (profits < 0) | ((profits == 0)
                                     & (model.dual_l < model.dual_m))
        contrib = is_top_exact & l_in & ~tis_entry
        consistent_sum = torch.where(contrib, model.sscore, 0).sum(
            1, dtype=I32)
        # a line slot is matched in the consistent case iff its own top
        # contributes, or some contributing line chose it as partner
        marks = torch.zeros((partner.shape[0], la_max + 1), dtype=I32,
                            device=partner.device)
        marks.scatter_(1, torch.where(contrib, model.dual_l // lb_max,
                                      la_max).long(), 1)
        marks.scatter_(1, torch.where(contrib & m_in, model.dual_m // lb_max,
                                      la_max).long(), 1)
        matched_cons_slot = slot_valid & (marks[:, :la_max] != 0)
        # ---- the matching branch's candidates (lagrange.hpp:380-395) ----
        cand_q = (st.iota_cw < st.nc_base[:, None]) & l_in_q & m_in_q \
            & any_sg[:, None] & act[:, None]
    return _Lines(slot_edge, sg, count, consistent_sum, matched_cons_slot,
                  cand_q)


def tail_plain(c: _Carry, dual_at_queue: torch.Tensor, tb, lines: _Lines,
               match_res, max_nondecr: int) -> _Carry:
    """KI-tail's plain version (JAX body ``:583-628``): the lower bound,
    best-primal tracking, the bound bookkeeping and the dual update, from
    the alignment ``tb`` and K3's ``match_res``; returns the next carry."""
    act = c.lane_active
    with _section("bookkeeping"):
        any_sg = lines.count > 0
        struct_part = torch.where(any_sg, match_res.score,
                                  lines.consistent_sum)

        lower = tb.seq_part + struct_part + tb.gap_score

        # ---- best primal tracking (lagrange.hpp:416-421) ----
        better = act & (lower > c.best_score)
        slot_matched = torch.where(any_sg[:, None], match_res.used_slot,
                                   lines.matched_cons_slot) & (tb.partner >= 0)
        best_score = torch.where(better, lower, c.best_score)
        best_partner = torch.where(better[:, None], tb.partner,
                                   c.best_partner)
        best_nlines = torch.where(better, tb.n_lines, c.best_nlines)
        best_matched = torch.where(better[:, None], slot_matched,
                                   c.best_matched)

        # ---- bound bookkeeping (subgradient_solver.hpp:247-263) ----
        improved_u = act & (tb.upper < c.best_upper)
        improved_l = act & (lower > c.best_lower)
        best_upper = torch.where(improved_u, tb.upper, c.best_upper)
        best_lower = torch.where(improved_l, lower, c.best_lower)
        nondecr = torch.where(improved_u | improved_l, 0, c.nondecr)
        halve = act & (nondecr >= max_nondecr)
        step_factor = torch.where(halve, c.step_factor / 2.0, c.step_factor)
        nondecr = torch.where(act, torch.where(halve, 0, nondecr + 1),
                              c.nondecr).to(I32)

        # ---- dual update (subgradient_solver.hpp:265-271): float32, in the
        # reference's operation order, truncated toward zero ----
        step = step_factor * (best_upper - best_lower).to(F32) \
            / torch.clamp(lines.count, min=1).to(F32)
        upd = act[:, None] & (lines.sg != 0)
        new_dual = (c.dual.to(F32)
                    - step[:, None] * lines.sg.to(F32)).to(I32)
        dual = torch.where(upd, new_dual, c.dual)

        remaining = torch.where(act, c.remaining - 1, c.remaining)
        done_now = act & ((best_upper == best_lower) | (remaining == 0))
        return _Carry(
            dual=dual,
            dual_at_queue=dual_at_queue,
            step_factor=step_factor,
            nondecr=nondecr,
            remaining=remaining,
            lane_active=act & ~done_now,
            best_lower=best_lower,
            best_upper=best_upper,
            best_score=best_score,
            best_partner=best_partner,
            best_nlines=best_nlines,
            best_matched=best_matched,
            iterations=c.iterations + act.to(I32),
        )


def _iteration(model: BatchModel, st: _Static, c: _Carry, go: int, ge: int,
               la_max: int, lb_max: int, max_nondecr: int, lookahead: int,
               out: _Carry = None) -> _Carry:
    """One iteration of the JAX ``while_loop``'s body
    (``lara_tpu/solver/device_solver.py:447-628``): KI-head, the DP (K1 +
    K2 by default, else the plan's kernels), KI-lines, K3 and KI-tail, on
    the card the kernels of ``csrc/iteration.cu``, on the CPU their plain
    versions.  Returns the next carry: ``out`` where given (it may be
    ``c`` itself: each kernel reads an element of the carry before it
    writes it, and nothing after KI-tail reads the old carry), else new
    tensors."""
    with _section("head"):
        if c.dual.is_cuda:
            head = iteration_cuda.head(
                model, st, c, None if out is None else out.dual_at_queue)
        else:
            head = head_plain(model, st, c)

    with _section("dp"):
        # ---- relaxed problem: wavefront DP + traceback (K1 + K2 by
        # default, else the plan's variant) over the PSSM KI-head wrote ----
        tb = gotoh_cuda.align_pssm_batch(st.pssm, model.la, model.lb, go, ge,
                                         la_max, lb_max, model.seq_score,
                                         plan=st.plan)
    with _section("lines"):
        if c.dual.is_cuda:
            lines = iteration_cuda.lines(model, st, c, head, tb.partner,
                                         lb_max)
        else:
            lines = lines_plain(model, st, c, head, tb.partner, lb_max)

    with _section("k3"):
        # ---- matching branch (lagrange.hpp:380-395): K3 ----
        match_res = greedy_matching_queue(st.lq, st.mq, st.wq, lines.cand_q,
                                          lines.slot_edge, lookahead)
    with _section("tail"):
        if c.dual.is_cuda:
            return iteration_cuda.tail(c, head.dual_at_queue, tb, lines,
                                       match_res, max_nondecr, out)
        new = tail_plain(c, head.dual_at_queue, tb, lines, match_res,
                         max_nondecr)
    if out is None:
        return new
    with _section("copies"):
        for dst, src in zip(out, new):
            if dst is not src:
                dst.copy_(src)
    return out


def solve_batch_chunk(model: BatchModel, carry: _Carry, go, ge, la_max: int,
                      lb_max: int, max_steps: int, max_nondecr: int,
                      lookahead: int, scan_steps: int = 0) -> _Carry:
    """Up to ``max_steps`` iterations; resumable.  On the card, one launch
    of the dispatch's CUDA graph (:mod:`~lara_tpu_torch.solver.
    dispatch_graph`); on the CPU, :func:`_eager_dispatch`.

    ``scan_steps``: doubling passes of the per-edge run scan; 2**scan_steps
    must cover the longest per-edge run (0 = full depth, always safe).
    """
    from lara_tpu_torch.solver import dispatch_graph

    if dispatch_graph.Graph.applies(carry.lane_active.device):
        key = dispatch_graph.key_of(model, go, ge, la_max, lb_max,
                                    max_nondecr, lookahead, scan_steps)
        return dispatch_graph.run(model, carry, key, max_steps)
    return _eager_dispatch(model, carry, go, ge, la_max, lb_max, max_steps,
                           max_nondecr, lookahead, scan_steps)


def _eager_dispatch(model: BatchModel, carry: _Carry, go, ge, la_max: int,
                    lb_max: int, max_steps: int, max_nondecr: int,
                    lookahead: int, scan_steps: int = 0) -> _Carry:
    """:func:`solve_batch_chunk` as a loop of eager iterations: the CPU's
    dispatch, and on the card the reference that the graph is held to."""
    go, ge = int(go), int(ge)
    st = _prepare(model, la_max, lb_max, scan_steps)
    sync_free = carry.lane_active.is_cuda
    for _ in range(max_steps):
        if not sync_free and not bool(carry.lane_active.any()):
            break
        carry = _iteration(model, st, carry, go, ge, la_max, lb_max,
                           max_nondecr, lookahead)
    return carry

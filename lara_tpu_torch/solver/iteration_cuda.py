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

KI-head and KI-lines spread a lane over several CTAs, so that the grid
fills the card: KI-head in tiles of a lane's dual entries with a halo on
each side (:func:`head_grid`), KI-lines as a thread-block cluster per long
lane (:func:`lines_grid`).  KI-tail takes four entries and four slots a
thread, 16 bytes a load where the rows allow it (:func:`tail_grid`).  The
choosers are pure functions of the shapes (and the card's SM count), and
own the grid: the kernels' entry points take it as given and only check
that it covers the lane.

Inside the dispatch graph's loop KI-tail also sets the loop's condition
(``csrc/loop_exit.cu``, ``dispatch_graph.CudaGraph.capture``); a launch
through :func:`tail` never does.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from lara_tpu_torch import _build

I32 = torch.int32
BOOL = torch.bool

#: the carry fields KI-tail reads and writes, in ``_Carry``'s order less
#: ``dual_at_queue`` (KI-head's)
TAIL_CARRY = ("dual", "step_factor", "nondecr", "remaining", "lane_active",
              "best_lower", "best_upper", "best_score", "best_partner",
              "best_nlines", "best_matched", "iterations")


class HeadGrid(NamedTuple):
    """KI-head's launch: ``tiles`` CTAs per lane, each owning ``tile``
    entries and reading ``halo`` more on each side (clipped to the lane),
    at most ``span`` entries in all."""

    tile: int
    halo: int
    tiles: int
    span: int
    ctas: int


def head_grid(b: int, d: int, steps: int, sms: int,
              tile: int = 0) -> HeadGrid:
    """KI-head's tiles for ``b`` lanes of ``d`` entries and ``steps``
    doubling passes on ``sms`` SMs: as many tiles per lane as give every SM
    two CTAs, none narrower than twice its halo 2**steps - 1; one CTA per
    lane where the halo is that large.  ``tile`` > 0 fixes the tile instead
    (any tile is exact)."""
    halo = 2 ** steps - 1
    if tile <= 0:
        per_lane = max(1, min(2 * sms // max(1, b), d // max(1, 2 * halo)))
        tile = -(-d // per_lane)
    tile = min(tile, d)
    tiles = -(-d // tile)
    return HeadGrid(tile, halo, tiles, min(d, tile + 2 * halo), b * tiles)


class LinesGrid(NamedTuple):
    """KI-lines' launch: a cluster of ``cluster`` CTAs per lane; rank r owns
    ``dper`` dual entries, ``sper`` line slots and ``qper`` queue columns
    from r times each."""

    cluster: int
    dper: int
    sper: int
    qper: int
    ctas: int


#: the largest portable thread-block cluster
MAX_CLUSTER = 8
#: the most entries of a lane that KI-lines runs on one CTA, and the
#: entries of each CTA of a cluster (a thread an entry)
LINES_ONE_CTA = 1024
LINES_PER_CTA = 512


def lines_split(d: int, slots: int, cw: int, cluster: int):
    """(entries, slots, queue columns) per CTA of a cluster of
    ``cluster``."""
    return -(-d // cluster), -(-slots // cluster), -(-cw // cluster)


def lines_grid(b: int, d: int, slots: int, cw: int, sms: int,
               cluster: int = 0) -> LinesGrid:
    """KI-lines' clusters for ``b`` lanes of ``d`` entries on ``sms`` SMs:
    one CTA per lane up to :data:`LINES_ONE_CTA` entries (a cluster's
    launch and barriers cost more than they save there), else a cluster of
    :data:`LINES_PER_CTA` entries a CTA, at most :data:`MAX_CLUSTER` CTAs
    and two CTAs an SM.  ``cluster`` > 0 fixes it instead."""
    if cluster <= 0:
        cluster = 1 if d <= LINES_ONE_CTA else min(
            MAX_CLUSTER, -(-d // LINES_PER_CTA), max(1, 2 * sms // max(1, b)))
    if not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"KI-lines runs clusters of 1 to {MAX_CLUSTER} "
                         f"CTAs, not {cluster}")
    return LinesGrid(cluster, *lines_split(d, slots, cw, cluster),
                     b * cluster)


class TailGrid(NamedTuple):
    """KI-tail's launch: one CTA per lane of ``threads`` threads, four
    dual entries and four line slots a thread, the block striding over a
    longer lane; ``vec``: 16-byte loads."""

    threads: int
    vec: bool
    ctas: int


#: the most threads of a KI-tail CTA
TAIL_MAX_THREADS = 1024


def tail_grid(b: int, d: int, slots: int, aligned: bool = True) -> TailGrid:
    """KI-tail's CTAs for ``b`` lanes of ``d`` entries and ``slots`` line
    slots: one CTA a lane at every shape (2-8 CTAs a lane lost to it on
    the card at every bench chunk: ``PERF.md``), a thread for each four
    entries or slots of the longer row, in whole warps up to
    :data:`TAIL_MAX_THREADS`.  16-byte loads where ``d`` and ``slots`` are
    multiples of 4 and the rows are ``aligned`` (16 bytes)."""
    vec = bool(aligned) and d % 4 == 0 and slots % 4 == 0
    quads = max(1, -(-d // 4), -(-slots // 4))
    threads = min(TAIL_MAX_THREADS, 32 * -(-quads // 32))
    return TailGrid(threads, vec, b)


def sm_count(dev: torch.device) -> int:
    """The card's streaming multiprocessors."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _require_rows(tensors, dtype, shape, dev) -> None:
    for name, t in tensors:
        _build.require(t, name, dtype, shape, dev)


def _smem_check(name: str, nbytes: int, dev: torch.device) -> None:
    from lara_tpu_torch.ops import gotoh_cuda

    limit = gotoh_cuda.smem_optin(dev)
    if nbytes > limit:
        raise ValueError(f"{name} needs {nbytes} bytes of shared memory per "
                         f"lane, more than the card's {limit}")


def head(model, st, c, dual_at_queue=None, tile: int = 0):
    """KI-head: ``device_solver._Head`` of ``(model, st, c)``, writing the
    run-start cells of ``st.pssm``.  ``dual_at_queue``, where given, gets
    the new ``dual_at_queue`` (it may be ``c.dual_at_queue``); ``tile``
    fixes the tile (:func:`head_grid`)."""
    from lara_tpu_torch.solver.device_solver import _Head

    b, d = model.dual_l.shape
    ne = model.seq_score.shape[1]
    dev = model.dual_l.device
    _require_rows((("sscore", model.sscore), ("dual", c.dual),
                   ("dual_at_queue", c.dual_at_queue),
                   ("dual_l", model.dual_l)), I32, (b, d), dev)
    _build.require(model.dvalid, "dvalid", BOOL, (b, d), dev)
    _build.require(st.seg_mask, "seg_mask", torch.int64, (b, d), dev)
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
    grid = head_grid(b, d, steps, sm_count(dev), tile)
    # two buffers of keys (four where they fit: csrc/iteration.cu)
    _smem_check("KI-head", 16 * grid.span, dev)
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
            model.dual_l.data_ptr(), st.seg_mask.data_ptr(),
            c.lane_active.data_ptr(), model.seq_score.data_ptr(),
            model.active.data_ptr(), b, d, ne, steps, grid.tile,
            grid.tiles, grid.span, dual_at_queue.data_ptr(),
            run_p.data_ptr(), run_idx.data_ptr(), is_top.data_ptr(),
            st.pssm.data_ptr(),
            _build.stream_of(c.dual))
        _build.check(rc, "iteration_head")
        _build.count("iteration_head")
    return _Head(dual_at_queue, run_p, run_idx, is_top)


def lines(model, st, c, hd, partner, lb_max: int, cluster: int = 0):
    """KI-lines: ``device_solver._Lines`` from the head ``hd`` and the
    alignment's ``partner`` [B, S].  ``cluster`` fixes the CTAs per lane
    (:func:`lines_grid`)."""
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
    grid = lines_grid(b, d, slots, cw, sm_count(dev), cluster)
    _smem_check("KI-lines", 5 * slots + grid.qper, dev)
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
            int(lb_max), ne, grid.cluster, grid.dper, grid.sper, grid.qper,
            slot_edge.data_ptr(), sg.data_ptr(), count.data_ptr(),
            consistent_sum.data_ptr(), matched_cons_slot.data_ptr(),
            cand_q.data_ptr(),
            _build.stream_of(c.dual))
        _build.check(rc, "iteration_lines")
        _build.count("iteration_lines")
    return _Lines(slot_edge, sg, count, consistent_sum, matched_cons_slot,
                  cand_q)


def tail(c, dual_at_queue, tb, ln, match_res, max_nondecr: int, out=None):
    """KI-tail: the next ``device_solver._Carry`` from the carry ``c``, the
    new ``dual_at_queue`` (KI-head's), the alignment ``tb``, KI-lines'
    ``ln`` and K3's ``match_res``; into ``out`` where given (it may be
    ``c``), else into new tensors, on :func:`tail_grid`'s CTAs."""
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
    grid = tail_grid(b, d, slots, all(p % 16 == 0 for p in ptrs))
    if b:
        array = (ctypes.c_void_p * len(ptrs))(*ptrs)
        rc = _build.library().lara_iteration_tail(
            array, len(ptrs), b, d, slots, int(max_nondecr), grid.threads,
            int(grid.vec), _build.stream_of(c.dual))
        _build.check(rc, "iteration_tail")
        _build.count("iteration_tail")
    return _Carry(dual_at_queue=dual_at_queue, **new)

"""The wavefront DP and traceback kernels on the card, and their dispatch.

``align_pssm_batch`` is the port's per-iteration alignment, the contract of
``lara_tpu.ops.gotoh_pallas.align_pssm_batch_pallas``: the dense partner
map, upper bound, line count, gap score and the seq-score sum over the
matched cells, plus the ordered line list with ``emit_lines=True``.  A plan
(:mod:`lara_tpu_torch.ops.gotoh_plan`) picks the kernels:

* default: K1 (:func:`dp_forward`) + K2 (:func:`dp_traceback`),
  ``csrc/gotoh_dp.cu``;
* ``LARA_DP_GRID=1``: K1-grid (:func:`dp_forward_grid`, also behind
  :func:`gotoh_scan`) + K2-grid (:func:`dp_traceback_grid`), K1's and K2's
  kernels over the grid variant's layouts, ``csrc/gotoh_dp.cu``;
* ``LARA_DP_RESIDENT=1``: K-res (:func:`align_resident`), K1's sweep and
  K2's walk in one launch with the codes in shared memory,
  ``csrc/gotoh_dp.cu``.

Once per chunk, before any iteration, the edge filter
(:func:`edge_filter_skewed_words`) runs K4: its sweep (:func:`edge_sweep`,
K1's kernel in a prefix mode, ``csrc/gotoh_dp.cu``) and its pack
(:func:`edge_pack`, ``csrc/edge_filter.cu``).

Every wrapper launches its kernel for CUDA tensors, or raises; for CPU
tensors it runs the plain version from :mod:`lara_tpu_torch.ops.gotoh`.

Preconditions the kernels trust (``device_driver`` and ``hybrid_driver``
guarantee them):
``1 <= la <= la_max`` and ``1 <= lb <= lb_max`` in every lane, and K4's
residues in 0..4 (``encode_rna5``, padded with 4).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from lara_tpu_torch.types import PSSM_INIT
from lara_tpu_torch import _build
from lara_tpu_torch.ops import gotoh, gotoh_plan
from lara_tpu_torch.ops.gotoh import Traceback

I32 = torch.int32


def _require_lanes(la, lb, b, dev) -> None:
    _build.require(la, "la", I32, (b,), dev)
    _build.require(lb, "lb", I32, (b,), dev)


def border_codes(go: int, ge: int, width: int) -> np.ndarray:
    """The M and H direction codes (``mdir | hdir << 2``) of the left
    border cells (i, 0), i < ``width``, as the plain sweep computes them.
    They come from the cells left of column 0, which hold values that
    depend only on their diagonal (NEG_INF rows before diagonal 0, no
    score): G(d) = (max(G(d-2)) + NEG_INF, the H and V recurrences of
    G(d-1)), all in wrapped int32.  Cell (i, 0) takes mdir from G(i-2) and
    hdir from G(i-1)."""
    def wrap(x):
        return (x + 2**31) % 2**32 - 2**31

    neg = gotoh.NEG_INF
    g2 = g1 = (neg, neg, neg)
    codes = np.empty(width, np.int8)
    for i in range(width):
        best = max(g2)
        mdir = gotoh.MAT if g2[0] == best else (
            gotoh.HOR if g2[1] == best else gotoh.VER)
        m1, h1, v1 = g1
        hh, hm, hv = wrap(h1 + ge), wrap(m1 + go), wrap(v1 + go)
        h_new = max(hh, hm, hv)
        hdir = gotoh.HOR if hh == h_new else (
            gotoh.MAT if hm == h_new else gotoh.VER)
        codes[i] = mdir | (hdir << 2)
        v_new = max(wrap(v1 + ge), wrap(m1 + go), wrap(h1 + go))
        g2, g1 = g1, (wrap(best + neg), h_new, v_new)
    return codes


@functools.lru_cache(maxsize=16)
def _border_on(go: int, ge: int, width: int, device: torch.device):
    return torch.from_numpy(border_codes(go, ge, width)).to(device)


#: K2's constants: the window's diagonals and bytes per diagonal (the 16-byte
#: blocks that hold 64 offsets), and the steps walked per window
K2_WIN_ROWS = 128
K2_WIN_BYTES = 80
K2_SEG = 32


def ring_safe(la_max: int, lb_max: int, cluster: int) -> bool:
    """Whether K1's strip schedule always finishes at this shape on
    ``cluster`` CTAs per pair, each of min(16, strips / cluster) warps
    (:func:`lara_tpu_torch.ops.gotoh_plan.schedule_safe`).  The launcher
    refuses what this refuses (``lara_gotoh_dp``)."""
    strips = (la_max + 32) // 32
    return gotoh_plan.schedule_safe(
        la_max, lb_max, cluster * min(gotoh_plan.K1_MAX_WARPS, -(-strips // cluster)))


def cluster_size(b: int, la_max: int, lb_max: int,
                 device: torch.device) -> int:
    """K1's CTAs per pair: as many as fill the card's SMs, at most 4 (B=32
    on 132 SMs: 4; B=128: 1), and more, up to 8, where fewer would let the
    strip schedule stall (:func:`ring_safe`)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    cluster = max(1, min(4, sms // max(1, b)))
    while not ring_safe(la_max, lb_max, cluster):
        if cluster == 8:
            raise ValueError(f"K1 cannot run {la_max}x{lb_max} on 8 CTAs "
                             "per pair")
        cluster += 1
    return cluster


def dp_forward(pssm: torch.Tensor, la: torch.Tensor, lb: torch.Tensor,
               go: int, ge: int, cluster: int = 0):
    """(dirs [B, D, W] int8, finals [3, B] int32) for a [B, LA, LB] int32
    score grid; K1 on the card, in clusters of ``cluster`` CTAs per pair
    (0: :func:`cluster_size`; the launch raises where :func:`ring_safe`
    refuses it)."""
    if not pssm.is_cuda:
        return gotoh.dp_forward(pssm, la, lb, go, ge)
    b, la_max, lb_max = pssm.shape
    dev = pssm.device
    _build.require(pssm, "pssm", I32, (b, la_max, lb_max), dev)
    _require_lanes(la, lb, b, dev)
    border = _border_on(int(go), int(ge), la_max + 1, dev)
    dirs = torch.empty((b, la_max + lb_max + 1, la_max + 1),
                       dtype=torch.int8, device=dev)
    finals = torch.empty((3, b), dtype=I32, device=dev)
    cluster = cluster or cluster_size(b, la_max, lb_max, dev)
    rc = _build.library().lara_gotoh_dp(
        pssm.data_ptr(), la.data_ptr(), lb.data_ptr(), border.data_ptr(), b,
        la_max, lb_max, int(go), int(ge), cluster, dirs.data_ptr(),
        finals.data_ptr(), _build.stream_of(pssm))
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
                    go: int, ge: int, dchunk: int, cluster: int = 0):
    """(dirs [Dp, B, W] int8, finals [3, B] int32) over pre-skewed scores
    [D, B, W] int32, D = la_max + lb_max + 1 and Dp = D rounded up to
    ``dchunk`` (``dchunk`` sets nothing else; rows past a lane's la + lb
    are padding).  K1-grid on the card, one launch, in clusters of
    ``cluster`` CTAs per pair as :func:`dp_forward` (the launch raises where
    :func:`ring_safe` refuses it)."""
    num_diag, b, width = skewed.shape
    num_rows = _round_up(num_diag, dchunk)
    if not skewed.is_cuda:
        res = gotoh.gotoh_scan(skewed, la, lb, go, ge, width - 1,
                               emit="dirs")
        dirs = torch.zeros((num_rows, b, width), dtype=torch.int8)
        dirs[:num_diag] = res.aux.to(torch.int8)
        return dirs, torch.stack([res.final_m, res.final_h, res.final_v])
    dev = skewed.device
    if num_diag <= width:
        raise ValueError(f"skewed has {num_diag} diagonals of width {width}; "
                         "a lane needs la_max + lb_max + 1 with lb_max >= 1")
    _build.require(skewed, "skewed", I32, (num_diag, b, width), dev)
    _require_lanes(la, lb, b, dev)
    border = _border_on(int(go), int(ge), width, dev)
    dirs = torch.empty((num_rows, b, width), dtype=torch.int8, device=dev)
    finals = torch.empty((3, b), dtype=I32, device=dev)
    cluster = cluster or cluster_size(b, width - 1, num_diag - width, dev)
    rc = _build.library().lara_gotoh_grid_dp(
        skewed.data_ptr(), la.data_ptr(), lb.data_ptr(), border.data_ptr(), b,
        num_diag, width, int(go), int(ge), cluster, dirs.data_ptr(),
        finals.data_ptr(), _build.stream_of(skewed))
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
    launch.  ``seq_score`` is [B, LA, LB] int32."""
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
    partner = torch.empty((b, la_max), dtype=I32, device=dev)
    scalars = torch.empty((4, b), dtype=I32, device=dev)
    rc = _build.library().lara_gotoh_grid_tb(
        dirs.data_ptr(), finals.data_ptr(), la.data_ptr(), lb.data_ptr(),
        seq_score.data_ptr(), b, num_rows, la_max, lb_max, int(go), int(ge),
        partner.data_ptr(), scalars.data_ptr(), _build.stream_of(dirs))
    _build.check(rc, "gotoh_grid_tb")
    _build.count("gotoh_grid_tb")
    return _traceback_of(partner, scalars)


def align_resident(pssm: torch.Tensor, la: torch.Tensor, lb: torch.Tensor,
                   go: int, ge: int, seq_score: torch.Tensor) -> Traceback:
    """Forward sweep and traceback of a [B, LA, LB] int32 score grid in one
    CTA per pair, the codes in shared memory: K-res on the card, on
    :func:`lara_tpu_torch.ops.gotoh_plan.resident_warps` warps per pair
    (raises where the pair does not fit; the caller's plan has checked)."""
    if not pssm.is_cuda:
        dirs, finals = gotoh.dp_forward(pssm, la, lb, go, ge)
        return gotoh.dp_traceback(dirs, finals, la, lb, go, ge, seq_score)
    b, la_max, lb_max = pssm.shape
    dev = pssm.device
    _build.require(pssm, "pssm", I32, (b, la_max, lb_max), dev)
    _require_lanes(la, lb, b, dev)
    _build.require(seq_score, "seq_score", I32, (b, la_max, lb_max), dev)
    warps = gotoh_plan.resident_warps(la_max, lb_max, smem_optin(dev))
    if not warps:
        raise ValueError(f"K-res does not fit {la_max}x{lb_max} on {dev}")
    border = _border_on(int(go), int(ge), la_max + 1, dev)
    partner = torch.empty((b, la_max), dtype=I32, device=dev)
    scalars = torch.empty((4, b), dtype=I32, device=dev)
    rc = _build.library().lara_gotoh_resident(
        pssm.data_ptr(), la.data_ptr(), lb.data_ptr(), border.data_ptr(),
        seq_score.data_ptr(), b, la_max, lb_max, int(go), int(ge), warps,
        partner.data_ptr(), scalars.data_ptr(), _build.stream_of(pssm))
    _build.check(rc, "gotoh_resident")
    _build.count("gotoh_resident")
    return _traceback_of(partner, scalars)


def _require_edge_inputs(seq_a, seq_b, la, lb, submat):
    """(pairs, la_max, lb_max, device) of K4's inputs, checked."""
    b, la_max = seq_a.shape
    lb_max = seq_b.shape[1]
    dev = seq_a.device
    _build.require(seq_a, "seq_a", I32, (b, la_max), dev)
    _build.require(seq_b, "seq_b", I32, (b, lb_max), dev)
    _require_lanes(la, lb, b, dev)
    _build.require(submat, "submat", I32, (5, 5), dev)
    return b, la_max, lb_max, dev


def edge_sweep(seq_a: torch.Tensor, seq_b: torch.Tensor, la: torch.Tensor,
               lb: torch.Tensor, submat: torch.Tensor, go: int, ge: int,
               cluster: int = 0):
    """K4's sweep: (prefix [2B, D, W] int32, finals [3, 2B] int32) of the
    forward wavefront over each pair and over its reversed sequences
    (:func:`lara_tpu_torch.ops.gotoh.edge_sweep`; only the cells inside the
    lanes' rectangles are written).  K1's kernel in its prefix mode on the
    card, in clusters of ``cluster`` CTAs per lane (0: :func:`cluster_size`
    at 2B lanes)."""
    if not seq_a.is_cuda:
        return gotoh.edge_sweep(seq_a, seq_b, la, lb, submat, go, ge)
    b, la_max, lb_max, dev = _require_edge_inputs(seq_a, seq_b, la, lb,
                                                  submat)
    prefix = torch.empty((2 * b, la_max + lb_max + 1, la_max + 1),
                         dtype=I32, device=dev)
    finals = torch.empty((3, 2 * b), dtype=I32, device=dev)
    cluster = cluster or cluster_size(2 * b, la_max, lb_max, dev)
    rc = _build.library().lara_edge_sweep(
        seq_a.data_ptr(), seq_b.data_ptr(), submat.data_ptr(), la.data_ptr(),
        lb.data_ptr(), b, la_max, lb_max, int(go), int(ge), cluster,
        prefix.data_ptr(), finals.data_ptr(), _build.stream_of(seq_a))
    _build.check(rc, "edge_sweep")
    _build.count("edge_sweep")
    return prefix, finals


def edge_pack(prefix: torch.Tensor, finals: torch.Tensor,
              seq_a: torch.Tensor, seq_b: torch.Tensor, la: torch.Tensor,
              lb: torch.Tensor, submat: torch.Tensor,
              subopt: int) -> torch.Tensor:
    """K4's pack: the ``[B, K+1]`` int32 words of
    :func:`edge_filter_skewed_words` from :func:`edge_sweep`'s output
    (:func:`lara_tpu_torch.ops.gotoh.edge_pack`); ``csrc/edge_filter.cu``
    on the card."""
    if not prefix.is_cuda:
        return gotoh.edge_pack(prefix, finals, seq_a, seq_b, la, lb, submat,
                               subopt)
    b, la_max, lb_max, dev = _require_edge_inputs(seq_a, seq_b, la, lb,
                                                  submat)
    num_diag, width = la_max + lb_max + 1, la_max + 1
    _build.require(prefix, "prefix", I32, (2 * b, num_diag, width), dev)
    _build.require(finals, "finals", I32, (3, 2 * b), dev)
    out = torch.empty((b, -(-num_diag * width // 32) + 1), dtype=I32,
                      device=dev)
    rc = _build.library().lara_edge_pack(
        prefix.data_ptr(), finals.data_ptr(), seq_a.data_ptr(),
        seq_b.data_ptr(), submat.data_ptr(), la.data_ptr(), lb.data_ptr(), b,
        la_max, lb_max, int(subopt), out.data_ptr(), _build.stream_of(prefix))
    _build.check(rc, "edge_pack")
    _build.count("edge_pack")
    return out


def edge_filter_skewed_words(seq_a: torch.Tensor, seq_b: torch.Tensor,
                             la: torch.Tensor, lb: torch.Tensor,
                             submat: torch.Tensor, go: int, ge: int,
                             subopt: int, la_max: int,
                             lb_max: int) -> torch.Tensor:
    """The edge filter of one chunk (the contract of
    :func:`lara_tpu_torch.ops.gotoh.edge_filter_skewed_words`, which runs
    for CPU tensors): ``[B, K+1]`` int32 packed skewed active bits plus
    each pair's optimum.  K4 on the card: :func:`edge_sweep`, then
    :func:`edge_pack`."""
    if not seq_a.is_cuda:
        return gotoh.edge_filter_skewed_words(seq_a, seq_b, la, lb, submat,
                                              go, ge, subopt, la_max, lb_max)
    if tuple(seq_a.shape[1:]) != (la_max,) \
            or tuple(seq_b.shape[1:]) != (lb_max,):
        raise ValueError(f"seq_a {tuple(seq_a.shape)} and seq_b "
                         f"{tuple(seq_b.shape)} are not [B, {la_max}] and "
                         f"[B, {lb_max}]")
    prefix, finals = edge_sweep(seq_a, seq_b, la, lb, submat, go, ge)
    return edge_pack(prefix, finals, seq_a, seq_b, la, lb, submat, subopt)


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

"""Anti-diagonal affine-gap Gotoh DP, traceback and edge filter in plain PyTorch.

Counterpart of :mod:`lara_tpu.ops.gotoh`, cell for cell: the same skewed
diagonal-major sweep, the same tie-breaking (M > H > V at matches,
extension first in gaps), the same border convention and the same int32
arithmetic.  Cells outside a lane's (la, lb) rectangle are computed exactly
as the JAX sweep computes them (their sums may wrap in int32); no valid cell
depends on them.

This module holds the plain versions of the CUDA kernels in
:mod:`lara_tpu_torch.ops.gotoh_cuda`: :func:`dp_forward` of K1 (forward
wavefront), :func:`dp_traceback` of K2 (traceback), both together of K-res,
and :func:`gotoh_scan` (over pre-skewed scores) of K1-grid.  ``dp_forward``
and ``dp_traceback`` take and return K1's and K2's layouts: ``dirs`` is
``[B, D, W]`` int8 with cell (i, j) at ``[b, i + j, i]`` (D = la_max +
lb_max + 1, W = la_max + 1) and ``finals`` is ``[3, B]`` int32 (M, H, V at
(la, lb)).  :func:`compact_lines` turns the dense partner map into the
ordered line list, as plain torch on every device.

The edge filter (:func:`edge_filter_active_words`, once per chunk) is K4
on the card: :func:`edge_sweep` is its sweep's plain version (the forward
prefix over each pair and over its reversed sequences, in K1's layout) and
:func:`edge_pack` its pack's; together they give the filter's row-major
words, which :func:`unpack_active_words` turns into the host's
``[B, LA, LB]`` grid.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lara_tpu_torch.types import PSSM_INIT

NEG_INF = -1431655764  # == PSSM_INIT: int32 lowest / 3 * 2 (score.hpp:92)
I32 = torch.int32

# state codes
MAT, HOR, VER = 0, 1, 2


class DPResult(NamedTuple):
    final_m: torch.Tensor  # [B] value at (la, lb)
    final_h: torch.Tensor
    final_v: torch.Tensor
    aux: torch.Tensor      # dirs [D, B, W] uint8  or  prefix [D, B, W] int32


class Traceback(NamedTuple):
    upper: torch.Tensor      # [B] optimal score
    partner: torch.Tensor    # [B, LA_MAX] dense line map: partner[a] = b or -1
    n_lines: torch.Tensor    # [B]
    gap_score: torch.Tensor  # [B] affine gap score (evaluateLines)
    seq_part: torch.Tensor   # [B] seq-score sum over the matched cells
    lines: torch.Tensor      # [B, LCAP, 2] matched (a, b) ascending, -1 pad;
                             # [B, 0, 2] unless the caller asked for lines


def skew_scores(scores: torch.Tensor, fill: int) -> torch.Tensor:
    """[B, LA, LB] cell scores -> diagonal-major [D, B, LA+1] with cell
    (i, j = d - i) at ``[d, :, i]`` reading ``scores[:, i-1, j-1]``."""
    b, la, lb = scores.shape
    dev = scores.device
    d_idx = torch.arange(la + lb + 1, device=dev)[:, None]
    i_idx = torch.arange(la + 1, device=dev)[None, :]
    j_idx = d_idx - i_idx
    valid = (i_idx >= 1) & (j_idx >= 1) & (j_idx <= lb)
    flat = ((i_idx - 1) * lb + (j_idx - 1)).clamp(0, la * lb - 1)
    gathered = scores.reshape(b, la * lb)[:, flat]  # [B, D, W]
    skewed = torch.where(valid[None], gathered, fill).to(I32)
    return skewed.permute(1, 0, 2).contiguous()


def gotoh_scan(skewed: torch.Tensor, la: torch.Tensor, lb: torch.Tensor,
               go: int, ge: int, la_max: int, emit: str = "dirs") -> DPResult:
    """Run the wavefront DP over pre-skewed scores ``[D, B, W]``.

    ``emit='dirs'``: auxiliary output is the packed traceback direction code
    ``mdir | hdir << 2 | vdir << 4`` per cell.  ``emit='prefix'``: it is
    max(M, H, V) per cell, for the edge filter.
    """
    num_diag, b, width = skewed.shape
    assert width == la_max + 1
    go, ge = int(go), int(ge)
    dev = skewed.device
    la_col = la.long()[:, None]
    end_diag = (la.to(I32) + lb.to(I32))
    end_diags = set(end_diag.tolist())

    # rows of diagonals d, d-1, d-2 in rotation; each row carries a leading
    # NEG_INF column, so row[:, :-1] is the i-1 neighbour and row[:, 1:] the
    # row itself
    rows = [[torch.full((b, width + 1), NEG_INF, dtype=I32, device=dev)
             for _ in range(3)] for _ in range(3)]  # [M/H/V][d % 3]
    fm = fh = fv = torch.full((b,), NEG_INF, dtype=I32, device=dev)
    aux = torch.empty((num_diag, b, width),
                      dtype=torch.uint8 if emit == "dirs" else I32, device=dev)

    for d in range(num_diag):
        m1p, h1p, v1p = (rows[s][(d + 2) % 3] for s in range(3))
        m2p, h2p, v2p = (rows[s][(d + 1) % 3] for s in range(3))
        t_row = skewed[d]

        # M from diagonal d-2 at i-1
        m2s, h2s, v2s = m2p[:, :-1], h2p[:, :-1], v2p[:, :-1]
        best_prev = torch.maximum(torch.maximum(m2s, h2s), v2s)
        m_new = best_prev + t_row
        mdir = torch.where(m2s == best_prev, MAT,
                           torch.where(h2s == best_prev, HOR, VER))

        # H from diagonal d-1 at the same i (cell (i, j-1)); prefer extension
        hh, hm, hv = h1p[:, 1:] + ge, m1p[:, 1:] + go, v1p[:, 1:] + go
        h_new = torch.maximum(torch.maximum(hh, hm), hv)
        hdir = torch.where(hh == h_new, HOR, torch.where(hm == h_new, MAT, VER))

        # V from diagonal d-1 at i-1 (cell (i-1, j)); prefer extension
        vv, vm, vh = v1p[:, :-1] + ge, m1p[:, :-1] + go, h1p[:, :-1] + go
        v_new = torch.maximum(torch.maximum(vv, vm), vh)
        vdir = torch.where(vv == v_new, VER, torch.where(vm == v_new, MAT, HOR))

        # border overrides: cell (d, 0) at offset d, then cell (0, d) at
        # offset 0 (at d == 0 the top rule wins for H, the left rule for V)
        bg = 0 if d == 0 else go + ge * (d - 1)
        edge_gap = NEG_INF if d == 0 else bg
        if d < width:
            m_new[:, d] = bg
            h_new[:, d] = NEG_INF
        m_new[:, 0] = bg
        h_new[:, 0] = edge_gap
        v_new[:, 0] = NEG_INF
        if d < width:
            v_new[:, d] = edge_gap

        # capture the per-lane terminal cell (la, lb) on its diagonal
        if d in end_diags:
            at_end = end_diag == d
            fm = torch.where(at_end, m_new.gather(1, la_col)[:, 0], fm)
            fh = torch.where(at_end, h_new.gather(1, la_col)[:, 0], fh)
            fv = torch.where(at_end, v_new.gather(1, la_col)[:, 0], fv)

        if emit == "dirs":
            aux[d] = mdir | (hdir << 2) | (vdir << 4)
        else:
            aux[d] = torch.maximum(torch.maximum(m_new, h_new), v_new)

        for s, new in enumerate((m_new, h_new, v_new)):
            rows[s][d % 3][:, 1:] = new
    return DPResult(fm, fh, fv, aux)


def dp_forward(pssm: torch.Tensor, la: torch.Tensor, lb: torch.Tensor,
               go: int, ge: int):
    """Plain version of K1: (dirs [B, D, W] int8, finals [3, B] int32) for
    the ``[B, LA, LB]`` int32 score grid (``PSSM_INIT`` outside the grid)."""
    la_max = pssm.shape[1]
    res = gotoh_scan(skew_scores(pssm, int(PSSM_INIT)), la, lb, go, ge,
                     la_max, emit="dirs")
    dirs = res.aux.permute(1, 0, 2).to(torch.int8).contiguous()
    finals = torch.stack([res.final_m, res.final_h, res.final_v])
    return dirs, finals


def dp_traceback(dirs: torch.Tensor, finals: torch.Tensor, la: torch.Tensor,
                 lb: torch.Tensor, go: int, ge: int,
                 seq_score: torch.Tensor) -> Traceback:
    """Plain version of K2: walk the direction codes from (la, lb) back to
    (0, 0) in every lane (``lara_tpu.ops.gotoh.traceback``, which is
    ``evaluateLines``, ``lagrange.hpp:147-221``, for the gap score).

    ``seq_score`` is ``[B, LA, LB]`` int32; ``seq_part`` sums it over the
    matched cells.  The walk runs ``la_max + lb_max`` masked steps: every
    lane reaches (0, 0) within la + lb of them.
    """
    b, num_diag, width = dirs.shape
    la_max = width - 1
    lb_max = num_diag - width
    go, ge = int(go), int(ge)
    dev = dirs.device
    final_m, final_h, final_v = finals[0], finals[1], finals[2]
    upper = torch.maximum(torch.maximum(final_m, final_h), final_v)
    state = torch.where(final_m == upper, MAT,
                        torch.where(final_h == upper, HOR, VER))

    i64 = torch.int64
    dirs_flat = dirs.reshape(-1).to(i64)
    seq_flat = seq_score.reshape(-1).to(i64)
    lane = torch.arange(b, device=dev, dtype=i64)
    code_base = lane * num_diag * width
    seq_base = lane * la_max * lb_max
    i = la.to(i64)
    j = lb.to(i64)
    cnt = torch.zeros(b, dtype=i64, device=dev)
    gap = torch.zeros(b, dtype=i64, device=dev)
    seq = torch.zeros(b, dtype=i64, device=dev)
    # one spare column absorbs the masked-off writes
    partner = torch.full((b, la_max + 1), -1, dtype=i64, device=dev)

    for _ in range(la_max + lb_max):
        at_i0, at_j0 = i == 0, j == 0
        live = ~(at_i0 & at_j0)
        # border forcing (oracle policy)
        state = torch.where(at_i0, HOR, torch.where(at_j0, VER, state))
        code = dirs_flat[code_base + (i + j) * width + i]
        pred = (code >> (2 * state)) & 3  # mdir, hdir or vdir by state

        is_m = live & (state == MAT)
        partner.scatter_(1, torch.where(is_m, i - 1, la_max)[:, None],
                         (j - 1)[:, None])
        cnt += is_m
        cell = seq_base + ((i - 1) * lb_max + j - 1).clamp(min=0)
        seq += torch.where(is_m, seq_flat[cell], 0)
        # a gap run extends (ge) when its predecessor is the same state
        gap += torch.where(live & (state != MAT),
                           torch.where(pred == state, ge, go), 0)

        i = i - (live & (state != HOR)).to(i64)
        j = j - (live & (state != VER)).to(i64)
        state = torch.where(live, pred, state)
    partner = partner[:, :la_max].to(I32)
    cnt, gap, seq = cnt.to(I32), gap.to(I32), seq.to(I32)
    return Traceback(upper=upper, partner=partner, n_lines=cnt,
                     gap_score=gap, seq_part=seq, lines=no_lines(b, dev))


def no_lines(b: int, device) -> torch.Tensor:
    """The ``lines`` of a traceback that was not asked for them."""
    return torch.zeros((b, 0, 2), dtype=I32, device=device)


def compact_lines(partner: torch.Tensor, n_lines: torch.Tensor,
                  lcap: int) -> torch.Tensor:
    """Dense partner map ``[B, LA]`` -> ordered line list ``[B, lcap, 2]``
    of (a, partner[a]) by ascending a, -1 beyond ``n_lines``
    (``lara_tpu/ops/gotoh_pallas.py:1027-1038``): a stable sort of the
    unmatched flags puts the matched positions first, in order."""
    order = torch.argsort((partner < 0).to(torch.int8), dim=1,
                          stable=True)[:, :lcap]
    lines_b = partner.gather(1, order)
    keep = torch.arange(lcap, device=partner.device)[None, :] \
        < n_lines[:, None]
    return torch.stack([torch.where(keep, order.to(I32), -1),
                        torch.where(keep, lines_b, -1)], dim=-1)


def suffix_scan(sub_shifted: torch.Tensor, la: torch.Tensor, lb: torch.Tensor,
                go: int, ge: int, la_max: int) -> torch.Tensor:
    """Reverse wavefront in FORWARD skewed coordinates
    (``lara_tpu.ops.gotoh.suffix_scan``): ``S[d', :, x]`` is max(M, H, V) of
    the best global alignment of A[x:la] vs B[d'-x:lb]."""
    num_diag, b, width = sub_shifted.shape
    assert width == la_max + 1
    go, ge = int(go), int(ge)
    dev = sub_shifted.device
    la = la.to(I32)
    lb = lb.to(I32)
    x_idx = torch.arange(width, device=dev, dtype=I32)[None, :]
    top = x_idx == la[:, None]

    def shift_left(x):
        return torch.cat([x[:, 1:], torch.full_like(x[:, :1], NEG_INF)], dim=1)

    neg = torch.full((b, width), NEG_INF, dtype=I32, device=dev)
    m1 = h1 = v1 = m2 = h2 = v2 = neg
    s_agg = torch.empty((num_diag, b, width), dtype=I32, device=dev)
    for dprime in range(num_diag - 1, -1, -1):
        t_row = sub_shifted[dprime]

        # M: (x, y) matched, continue at (x+1, y+1) = diag d'+2, offset x+1
        m2s, h2s, v2s = shift_left(m2), shift_left(h2), shift_left(v2)
        m_new = torch.maximum(torch.maximum(m2s, h2s), v2s) + t_row
        # H: B[y] gapped, continue at (x, y+1) = diag d'+1, same offset
        h_new = torch.maximum(torch.maximum(h1 + ge, m1 + go), v1 + go)
        # V: A[x] gapped, continue at (x+1, y) = diag d'+1, offset x+1
        m1s, h1s, v1s = shift_left(m1), shift_left(h1), shift_left(v1)
        v_new = torch.maximum(torch.maximum(v1s + ge, m1s + go), h1s + go)

        # borders: mirrored images of gotoh_scan's top/left overrides
        dd = (la + lb)[:, None] - dprime                      # [B, 1]
        bg = torch.where(dd == 0, 0, go + ge * (dd - 1)).to(I32)
        edge_gap = torch.where(dd == 0, NEG_INF, bg).to(I32)
        left = x_idx == (dprime - lb)[:, None]
        m_new = torch.where(top | left, bg, m_new)
        h_new = torch.where(top, edge_gap, torch.where(left, NEG_INF, h_new))
        v_new = torch.where(left, edge_gap, torch.where(top, NEG_INF, v_new))

        s_agg[dprime] = torch.maximum(torch.maximum(m_new, h_new), v_new)
        m2, h2, v2 = m1, h1, v1
        m1, h1, v1 = m_new, h_new, v_new
    return s_agg


def _shift_diag2(t: torch.Tensor) -> torch.Tensor:
    """``out[d, :, i] = t[d+2, :, i+1]`` with NEG_INF fill."""
    out = torch.full_like(t, NEG_INF)
    out[:-2, :, :-1] = t[2:, :, 1:]
    return out


def _sub_grid(submat: torch.Tensor, seq_a: torch.Tensor,
              seq_b: torch.Tensor) -> torch.Tensor:
    """[B, LA, LB] substitution scores by integer gather (exact)."""
    return submat[seq_a.long()[:, :, None], seq_b.long()[:, None, :]]


def edge_filter_active_words(seq_a, seq_b, la, lb, submat, go, ge, subopt,
                             la_max: int, lb_max: int) -> torch.Tensor:
    """Batched ``generateEdges`` (``edge_filter.hpp:131-158``), the edge
    filter of one chunk: an edge (a, b) survives iff prefix + sub(a, b) +
    suffix >= opt - subopt.  Returns ``[B, nw+1]`` int32 in row-major
    order, nw = ceil(la_max * lb_max / 32) words whose bit k of word w is
    edge (a, b) at 32w + k = a * lb_max + b (0 outside the lane's (la, lb)
    and past la_max * lb_max), then the per-lane optimum.  The words are
    the active section of the one-device upload
    (``device_driver._packed_buffer``); :func:`unpack_active_words` reads
    them.  The grid is the JAX package's ``unskew_active_words(
    edge_filter_skewed_words(...))``, computed as it computes it: two scans
    in skewed coordinates.  Plain version of K4 (:func:`edge_sweep` then
    :func:`edge_pack`)."""
    dev = seq_a.device
    la = la.to(I32)
    lb = lb.to(I32)
    submat = submat.to(I32)

    sub = _sub_grid(submat, seq_a, seq_b)
    skewed_f = skew_scores(sub, NEG_INF)
    res_f = gotoh_scan(skewed_f, la, lb, go, ge, la_max, emit="prefix")
    opt = torch.maximum(torch.maximum(res_f.final_m, res_f.final_h),
                        res_f.final_v)

    sub_shifted = _shift_diag2(skewed_f)   # sub(a, b2) at index (a+b2, a)
    s_agg = suffix_scan(sub_shifted, la, lb, go, ge, la_max)
    suf = _shift_diag2(s_agg)              # S(a+1, b2+1) at index (a+b2, a)

    num_diag, b, width = skewed_f.shape
    d_idx = torch.arange(num_diag, device=dev, dtype=I32)[:, None]
    a_idx = torch.arange(width, device=dev, dtype=I32)[None, :]
    b2_idx = d_idx - a_idx
    in_bounds = ((a_idx[None] < la[:, None, None])
                 & (b2_idx[None] >= 0)
                 & (b2_idx[None] < lb[:, None, None]))  # [B, D, W]
    total = res_f.aux + sub_shifted + suf               # [D, B, W]
    thresh = (opt - int(subopt))[None, :, None]
    act = in_bounds & (total >= thresh).permute(1, 0, 2)
    rows = torch.arange(la_max, device=dev)[:, None]
    cols = torch.arange(lb_max, device=dev)[None, :]
    return _packed_words(act[:, rows + cols, rows], opt)   # [B, LA, LB]


def _packed_words(act: torch.Tensor, opt: torch.Tensor) -> torch.Tensor:
    """[B, LA, LB] active bits -> ``[B, nw+1]`` int32: bit k of word w is
    cell 32w + k = a * LB + b (zero padding past LA * LB), then ``opt``."""
    b = act.shape[0]
    flat = act.reshape(b, -1).to(torch.int64)
    pad = (-flat.shape[1]) % 32
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    bits = flat.reshape(b, -1, 32)
    shifts = torch.arange(32, device=act.device, dtype=torch.int64)
    words = (bits << shifts).sum(dim=2)
    words = torch.where(words >= 2**31, words - 2**32, words).to(I32)
    return torch.cat([words, opt[:, None].to(I32)], dim=1)


def edge_sweep(seq_a, seq_b, la, lb, submat, go: int, ge: int):
    """Plain version of K4's sweep: the forward wavefront's prefix
    max(M, H, V) of every cell over 2B lanes, lane b over pair b's score
    grid and lane B + b over the grid of its reversed sequences (row x is
    ``seq_a[b, la-1-x]``, column y ``seq_b[b, lb-1-y]``), whose prefix at
    (la-1-a, lb-1-b2) is the suffix score of edge (a, b2).  Returns
    (prefix [2B, D, W] int32 in K1's layout, cell (i, j) at [lane, i+j, i],
    finals [3, 2B] int32).  Only cells with i <= la and j <= lb are
    defined."""
    b, la_max = seq_a.shape
    lb_max = seq_b.shape[1]
    dev = seq_a.device
    la = la.to(I32)
    lb = lb.to(I32)

    def reverse(seq, n, n_max):
        idx = (n.long()[:, None] - 1
               - torch.arange(n_max, device=dev)[None, :]).clamp(min=0)
        return seq.gather(1, idx)

    sub = _sub_grid(submat.to(I32),
                    torch.cat([seq_a, reverse(seq_a, la, la_max)]),
                    torch.cat([seq_b, reverse(seq_b, lb, lb_max)]))
    res = gotoh_scan(skew_scores(sub, NEG_INF), torch.cat([la, la]),
                     torch.cat([lb, lb]), go, ge, la_max, emit="prefix")
    prefix = res.aux.permute(1, 0, 2).contiguous()
    return prefix, torch.stack([res.final_m, res.final_h, res.final_v])


def edge_pack(prefix, finals, seq_a, seq_b, la, lb, submat,
              subopt: int) -> torch.Tensor:
    """Plain version of K4's pack: from :func:`edge_sweep`'s output, the
    ``[B, nw+1]`` row-major words of :func:`edge_filter_active_words`.
    Edge (a, b2) of pair b is active iff prefix[b] at (a, b2) + sub(a, b2)
    + prefix[B + b] at (la-1-a, lb-1-b2) >= opt - subopt, opt the best of
    lane b's finals; it reads no cell outside the lanes' rectangles."""
    b, la_max = seq_a.shape
    lb_max = seq_b.shape[1]
    width = la_max + 1
    dev = seq_a.device
    la_c = la.to(torch.int64)[:, None, None]
    lb_c = lb.to(torch.int64)[:, None, None]
    opt = torch.maximum(torch.maximum(finals[0, :b], finals[1, :b]),
                        finals[2, :b])
    a_idx = torch.arange(la_max, device=dev)[None, :, None]
    b2_idx = torch.arange(lb_max, device=dev)[None, None, :]
    in_bounds = (a_idx < la_c) & (b2_idx < lb_c)    # [B, LA, LB]

    def at(lanes, d, a):
        """lanes [B, D, W] at per-edge (d, a), 0 off the edges"""
        flat = torch.where(in_bounds, d * width + a, 0)
        return lanes.reshape(b, -1).gather(1, flat.reshape(b, -1)) \
            .reshape(b, la_max, lb_max)

    fwd = at(prefix[:b], a_idx + b2_idx, a_idx)
    bwd = at(prefix[b:], la_c + lb_c - 2 - a_idx - b2_idx, la_c - 1 - a_idx)
    total = fwd + _sub_grid(submat.to(I32), seq_a, seq_b) + bwd
    act = in_bounds & (total >= (opt - int(subopt))[:, None, None])
    return _packed_words(act, opt)


def unpack_active_words(packed_np: np.ndarray, la_max: int, lb_max: int):
    """Host side of :func:`edge_filter_active_words` (numpy): one
    contiguous unpack of the row-major words.  Returns (active [B, LA, LB]
    bool, a view of the unpacked bits with strides (LA*LB, LB, 1); opt
    [B])."""
    packed_np = np.ascontiguousarray(packed_np, dtype="<i4")
    flat = np.unpackbits(packed_np.view(np.uint8), axis=1,
                         count=la_max * lb_max, bitorder="little")
    return (flat.view(bool).reshape(packed_np.shape[0], la_max, lb_max),
            packed_np[:, -1])

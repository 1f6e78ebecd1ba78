"""Greedy lookahead matching in plain PyTorch, bit-equal to the reference.

Counterpart of :mod:`lara_tpu.solver.matching_device`: the replay of
``computeGreedyMatching`` + ``solveConflicts``
(``/root/reference/src/matching.hpp:99-192``) over statically queue-ordered
candidate columns.  Every lane runs its own round state machine under masks;
``solveConflicts``'s recursion is replayed by the memoised subset enumeration
(every recursion state is a pure function of the eliminated-slot set, filled
supersets first).

This module is the plain version of the CUDA kernel K3 in
:mod:`lara_tpu_torch.solver.matching_cuda`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

I32 = torch.int32


class RoundsResult(NamedTuple):
    score: torch.Tensor      # [B] int32: sum of accepted 2*score weights
    used_slot: torch.Tensor  # [B, S] bool: line slot is matched


def _conflict_tables(lh: int):
    """Static pair enumeration in reference order: (0,1),(0,2),..,(1,2),..."""
    cx, cy = [], []
    for x in range(lh):
        for y in range(x + 1, lh):
            cx.append(x)
            cy.append(y)
    return np.asarray(cx, np.int64), np.asarray(cy, np.int64)


def _lowest_bit_index(mask: torch.Tensor) -> torch.Tensor:
    """Index of the least-significant set bit (0 for mask == 0), by integer
    bit arithmetic on the isolated bit (equal to the JAX float log2)."""
    low = (mask & -mask).to(torch.int64)
    idx = torch.zeros_like(low)
    for shift, pattern in ((1, 0xAAAAAAAA), (2, 0xCCCCCCCC), (4, 0xF0F0F0F0),
                           (8, 0xFF00FF00), (16, 0xFFFF0000)):
        idx = idx + shift * ((low & pattern) != 0).to(torch.int64)
    return idx


def _solve_conflicts_enum(sel_l, sel_m, sel_w, sel_cnt, engaged, lh: int):
    """``solveConflicts`` via memoised subset enumeration
    (``lara_tpu.solver.matching_device._solve_conflicts_enum``).

    Selection slots [B, LH] (line ids, weights w = 2*score) and per-lane live
    counts; returns the [B] bitmask of eliminated slots (0 where not
    ``engaged``).  The recursion branches on the first remaining conflict,
    preferring to eliminate the higher (lighter) slot S, exploring the L
    branch only when S is strictly heavier and the filtered lists differ.
    """
    b = sel_l.shape[0]
    dev = sel_l.device
    n_conf = lh * (lh - 1) // 2
    if n_conf == 0:  # lookahead 1: a single selected edge never conflicts
        return torch.zeros((b,), dtype=I32, device=dev)
    cx_np, cy_np = _conflict_tables(lh)
    cx = torch.from_numpy(cx_np).to(dev)
    cy = torch.from_numpy(cy_np).to(dev)

    live = torch.arange(lh, device=dev)[None, :] < sel_cnt[:, None]  # [B, LH]
    la_, ma_ = sel_l[:, cx], sel_m[:, cx]
    lb_, mb_ = sel_l[:, cy], sel_m[:, cy]
    share = (la_ == lb_) | (la_ == mb_) | (ma_ == lb_) | (ma_ == mb_)
    conf_active = live[:, cx] & live[:, cy] & share  # [B, C]

    conf_bits = (1 << torch.arange(n_conf, device=dev, dtype=I32))[None, :]
    full_mask = torch.where(conf_active, conf_bits, 0).sum(1, dtype=I32)
    slot_ids = torch.arange(lh, device=dev)[None, :, None]
    involves = (cx[None, None, :] == slot_ids) | (cy[None, None, :] == slot_ids)
    touch = torch.where(involves & conf_active[:, None, :],
                        conf_bits[:, None, :], 0).sum(2, dtype=I32)  # [B, LH]

    n_sub = 1 << lh
    # remaining-conflict mask per elimination subset E:
    # mask(E) = full & ~OR(touch[e] for e in E), built by lowest-bit recursion
    mask_cols = [full_mask]
    for e_set in range(1, n_sub):
        low = (e_set & -e_set).bit_length() - 1
        mask_cols.append(mask_cols[e_set & (e_set - 1)] & ~touch[:, low])
    mask_e = torch.stack(mask_cols, dim=1)  # [B, 2^lh]

    # first conflict per state and its S/L slots (S = the higher slot)
    c0 = _lowest_bit_index(mask_e).clamp(0, n_conf - 1)
    s_slot = cy[c0]
    l_slot = cx[c0]
    w_s = sel_w.gather(1, s_slot)
    w_l = sel_w.gather(1, l_slot)
    empty = mask_e == 0
    single = ~empty & ((mask_e & (mask_e - 1)) == 0)
    s_bit = (1 << s_slot).to(I32)
    l_bit = (1 << l_slot).to(I32)
    subsets = torch.arange(n_sub, device=dev, dtype=torch.int64)[None, :]
    sub_s_idx = subsets | s_bit
    sub_l_idx = subsets | l_bit
    mask_after_s = mask_e.gather(1, sub_s_idx)
    mask_after_l = mask_e.gather(1, sub_l_idx)

    # memo over subsets, filled popcount-descending (supersets first); the
    # subsets of one popcount level are independent, so each level is one
    # vectorised slab
    res_w = torch.zeros((b, n_sub), dtype=I32, device=dev)
    res_elim = torch.zeros((b, n_sub), dtype=I32, device=dev)
    by_level: dict = {}
    for e_set in range(n_sub - 1):  # full set: mask empty, memo already 0
        by_level.setdefault(bin(e_set).count("1"), []).append(e_set)
    for level in sorted(by_level, reverse=True):
        cols = torch.tensor(by_level[level], device=dev)
        sub_s = res_w.gather(1, sub_s_idx[:, cols])
        sub_s_elim = res_elim.gather(1, sub_s_idx[:, cols])
        sub_l = res_w.gather(1, sub_l_idx[:, cols])
        sub_l_elim = res_elim.gather(1, sub_l_idx[:, cols])
        weight_s = w_s[:, cols] + sub_s
        weight_l = w_l[:, cols] + sub_l
        # explore the L branch only when the S branch is strictly heavier
        # and the two filtered conflict lists differ (matching.hpp:121-133)
        explore = (weight_s > w_l[:, cols]) & \
            (mask_after_s[:, cols] != mask_after_l[:, cols])
        l_wins = explore & (weight_s > weight_l)
        val_w = torch.where(
            empty[:, cols], 0,
            torch.where(single[:, cols], w_s[:, cols],
                        torch.where(l_wins, weight_l, weight_s)))
        val_elim = torch.where(
            empty[:, cols], 0,
            torch.where(single[:, cols], s_bit[:, cols],
                        torch.where(l_wins, sub_l_elim | l_bit[:, cols],
                                    sub_s_elim | s_bit[:, cols])))
        res_w[:, cols] = val_w.to(I32)
        res_elim[:, cols] = val_elim.to(I32)

    return torch.where(engaged, res_elim[:, 0], 0).to(I32)  # [B] slot bitmask


def rounds_loop(lq, mq, wq, live, line_edges, lookahead: int) -> RoundsResult:
    """Round loop over queue-ordered columns (position == rank): each round
    takes the next ``lh`` unblocked columns at or after the scan pointer,
    resolves their conflicts, keeps the survivors and blocks every column
    that shares an endpoint with them
    (``lara_tpu.solver.matching_device._rounds_loop``)."""
    b, width = lq.shape
    dev = lq.device
    lh = max(1, min(int(lookahead), 8))
    n_cand = live.sum(1, dtype=I32)
    lh_lane = torch.clamp(n_cand, max=lh)  # matching.hpp:153-156
    k_idx = torch.arange(lh, device=dev)[None, :]
    idx = torch.arange(width, device=dev, dtype=I32)[None, :]

    ptr = torch.zeros((b,), dtype=I32, device=dev)
    blocked = ~live
    score = torch.zeros((b,), dtype=I32, device=dev)
    used = torch.zeros(line_edges.shape, dtype=torch.bool, device=dev)

    while bool((ptr < width).any()):
        engaged = ptr < width
        ok = ~blocked & (idx >= ptr[:, None])
        srank = torch.cumsum(ok.to(I32), dim=1, dtype=I32)
        navail = srank[:, -1]

        sel_l_ks, sel_m_ks, sel_w_ks, rank_ks = [], [], [], []
        for k in range(lh):
            onehot = ok & (srank == k + 1)
            sel_l_ks.append(torch.where(onehot, lq, 0).sum(1, dtype=I32))
            sel_m_ks.append(torch.where(onehot, mq, 0).sum(1, dtype=I32))
            sel_w_ks.append(torch.where(onehot, wq, 0).sum(1, dtype=I32))
            rank_ks.append(torch.where(
                navail > k, torch.where(onehot, idx, 0).sum(1, dtype=I32),
                width))
        sel_rank = torch.stack(rank_ks, dim=1)
        valid_k = (sel_rank < width) & (k_idx < lh_lane[:, None])
        sel_cnt = valid_k.sum(1, dtype=I32)
        any_sel = sel_cnt > 0
        sel_l = torch.where(valid_k, torch.stack(sel_l_ks, dim=1), 0)
        sel_m = torch.where(valid_k, torch.stack(sel_m_ks, dim=1), 0)
        sel_w = torch.where(valid_k, torch.stack(sel_w_ks, dim=1), 0)

        elim_mask = _solve_conflicts_enum(
            sel_l, sel_m, sel_w, sel_cnt, engaged & any_sel, lh)
        kept = (engaged & any_sel)[:, None] & valid_k & \
            (((elim_mask[:, None] >> k_idx) & 1) == 0)

        score = score + torch.where(kept, sel_w, 0).sum(1, dtype=I32)

        # newly matched endpoints: block sharing columns and mark the line
        # slots they touch
        for k in range(lh):
            lk = sel_l[:, k:k + 1]
            mk = sel_m[:, k:k + 1]
            hit = (lq == lk) | (lq == mk) | (mq == lk) | (mq == mk)
            blocked = blocked | (kept[:, k:k + 1] & hit)
            used = used | (kept[:, k:k + 1]
                           & ((line_edges == lk) | (line_edges == mk)))

        sel_end = torch.where(valid_k, sel_rank, -1).amax(1)
        full_sel = any_sel & (sel_cnt >= lh_lane)
        new_ptr = torch.where(full_sel, sel_end + 1, width)
        ptr = torch.where(engaged, new_ptr, ptr).to(I32)
    return RoundsResult(score=score, used_slot=used)


def greedy_matching_queue(lq, mq, wq, live, line_edges,
                          lookahead: int) -> RoundsResult:
    """Greedy lookahead matching over statically queue-ordered columns: K3
    for CUDA tensors, :func:`rounds_loop` for CPU tensors."""
    if lq.is_cuda:
        from lara_tpu_torch.solver.matching_cuda import rounds_loop_cuda

        return rounds_loop_cuda(lq, mq, wq, live, line_edges, lookahead)
    return rounds_loop(lq, mq, wq, live, line_edges, lookahead)

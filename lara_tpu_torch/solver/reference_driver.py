"""Scalar NumPy mirror of the reference solver (truth oracle + `-m 0` path).

This module re-implements, pair by pair and iteration by iteration, the exact
semantics of:

* ``lara::Lagrange`` (``reference/src/lagrange.hpp``): edge filtering,
  interaction/dual construction, PSSM maintenance, primal evaluation,
* ``lara::SubgradientSolver`` / ``lara::solve``
  (``subgradient_solver.hpp:64-352``): bound bookkeeping, step-size control,
  dual updates, convergence,
* ``lara::Lagrange::getStructureLines`` (``lagrange.hpp:437-487``): output
  weights.

The reference's SeqAn/LEMON submodules are not vendored, so the reference
binary cannot be built; this mirror *is* the executable specification that
the batched TPU backend is tested against.

Numeric policy notes (see :mod:`lara_tpu_torch.types`):
* all profits are int32 fixed point (x8192),
* contact probabilities are truncated to int on extraction
  (``Contact = pair<int32, size_t>``, ``data_types.hpp:70``) unless
  ``precise_bpp`` is set,
* duals are int32; the subgradient step is computed in float32 and truncated
  (``subgradient_solver.hpp:265-271``).

Known deviations from the reference (documented reference UB):
* linear libscore mode takes min/max profits over *active* edges only; the
  reference's ``minmax_element`` dereferences empty priority queues
  (``lagrange.hpp:445-448``) which is undefined behavior,
* if max==min profit in linear mode the scale is 0 instead of NaN,
* per-pair PSSMs are always allocated at the pair's true dimensions; the
  reference can index out of bounds when second-sequence lengths are not
  monotone along the longest-first pair order (``subgradient_solver.hpp:179``
  with ``max_2nd_length`` taken from the first pair only).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from lara_tpu_torch.io.records import RnaRecord
from lara_tpu_torch.params import Parameters
from lara_tpu_torch.scoring.ribosum import encode_rna5
from lara_tpu_torch.solver import matching_ref, oracle
from lara_tpu_torch.types import (
    INFINITY,
    av_seq_id,
    contact_weight_to_int,
    f2i,
    scaled_seq_score,
    seq_scale_factor,
    struct_score,
)


@dataclass
class PairResult:
    seq_indices: Tuple[int, int]  # ordered (smaller, larger) for output
    columns: List[Tuple[int, int, int]]
    score: int  # bestLower, stored with the alignment (io.hpp:292-293)
    iterations: int
    best_upper: int
    best_lower: int


@dataclass
class LagrangeState:
    """Per-pair model state (mirror of ``Lagrange``)."""

    la: int
    lb: int
    seq_a: np.ndarray
    seq_b: np.ndarray
    active: np.ndarray            # bool [LA, LB]
    seq_score: np.ndarray         # int64 [LA, LB], scaled sequence profits
    # directed dual variables
    dual_l: np.ndarray            # int64 [D] source edge id (a * LB + b)
    dual_m: np.ndarray            # int64 [D] partner edge id
    sscore: np.ndarray            # int64 [D] structural profit
    rev: np.ndarray               # int64 [D] index of the reverse dual
    dual: np.ndarray              # int64 [D] current dual values (int32 range)
    partners_of: Dict[int, List[int]]  # edge id -> list of dual indices (asc order)
    # best primal solution so far
    best_score: int = -int(INFINITY)
    best_lines: List[int] = field(default_factory=list)
    best_contacts: Dict[int, int] = field(default_factory=dict)


def build_lagrange(
    rec_a: RnaRecord, rec_b: RnaRecord, params: Parameters
) -> LagrangeState:
    """Mirror of the ``Lagrange`` constructor (``lagrange.hpp:229-310``)."""
    seq_a = encode_rna5(rec_a.sequence)
    seq_b = encode_rna5(rec_b.sequence)
    la, lb = len(seq_a), len(seq_b)
    go, ge = int(params.gap_open_int), int(params.gap_extend_int)
    submat = params.score_matrix

    subopt_int = int(f2i(params.suboptimal_diff))
    active, opt = oracle.generate_edges(seq_a, seq_b, submat, go, ge, subopt_int)
    avid = av_seq_id(opt, la, lb)
    scale = seq_scale_factor(params.sequence_scale, avid)
    from lara_tpu_torch.solver.interactions import effective_balance

    balance = effective_balance(params, avid)

    # scaled per-edge sequence scores (only meaningful on active edges):
    # trunc(float32(scale) * float32(matval)) per getSeqScore (lagrange.hpp:223-226)
    mat_lookup = np.asarray(submat, dtype=np.int32)[seq_a[:, None], seq_b[None, :]]
    seq_sc = np.trunc(
        np.float32(scale) * mat_lookup.astype(np.float32)
    ).astype(np.int32).astype(np.int64)

    # adjacency with contact weights; reference truncates to int
    def build_adj(record: RnaRecord, length: int):
        adj: List[List[Tuple[float, int]]] = [[] for _ in range(length)]
        for (i, j, w) in record.structure_edges:
            weight = float(w) if params.precise_bpp else int(contact_weight_to_int(w))
            adj[i].append((weight, j))
            adj[j].append((weight, i))
        return adj

    adj_a = build_adj(rec_a, la)
    adj_b = build_adj(rec_b, lb)

    dual_l: List[int] = []
    dual_m: List[int] = []
    sscores: List[int] = []
    pair_to_dual: Dict[Tuple[int, int], int] = {}
    partners_of: Dict[int, List[int]] = {}

    # lagrange.hpp:264-300 -- edge-major construction order
    for a in range(la):
        for b in range(lb):
            if not active[a, b]:
                continue
            edge = a * lb + b
            plist = []
            for (w_head, a2) in adj_a[a]:
                for (w_tail, b2) in adj_b[b]:
                    if not (0 <= a2 < la and 0 <= b2 < lb):
                        continue
                    if not active[a2, b2]:
                        continue
                    # nonCrossing (lagrange.hpp:101-106)
                    if not ((a < a2 and b < b2) or (a2 < a and b2 < b)):
                        continue
                    didx = len(dual_l)
                    dual_l.append(edge)
                    dual_m.append(a2 * lb + b2)
                    if params.precise_bpp:
                        sval = int(
                            np.int32(
                                np.trunc(
                                    np.float32(balance)
                                    * np.float32(np.float32(w_head) + np.float32(w_tail))
                                    / np.float32(2.0)
                                    * np.float32(8192.0)
                                )
                            )
                        )
                    else:
                        sval = int(struct_score(balance, w_head, w_tail))
                    sscores.append(sval)
                    pair_to_dual[(edge, a2 * lb + b2)] = didx
                    plist.append(didx)
            partners_of[edge] = plist

    d = len(dual_l)
    rev = np.empty(d, dtype=np.int64)
    for (l_edge, m_edge), didx in pair_to_dual.items():
        rev[didx] = pair_to_dual[(m_edge, l_edge)]

    return LagrangeState(
        la=la,
        lb=lb,
        seq_a=seq_a,
        seq_b=seq_b,
        active=active,
        seq_score=seq_sc,
        dual_l=np.asarray(dual_l, dtype=np.int64),
        dual_m=np.asarray(dual_m, dtype=np.int64),
        sscore=np.asarray(sscores, dtype=np.int64),
        rev=rev,
        dual=np.zeros(d, dtype=np.int64),
        partners_of=partners_of,
    )


# ---------------------------------------------------------------------------
# priority-queue equivalents
# ---------------------------------------------------------------------------

def _top_entry(state: LagrangeState, edge: int) -> Tuple[int, int]:
    """First element of ``priorityQ[edge]``: (max profit over partners incl.
    the self entry at profit 0, tie -> smallest partner edge id).

    Queue keys are ``(-(alignScore + profit), partner)`` (``lagrange.hpp:
    271,294``); subtracting the common alignScore leaves ``(-profit,
    partner)`` with the self entry at profit 0.
    """
    best_profit = 0
    best_partner = edge
    for didx in state.partners_of.get(edge, []):
        profit = int(state.sscore[didx] + state.dual[didx])
        partner = int(state.dual_m[didx])
        if profit > best_profit or (profit == best_profit and partner < best_partner):
            best_profit = profit
            best_partner = partner
    return best_profit, best_partner


def _max_partner_profit(state: LagrangeState, edge: int) -> int:
    """Max profit among true partners only (no self entry); -inf if none."""
    best = -int(INFINITY)
    for didx in state.partners_of.get(edge, []):
        profit = int(state.sscore[didx] + state.dual[didx])
        if profit > best:
            best = profit
    return best


def build_pssm(state: LagrangeState) -> np.ndarray:
    """Dense PSSM [LA, LB]: active -> alignScore + max(0, maxPartnerProfit),
    inactive -> INITVALUE (``score.hpp:92``, ``lagrange.hpp:305-309``)."""
    from lara_tpu_torch.types import PSSM_INIT

    mpp = np.full(state.la * state.lb, -int(INFINITY), dtype=np.int64)
    if len(state.dual_l):
        profits = state.sscore + state.dual
        np.maximum.at(mpp, state.dual_l, profits)
    bonus = np.maximum(mpp, 0).reshape(state.la, state.lb)
    return np.where(state.active, state.seq_score + bonus, int(PSSM_INIT))


# ---------------------------------------------------------------------------
# valid_solution (lagrange.hpp:325-423)
# ---------------------------------------------------------------------------

def valid_solution(
    state: LagrangeState,
    lines: List[Tuple[int, int]],
    gap_score: int,
    lookahead: int,
):
    """Returns (primalValue, subgradient_dual_indices, sign_by_index).

    ``subgradient_dual_indices`` lists indices in reference insertion order
    (+index, -index per inconsistent pick); its *length* is the step-size
    denominator (``subgradient_solver.hpp:265-266``).
    """
    line_edges = [a * state.lb + b for (a, b) in lines]
    in_solution = set()
    for edge in line_edges:
        assert state.active.flat[edge], "alignment match where no edge is defined"
        in_solution.add(edge)

    sg_indices: List[int] = []
    sg_sign: Dict[int, float] = {}

    for edge in line_edges:
        # all queue entries tied at the maximum (lagrange.hpp:346-373)
        top_profit, _ = _top_entry(state, edge)
        tied: List[Tuple[int, int]] = []  # (partner_edge, dual_idx)
        if top_profit == 0:
            pass  # self entry among the max -> handled per partner below
        for didx in state.partners_of.get(edge, []):
            profit = int(state.sscore[didx] + state.dual[didx])
            if profit == top_profit:
                tied.append((int(state.dual_m[didx]), didx))
        # iterate in queue order: (same profit) -> ascending partner id;
        # the self entry (partner == edge) yields a trivial cycle and is
        # skipped implicitly.
        for partner, didx in sorted(tied):
            found_cycle = False
            if partner in in_solution:
                p_top, _ = _top_entry(state, partner)
                rev_didx = int(state.rev[didx])
                rev_profit = int(state.sscore[rev_didx] + state.dual[rev_didx])
                # partner's tied-max set contains `edge` iff rev profit == top
                if rev_profit == p_top:
                    found_cycle = True
                # the partner's self entry can match `edge` only if partner==edge
            if not found_cycle:
                rev_didx = int(state.rev[didx])
                sg_sign[didx] = 1.0
                sg_indices.append(didx)
                sg_sign[rev_didx] = -1.0
                sg_indices.append(rev_didx)

    lower_bound = 0
    for (a, b) in lines:
        lower_bound += int(state.seq_score[a, b])

    contacts: Dict[int, int] = {}
    if sg_indices:
        # matching branch (lagrange.hpp:380-395)
        possible: List[List[Tuple[int, int]]] = []
        for edge in line_edges:
            plist: List[Tuple[int, int, int]] = []
            for didx in state.partners_of.get(edge, []):
                partner = int(state.dual_m[didx])
                if partner in in_solution and edge < partner:
                    profit = int(state.sscore[didx] + state.dual[didx])
                    plist.append((profit, partner, int(state.sscore[didx])))
            # priorityQ iteration order: (-profit, partner) ascending
            plist.sort(key=lambda t: (-t[0], t[1]))
            possible.append([(s, p) for (_prof, p, s) in plist])
        if lookahead == 0:
            add, contacts = matching_ref.exact_matching(possible, line_edges)
        else:
            add, contacts = matching_ref.greedy_matching(possible, line_edges, lookahead)
        lower_bound += add
    else:
        # consistent branch (lagrange.hpp:397-409)
        for edge in line_edges:
            _profit, partner = _top_entry(state, edge)
            if partner != edge:
                didx = _find_dual(state, edge, partner)
                lower_bound += int(state.sscore[didx])
                contacts[edge] = partner
                contacts[partner] = edge

    primal = lower_bound + gap_score
    if primal > state.best_score:
        state.best_score = primal
        state.best_lines = list(line_edges)
        state.best_contacts = dict(contacts)
    return primal, sg_indices, sg_sign


def _find_dual(state: LagrangeState, edge: int, partner: int) -> int:
    for didx in state.partners_of.get(edge, []):
        if int(state.dual_m[didx]) == partner:
            return didx
    raise KeyError((edge, partner))


# ---------------------------------------------------------------------------
# subgradient loop (subgradient_solver.hpp:219-331, scalar variant)
# ---------------------------------------------------------------------------

def solve_pair(
    rec_a: RnaRecord,
    rec_b: RnaRecord,
    params: Parameters,
    seq_indices: Tuple[int, int],
) -> PairResult:
    """Run the full Lagrangian loop for one pair.

    ``rec_a`` must be the longer sequence (the driver orders pairs longer
    first, ``subgradient_solver.hpp:115-120``); ``seq_indices`` are the
    original storage indices of (rec_a, rec_b).
    """
    state = build_lagrange(rec_a, rec_b, params)
    go, ge = int(params.gap_open_int), int(params.gap_extend_int)

    step_factor = np.float32(params.step_size_factor)
    nondecreasing = 0
    remaining = int(params.num_iterations)
    best_lower = -int(INFINITY)
    best_upper = int(INFINITY)

    dual_at_queue = state.dual.copy()
    while True:
        # Snapshot the dual values the priority queues currently reflect: the
        # reference applies dual updates to the queues only via updateScores,
        # which is skipped on the terminating iteration
        # (subgradient_solver.hpp:286-331); getStructureLines therefore sees
        # the pre-final-update profits in linear libscore mode.
        dual_at_queue = state.dual.copy()
        pssm = build_pssm(state)
        upper, lines, gaps_a, gaps_b = oracle.align_pssm(pssm, go, ge)
        gap_score = oracle.evaluate_lines(gaps_a, gaps_b, go, ge)
        lower, sg_indices, sg_sign = valid_solution(
            state, lines, gap_score, int(params.matching)
        )

        if upper < best_upper:
            best_upper = upper
            nondecreasing = 0
        if lower > best_lower:
            best_lower = lower
            nondecreasing = 0
        if nondecreasing >= int(params.max_nondecr_iterations):
            step_factor = np.float32(step_factor / np.float32(2.0))
            nondecreasing = 0
        else:
            nondecreasing += 1

        if sg_indices:
            step_size = np.float32(
                step_factor
                * np.float32(np.int64(best_upper) - np.int64(best_lower))
                / np.float32(len(sg_indices))
            )
            for didx in set(sg_indices):
                state.dual[didx] = int(
                    np.int32(
                        np.trunc(
                            np.float32(state.dual[didx])
                            - step_size * np.float32(sg_sign[didx])
                        )
                    )
                )
        remaining -= 1

        # The reference carries SEQAN_ASSERTs here ("bounds differ although
        # there are no subgradients", "lower exceeds upper",
        # subgradient_solver.hpp:274-283) -- but those are debug-only; the
        # release binary tolerates the tie-induced bound crossing (the
        # consistent branch can double-count a line whose tied top picks
        # overlap, lagrange.hpp:397-409) and simply runs on with a negative
        # step size until the iteration budget is spent.  Mirror release
        # behavior: no hard failure.

        if best_upper == best_lower or remaining == 0:
            break

    final_dual = state.dual
    state.dual = dual_at_queue
    columns = get_structure_lines(state, params)
    state.dual = final_dual
    swap = seq_indices[0] > seq_indices[1]
    out_indices = (min(seq_indices), max(seq_indices))
    if swap:
        columns = [(b, a, w) for (a, b, w) in columns]
    return PairResult(
        seq_indices=out_indices,
        columns=columns,
        score=best_lower,
        iterations=int(params.num_iterations) - remaining,
        best_upper=best_upper,
        best_lower=best_lower,
    )


def get_structure_lines(state: LagrangeState, params: Parameters):
    """Mirror of ``getStructureLines`` (``lagrange.hpp:437-487``), without the
    output-side index swap (applied by the caller).

    Binary mode: weight = 500 + 500 * (line in matching).
    Linear mode: linear rescale of current max profits into
    [libscoreMin, libscoreMax]; min/max taken over active edges (see module
    docstring for the UB deviation).
    """
    columns = []
    if params.library_score_is_linear:
        tops = []
        for a in range(state.la):
            for b in range(state.lb):
                if state.active[a, b]:
                    edge = a * state.lb + b
                    profit, _ = _top_entry(state, edge)
                    tops.append(int(state.seq_score[a, b]) + max(0, profit))
        min_score = min(tops)
        max_score = max(tops)
        if max_score > min_score:
            div = np.float32(
                np.float32(1.0)
                * np.float32(params.library_score_max - params.library_score_min)
                / np.float32(max_score - min_score)
            )
        else:
            div = np.float32(0.0)
        for edge in state.best_lines:
            a, b = divmod(edge, state.lb)
            profit, _ = _top_entry(state, edge)
            top_val = int(state.seq_score[a, b]) + max(0, profit)
            matched = 1 if edge in state.best_contacts else 0
            val = int(np.int32(np.trunc(np.float32(matched * (top_val - min_score)) * div)))
            columns.append((a, b, params.library_score_min + val))
    else:
        for edge in state.best_lines:
            a, b = divmod(edge, state.lb)
            matched = 1 if edge in state.best_contacts else 0
            columns.append((a, b, matched * 500 + 500))
    return columns

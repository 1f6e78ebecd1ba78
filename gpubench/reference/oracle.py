"""NumPy oracle implementations of the alignment DPs.

These are the semantic ground truth for lara-tpu: a faithful re-derivation of
the reference's Gotoh affine-gap dynamic programs in int32 fixed point.

* :func:`gotoh_matrices` mirrors ``PairwiseGotoh``
  (``reference/src/edge_filter.hpp:52-129``): M/H/V matrices with the
  reference's border initialisation (M border equals the gap matrix so that
  prefix scores are defined on borders).
* :func:`generate_edges` mirrors ``generateEdges``
  (``edge_filter.hpp:131-158``): forward + reversed DP, suboptimality
  threshold, average-sequence-identity return.
* :func:`align_pssm` is the per-iteration global alignment over the
  position-specific score matrix (the reference calls SeqAn's
  ``globalAlignment`` with ``RnaScoreType``,
  ``subgradient_solver.hpp:223-225``).  SeqAn's internal tie-breaking is not
  observable (the submodule is not vendored), so lara-tpu fixes its own
  deterministic policy, used identically by every backend:

  - end state and match predecessors prefer M > H > V,
  - gap states prefer extending the same gap (H from H, V from V), then M,
    then the other gap state,
  - on the i==0 / j==0 borders the state is forced to H / V respectively
    (border M values equal the gap values by construction).

Gap convention (SeqAn): a gap of length k costs ``gap_open + (k-1) *
gap_extend``; ``gap_open`` includes the first gap character.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

NEG_INF = np.int32(-1431655764)  # lara::infinity negated (data_types.hpp:77)


def _row_sweep(sub_row, prev_m, prev_h, prev_v, m0, h0, v0, go, ge):
    """Compute row i of M/H/V from row i-1.

    M and V depend only on the previous row; H is a prefix cummax along the
    row (affine horizontal chain), computed in closed form.
    """
    lb = sub_row.shape[0]
    best_prev = np.maximum(np.maximum(prev_m, prev_h), prev_v)
    m_row = np.empty(lb + 1, dtype=np.int64)
    v_row = np.empty(lb + 1, dtype=np.int64)
    m_row[0] = m0
    v_row[0] = v0
    m_row[1:] = best_prev[:-1] + sub_row
    v_row[1:] = np.maximum(np.maximum(prev_m[1:] + go, prev_h[1:] + go), prev_v[1:] + ge)
    # H[j] = max over k<j of (max(M[k], V[k]) + go + (j-1-k)*ge), plus the
    # chain from H[0]:  H[0] + j*ge.
    base = np.maximum(m_row, v_row) + go
    k_idx = np.arange(lb + 1, dtype=np.int64)
    shifted = np.maximum.accumulate(base - ge * k_idx)
    h_row = np.empty(lb + 1, dtype=np.int64)
    h_row[0] = h0
    h_row[1:] = np.maximum(shifted[:-1] + ge * (k_idx[1:] - 1), h0 + ge * k_idx[1:])
    return m_row, h_row, v_row


def gotoh_matrices(seq_a, seq_b, submat, go, ge):
    """Full M/H/V matrices, shape [LA+1, LB+1], int64 internally.

    Border init per ``edge_filter.hpp:79-97``:
    M[0][0]=0, H[0][0]=V[0][0]=-inf; M[i][0]=V[i][0]=go+ge*(i-1), H[i][0]=-inf;
    M[0][j]=H[0][j]=go+ge*(j-1), V[0][j]=-inf.
    """
    la, lb = len(seq_a), len(seq_b)
    go = np.int64(go)
    ge = np.int64(ge)
    m = np.empty((la + 1, lb + 1), dtype=np.int64)
    h = np.empty((la + 1, lb + 1), dtype=np.int64)
    v = np.empty((la + 1, lb + 1), dtype=np.int64)
    m[0, 0] = 0
    h[0, 0] = NEG_INF
    v[0, 0] = NEG_INF
    j = np.arange(1, lb + 1, dtype=np.int64)
    m[0, 1:] = go + ge * (j - 1)
    h[0, 1:] = go + ge * (j - 1)
    v[0, 1:] = NEG_INF
    sub = np.asarray(submat, dtype=np.int64)[np.asarray(seq_a)[:, None],
                                             np.asarray(seq_b)[None, :]]
    for i in range(1, la + 1):
        m0 = go + ge * (i - 1)
        m[i], h[i], v[i] = _row_sweep(sub[i - 1], m[i - 1], h[i - 1], v[i - 1],
                                      m0, NEG_INF, m0, go, ge)
    return m, h, v


def gotoh_matrices_pssm(pssm, go, ge):
    """Same DP but scores come from a dense position matrix [LA, LB]."""
    la, lb = pssm.shape
    go = np.int64(go)
    ge = np.int64(ge)
    m = np.empty((la + 1, lb + 1), dtype=np.int64)
    h = np.empty((la + 1, lb + 1), dtype=np.int64)
    v = np.empty((la + 1, lb + 1), dtype=np.int64)
    m[0, 0] = 0
    h[0, 0] = NEG_INF
    v[0, 0] = NEG_INF
    j = np.arange(1, lb + 1, dtype=np.int64)
    m[0, 1:] = go + ge * (j - 1)
    h[0, 1:] = go + ge * (j - 1)
    v[0, 1:] = NEG_INF
    pssm64 = np.asarray(pssm, dtype=np.int64)
    for i in range(1, la + 1):
        m0 = go + ge * (i - 1)
        m[i], h[i], v[i] = _row_sweep(pssm64[i - 1], m[i - 1], h[i - 1], v[i - 1],
                                      m0, NEG_INF, m0, go, ge)
    return m, h, v


def generate_edges(seq_a, seq_b, submat, go, ge, subopt_int):
    """Edge prefilter: (active bool [LA, LB], optimal_score int).

    ``edge_filter.hpp:131-158``: keep (a, b) iff
    prefix(a,b) + s(a,b) + suffix(rev) >= opt - subopt.
    """
    seq_a = np.asarray(seq_a)
    seq_b = np.asarray(seq_b)
    mf, hf, vf = gotoh_matrices(seq_a, seq_b, submat, go, ge)
    mb, hb, vb = gotoh_matrices(seq_a[::-1], seq_b[::-1], submat, go, ge)
    fwd = np.maximum(np.maximum(mf, hf), vf)
    bwd = np.maximum(np.maximum(mb, hb), vb)
    opt = fwd[-1, -1]
    assert opt == bwd[-1, -1], "forward/backward optimal scores differ"
    la, lb = len(seq_a), len(seq_b)
    sub = np.asarray(submat, dtype=np.int64)[seq_a[:, None], seq_b[None, :]]
    total = fwd[:la, :lb] + sub + bwd[::-1, ::-1][1:, 1:]
    active = total >= (opt - np.int64(subopt_int))
    return active, int(opt)


# traceback state codes
_M, _H, _V = 0, 1, 2


def align_pssm(pssm, go, ge) -> Tuple[int, List[Tuple[int, int]], List[int], List[int]]:
    """Global affine alignment over a PSSM with traceback.

    Returns ``(score, lines, gaps_a, gaps_b)`` where ``lines`` are matched
    position pairs in ascending order and ``gaps_a``/``gaps_b`` are the
    per-column gap flags of the final alignment (1 = gap), used by
    :func:`evaluate_lines`.
    """
    m, h, v = gotoh_matrices_pssm(pssm, go, ge)
    la, lb = pssm.shape
    go = np.int64(go)
    ge = np.int64(ge)
    score = max(m[la, lb], h[la, lb], v[la, lb])

    # end state preference M > H > V
    if m[la, lb] == score:
        state = _M
    elif h[la, lb] == score:
        state = _H
    else:
        state = _V

    i, j = la, lb
    rev_cols: List[Tuple[int, int]] = []  # (gap_a, gap_b) flags, reversed
    rev_lines: List[Tuple[int, int]] = []
    pssm64 = np.asarray(pssm, dtype=np.int64)
    while i > 0 or j > 0:
        if i == 0:
            state = _H
        elif j == 0:
            state = _V
        if state == _M:
            rev_lines.append((i - 1, j - 1))
            rev_cols.append((0, 0))
            target = m[i, j] - pssm64[i - 1, j - 1]
            i, j = i - 1, j - 1
            # predecessor preference M > H > V
            if m[i, j] == target:
                state = _M
            elif h[i, j] == target:
                state = _H
            else:
                state = _V
        elif state == _H:
            rev_cols.append((1, 0))  # gap in A, consumes B char j-1
            target = h[i, j]
            j = j - 1
            # preference H (extend) > M > V
            if h[i, j] + ge == target:
                state = _H
            elif m[i, j] + go == target:
                state = _M
            else:
                state = _V
        else:  # _V
            rev_cols.append((0, 1))  # gap in B, consumes A char i-1
            target = v[i, j]
            i = i - 1
            if v[i, j] + ge == target:
                state = _V
            elif m[i, j] + go == target:
                state = _M
            else:
                state = _H
    rev_cols.reverse()
    rev_lines.reverse()
    gaps_a = [c[0] for c in rev_cols]
    gaps_b = [c[1] for c in rev_cols]
    return int(score), rev_lines, gaps_a, gaps_b


def evaluate_lines(gaps_a, gaps_b, go, ge) -> int:
    """Gap score of a gapped column sequence, mirroring ``evaluateLines``
    (``lagrange.hpp:147-221``): per-sequence maximal gap runs, ``go`` for the
    first gap character of a run, ``ge`` for each subsequent one."""
    gap_score = 0
    open_a = open_b = False
    for ga, gb in zip(gaps_a, gaps_b):
        if ga:
            gap_score += ge if open_a else go
            open_a = True
        else:
            open_a = False
        if gb:
            gap_score += ge if open_b else go
            open_b = True
        else:
            open_b = False
    return int(gap_score)

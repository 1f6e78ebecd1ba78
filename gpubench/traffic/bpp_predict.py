"""Built-in base-pair probability prediction: a McCaskill partition
function over a full nearest-neighbour (Turner-2004-style) energy model.

The benchmark's frozen copy of the port's ``solver/bpp_predict.py``, which
the traffic generator (:mod:`gpubench.traffic.generate`) folds its tRNA
pools with; only the import of ``encode_rna5`` is rewritten.

The reference delegates structure prediction to ViennaRNA's ``pf_fold``
(``reference/src/io.hpp:286-338``) and hard-exits when ViennaRNA is
not compiled in (``io.hpp:332-336``).  lara-tpu ships its own predictor
instead, enabled with ``--predict builtin``.  Structure prediction is
*host-side input preprocessing* (exactly ViennaRNA's role in the
reference -- a CPU C library call per record, ``io.hpp:299-330``); it
feeds the host model build, never the device hot loop, so the production
path is a vectorized NumPy inside+outside sweep (strided diagonal views,
float64), not an XLA program -- a compile-free O(n^3 + 500 n^2) pass
beats paying a Mosaic/XLA compile for preprocessing.

Energy model (round 5 -- the full loop-based nearest-neighbour model)
=====================================================================

Free energies in kcal/mol at 37C, Boltzmann-weighted with kT = 0.6163.
A secondary structure decomposes uniquely into loops; its energy is the
sum of:

* **Hairpin** closed by (i, j), loop size ``u = j-i-1 >= 3``:
  ``HP_INIT(u)`` (Turner 2004 initiation table for u <= 30, Jacobson-
  Stockmayer extrapolation ``HP_INIT(30) + 1.07856*ln(u/30)`` beyond)
  + terminal AU/GU penalty of the closing pair
  + a first-mismatch bonus for u >= 4 (approximation: -1.3 for G.A/A.G,
  -0.8 for U.U, -0.4 otherwise -- the shape of the mismatchH table,
  not its 300 tabulated entries).
* **Stack** ((i,j) on (i+1,j-1)): Turner 2004 WC 4x4 table (exact
  published values); wobble-involving entries are a documented
  simplified set (single-GU -1.5, GU-on-GU -0.2..-0.6).
* **Bulge** of size 1: ``BULGE_INIT(1)`` + the stack of the two closing
  pairs (the helix continues through a single bulge; no AU penalties).
* **Bulge** of size >= 2: ``BULGE_INIT(n)`` + AU penalty at both
  closing pairs.
* **Internal loop** n1 x n2 (both >= 1): 1x1 / 1x2 / 2x2 use flat
  approximations of the int11/int21/int22 tables (0.5 / 2.0 / 1.4);
  larger loops use ``INT_INIT(n1+n2)`` + Ninio asymmetry
  ``min(3.0, 0.6*|n1-n2|)``; all plus AU penalties at both closing
  pairs.  Loops with n1+n2 > MAXLOOP = 30 are not generated (ViennaRNA
  applies the same cap).
* **Multiloop**: affine ``a + b*(branches) + c*(unpaired)`` with
  a = 3.40 (closing), b = 0.40 per stem including the closing stem,
  c = 0.0 per unpaired base (Turner 2004 / ViennaRNA ML params), plus
  an AU penalty per AU/GU stem end (closing pair and each branch).
* **Exterior loop**: AU penalty per AU/GU branch closing pair.
* **Branch terminal stacking (dangles=2 proxy)**: every multiloop stem
  (branches and the closing stem) and every exterior-loop branch gains a
  flat -1.0 kcal/mol -- a stand-in for the dangle/terminal-mismatch
  tables that RNAfold's default ``dangles=2`` model always counts for
  helices in multiloops and the exterior loop.  Without this term,
  multi-branch folds (the tRNA cloverleaf) lose to single long helices
  (see the calibration note at ``_EXT_STEM_DG``).

The brute-force enumeration in ``tests/test_bpp_predict.py`` evaluates
exactly this specification on explicit structures (an independent
loop-decomposition evaluator) and pins Z and every pair probability.

Recursions (McCaskill with multiloops)
======================================

    Qb(i,j) = hairpin(i,j)
            + sum_{interior (k,l)} e^{-Eint(i,j,k,l)/kT} Qb(k,l)
            + e^{-(a+b+AU(i,j))/kT} sum_u Qm(i+1,u-1) Qm1(u,j-1)
    Qm1(i,j) = Qm1(i,j-1) e^{-c/kT} + Qb(i,j) e^{-(b+AU(i,j))/kT}
    Qm(i,j)  = sum_u [e^{-c(u-i)/kT} + Qm(i,u-1)] Qm1(u,j)
    E(t)     = E(t-1) + sum_k E(k) Qb(k,t-1) e^{-AU(k,t-1)/kT}   (exterior)

All arrays live in *scaled linear space*: a value covering L bases is
divided by s^L, with ln(s) chosen (and retried on over/underflow) so
float64 never leaves its exponent range -- ViennaRNA's own scaling
approach (pf.c).  The outside pass is the mechanical adjoint of the
inside ops, processed span-descending with push-style rank-1 updates
onto strided views, so the whole inside+outside stays O(n^3) with
O(MAXLOOP^2 n^2) for the interior sums.  p(i,j) = Qb(i,j)*adjQb(i,j)/Z
(the scale factors cancel exactly).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
from numpy.lib.stride_tricks import as_strided

MIN_HAIRPIN = 3   # unpaired bases enclosed by a hairpin pair (ViennaRNA TURN)
MAXLOOP = 30      # max interior-loop size n1+n2 (ViennaRNA MAXLOOP)
KT37 = 0.6163     # kcal/mol at 37C

#: canonical pair types by (5' base, 3' base) Rna5 rank: AU CG GC UA GU UG
PAIR_TYPES = ((0, 3), (1, 2), (2, 1), (3, 0), (2, 3), (3, 2))
_PTYPE = np.full((5, 5), -1, dtype=np.int32)
for _t, (_a, _b) in enumerate(PAIR_TYPES):
    _PTYPE[_a, _b] = _t

#: Turner 2004 stack dG37 (kcal/mol), [outer pair type, inner pair type]
#: for the stack 5'-X A ... B Y-3' with outer X.Y, inner A.B.  The WC 4x4
#: block is exact (10 published parameters + rotational symmetry
#: stack(p, q) == stack(rot q, rot p)); wobble-involving entries are the
#: simplified set described in the module docstring.
_GU = -1.5
_STACK_DG = np.array([
    #  AU     CG     GC     UA     GU     UG      (inner; rows = outer)
    [-0.93, -2.24, -2.08, -1.10,  _GU,   _GU],   # AU
    [-2.11, -3.26, -2.36, -2.08,  _GU,   _GU],   # CG
    [-2.35, -3.42, -3.26, -2.24,  _GU,   _GU],   # GC
    [-1.33, -2.35, -2.11, -0.93,  _GU,   _GU],   # UA
    [ _GU,   _GU,   _GU,   _GU,  -0.6,  -0.5],   # GU
    [ _GU,   _GU,   _GU,   _GU,  -0.2,  -0.6],   # UG
], dtype=np.float64)

#: terminal helix-end penalty (kcal/mol) per AU/UA/GU/UG closing pair
_TERM_AU = np.array([0.45, 0.0, 0.0, 0.45, 0.45, 0.45], dtype=np.float64)

#: Turner 2004 hairpin-loop initiation, sizes 3..30 (rna_turner2004.par)
_HAIRPIN_DG = np.array([
    5.40, 5.60, 5.70, 5.40, 6.00, 5.50, 6.40, 6.50, 6.60, 6.70, 6.78,
    6.86, 6.94, 7.01, 7.07, 7.13, 7.19, 7.25, 7.30, 7.35, 7.40, 7.44,
    7.49, 7.53, 7.57, 7.61, 7.65, 7.69,
])
#: Turner 2004 bulge initiation, sizes 1..30
_BULGE_DG = np.array([
    3.80, 2.80, 3.20, 3.60, 4.00, 4.40, 4.59, 4.70, 4.80, 4.90, 5.00,
    5.10, 5.19, 5.27, 5.34, 5.41, 5.48, 5.54, 5.60, 5.65, 5.71, 5.76,
    5.80, 5.85, 5.89, 5.94, 5.98, 6.02, 6.05, 6.09,
])
#: Turner 2004 internal-loop initiation, sizes 4..30 (1x1/1x2/2x2 special)
_INTERNAL_DG = np.array([
    1.10, 2.00, 2.00, 2.10, 2.30, 2.40, 2.50, 2.60, 2.70, 2.78, 2.86,
    2.94, 3.01, 3.07, 3.13, 3.19, 3.25, 3.30, 3.35, 3.40, 3.45, 3.49,
    3.53, 3.57, 3.61, 3.65, 3.69,
])
_LXC = 1.07856        # Jacobson-Stockmayer extrapolation coefficient
_NINIO = 0.60         # internal-loop asymmetry per unit
_NINIO_MAX = 3.00
_INT11_DG = 1.10      # flat approximations of the int11/int21/int22 tables
_INT21_DG = 2.20      # (typical WC-closed tabulated values)
_INT22_DG = 1.80
_ML_CLOSING = 3.40    # multiloop affine terms (ViennaRNA turner2004)
_ML_BRANCH = 0.40     # per stem, including the closing stem
_ML_UNPAIRED = 0.00
#: terminal-stacking proxy per multiloop/exterior BRANCH stem -- the
#: dangles=2 model (RNAfold's default) always counts dangle/mismatch
#: stabilisation for helices in multiloops and the exterior loop; without
#: it multi-branch folds (tRNA cloverleaf!) lose to single long helices.
#: -1.4 kcal/mol is a flat stand-in for the mismatch/dangle tables,
#: calibrated on true-structure recovery (yeast tRNA-Phe + the hold-out
#: generators): sweep -0.6/-1.0/-1.4/-1.8 gave tRNA cloverleaf
#: sensitivity 0.29/0.29/0.57/0.57 with hold-out recovery peaking at -1.4.
_EXT_STEM_DG = -1.40

#: hairpin first-mismatch bonus approximation (kcal/mol), 5x5 by Rna5 rank
#: of (first, last) unpaired loop bases; G.A / A.G and U.U are the strong
#: motifs of the mismatchH table (typical tabulated entries are around
#: -1.1, the strong motifs -1.5..-2.3)
_HP_MM_DG = np.full((5, 5), -1.10)
_HP_MM_DG[2, 0] = _HP_MM_DG[0, 2] = -1.80   # G.A / A.G
_HP_MM_DG[3, 3] = -1.40                     # U.U
_HP_MM_DG[4, :] = 0.0
_HP_MM_DG[:, 4] = 0.0                       # N mismatches: no bonus

# ---- derived Boltzmann tables (kT units) ----
_ESTACK = np.exp(-_STACK_DG / KT37)            # [6, 6]
_EHP_MM = np.exp(-_HP_MM_DG / KT37)            # [5, 5]
_AU_KT = _TERM_AU / KT37                       # [6]
_EB1_STACK = np.exp(-(_BULGE_DG[0] + _STACK_DG) / KT37)  # bulge1 + stack
_ESTEM = math.exp(-_EXT_STEM_DG / KT37)        # dangles=2 branch proxy
#: per multiloop branch stem (incl. the d2 terminal-stacking proxy)
_EB = math.exp(-(_ML_BRANCH + _EXT_STEM_DG) / KT37)
#: multiloop closing stem (affine closing + its branch term + d2 proxy)
_CML = math.exp(-(_ML_CLOSING + _ML_BRANCH + _EXT_STEM_DG) / KT37)
_EC_KT = _ML_UNPAIRED / KT37                   # per multiloop unpaired base


def _interior_combos():
    """[(d1, d2, Boltzmann factor)] for every interior-loop geometry except
    the three per-cell-coefficient specials (stack, bulge-of-1): d1/d2 are
    the unpaired counts on each side, the factor is exp(-E_len_asym/kT)
    (closing-pair AU penalties ride separately on the eau matrices).
    Grouped by total size so the diagonal sweep can stop early."""
    by_total: list = [[] for _ in range(MAXLOOP + 1)]
    for total in range(2, MAXLOOP + 1):
        for d1 in range(0, total + 1):
            d2 = total - d1
            if (d1, d2) in ((0, 0), (0, 1), (1, 0)):
                continue
            if d1 == 0 or d2 == 0:
                e = _BULGE_DG[total - 1]
            elif d1 == 1 and d2 == 1:
                e = _INT11_DG
            elif (d1, d2) in ((1, 2), (2, 1)):
                e = _INT21_DG
            elif d1 == 2 and d2 == 2:
                e = _INT22_DG
            else:
                e = (_INTERNAL_DG[min(total, MAXLOOP) - 4]
                     + min(_NINIO_MAX, _NINIO * abs(d1 - d2)))
            by_total[total].append((d1, d2, math.exp(-e / KT37)))
    return by_total


_COMBOS_BY_TOTAL = _interior_combos()

_BIG = 1e250
_SMALL = 1e-250


class _RescaleNeeded(Exception):
    def __init__(self, new_ln_s: float):
        super().__init__(f"rescale to ln_s={new_ln_s}")
        self.new_ln_s = new_ln_s


def _sv(M: np.ndarray, flat0: int, si: int, st: int, ni: int, nt: int):
    """Strided 2-D view into square matrix ``M``: V[i, t] = flat[flat0 +
    i*si + t*st] (strides in elements).  Used for the triangular reads and
    rank-1 pushes of the O(n^3) reductions."""
    it = M.itemsize
    flat = M.reshape(-1)
    return as_strided(flat[flat0:], shape=(ni, nt), strides=(si * it, st * it))


def _dv(M: np.ndarray, d: int):
    """1-D writable view of diagonal span ``d``: V[i] = M[i, i+d]."""
    n = M.shape[0]
    it = M.itemsize
    return as_strided(M.reshape(-1)[d:], shape=(n - d,),
                      strides=((n + 1) * it,))


def _hairpin_kt(n: int) -> np.ndarray:
    """Hairpin initiation in kT for loop sizes 0..n (inf below 3)."""
    out = np.full(n + 1, np.inf)
    hi = min(n, 30)
    if hi >= 3:
        out[3:hi + 1] = _HAIRPIN_DG[:hi - 2] / KT37
    if n > 30:
        sizes = np.arange(31, n + 1, dtype=np.float64)
        out[31:] = (_HAIRPIN_DG[-1] + _LXC * np.log(sizes / 30.0)) / KT37
    return out


def _inside_outside(enc: np.ndarray, ln_s: float):
    """One scaled inside+outside pass; returns (probs [n,n] upper-tri,
    log Z).  Raises _RescaleNeeded when float64 range is exceeded."""
    n = int(enc.shape[0])
    pt = _PTYPE[enc[:, None], enc[None, :]]               # [n, n]
    ptc = np.clip(pt, 0, 5)
    eau = np.where(pt >= 0, np.exp(-_AU_KT[ptc]), 1.0)    # [n, n]
    spow = np.exp(-ln_s * np.arange(n + 2, dtype=np.float64))
    ecs = math.exp(-_EC_KT) * spow[1]                      # ML unpaired base
    ecspow = np.exp(-(_EC_KT + ln_s) * np.arange(n + 1, dtype=np.float64))
    hp_kt = _hairpin_kt(n)

    Qb = np.zeros((n, n))
    QbA = np.zeros((n, n))   # Qb * eau (branch form)
    Qm = np.zeros((n, n))
    Qm1 = np.zeros((n, n))

    # ---- inside, span ascending ----
    for d in range(MIN_HAIRPIN + 1, n):
        ld = n - d
        pt_d = _dv(pt, d)
        ok = pt_d >= 0
        eau_d = _dv(eau, d)
        # hairpin: init(size) + AU + first-mismatch bonus (size >= 4)
        size = d - 1
        hp = np.where(ok, math.exp(-hp_kt[size]) * spow[d + 1], 0.0)
        hp *= eau_d
        if size >= 4:
            hp = hp * _EHP_MM[enc[1:1 + ld], enc[d - 1:d - 1 + ld]]
        acc = hp
        # generic interior geometries: scalar coefficient x shifted inner
        # diagonal of QbA (inner AU inside QbA, outer applied after)
        gen = np.zeros(ld)
        max_total = min(MAXLOOP, d - 2 - (MIN_HAIRPIN + 1))
        for total in range(2, max_total + 1):
            din = d - total - 2
            coef_scale = spow[total + 2]
            src = _dv(QbA, din)
            for (d1, d2, ebz) in _COMBOS_BY_TOTAL[total]:
                gen += (ebz * coef_scale) * src[d1 + 1: d1 + 1 + ld]
        acc = acc + gen * eau_d
        # stack (0,0): per-cell pair-type coefficient, no AU
        if d - 2 >= MIN_HAIRPIN + 1:
            pin = _dv(pt, d - 2)[1:1 + ld]
            est = _ESTACK[ptc[np.arange(ld), np.arange(ld) + d],
                          np.clip(pin, 0, 5)]
            acc = acc + np.where(pin >= 0, est, 0.0) * spow[2] \
                * _dv(Qb, d - 2)[1:1 + ld]
        # bulge of 1 (keeps the closing stack, no AU)
        if d - 3 >= MIN_HAIRPIN + 1:
            qin = _dv(Qb, d - 3)
            pin3 = _dv(pt, d - 3)
            po = ptc[np.arange(ld), np.arange(ld) + d]
            for off in (1, 2):   # (d1,d2) = (0,1) then (1,0)
                pin = pin3[off:off + ld]
                eb1 = _EB1_STACK[po, np.clip(pin, 0, 5)]
                acc = acc + np.where(pin >= 0, eb1, 0.0) * spow[3] \
                    * qin[off:off + ld]
        # multiloop closing: cml * sum_u Qm(i+1,u-1) * Qm1(u,j-1)
        if d >= 11:
            w = d - 3                       # tau = u-i-2 in [0, d-4]
            wa = _sv(Qm, n + 1, n + 1, 1, ld, w)          # Qm[i+1, i+1+tau]
            wb = _sv(Qm1, 2 * n + d - 1, n + 1, n, ld, w)  # Qm1[i+2+tau, i+d-1]
            ml = np.einsum("it,it->i", wa, wb)
            acc = acc + (_CML * spow[2]) * eau_d * ml
        qb_d = np.where(ok, acc, 0.0)
        mx = qb_d.max() if ld else 0.0
        if not np.isfinite(mx) or mx > _BIG:
            bump = (math.log(mx) / (d + 1)
                    if np.isfinite(mx) and mx > 0 else 600.0 / (d + 1))
            raise _RescaleNeeded(ln_s + bump)
        _dv(Qb, d)[:] = qb_d
        _dv(QbA, d)[:] = qb_d * eau_d
        # Qm1(i, i+d) = Qm1(i, i+d-1)*ecs + QbA(i, i+d)*eb
        _dv(Qm1, d)[:] = _dv(Qm1, d - 1)[:ld] * ecs + _dv(QbA, d) * _EB
        # Qm(i, i+d) = sum_t ecspow[t]*Qm1[i+t, i+d]
        #            + sum_{t>=1} Qm[i, i+t-1]*Qm1[i+t, i+d]
        va = _sv(Qm1, d, n + 1, n, ld, d + 1)             # Qm1[i+t, i+d]
        term1 = va @ ecspow[:d + 1]
        vb = _sv(Qm, 0, n + 1, 1, ld, d)                  # Qm[i, i+t']
        vc = _sv(Qm1, n + d, n + 1, n, ld, d)             # Qm1[i+t'+1, i+d]
        term2 = np.einsum("it,it->i", vb, vc)
        _dv(Qm, d)[:] = term1 + term2

    # ---- exterior prefix/suffix ----
    E = np.zeros(n + 1)
    E[0] = 1.0
    for t in range(1, n + 1):
        j = t - 1
        val = E[t - 1] * spow[1]
        if j >= MIN_HAIRPIN + 1:
            val += _ESTEM * float(
                np.dot(E[:j - MIN_HAIRPIN], QbA[:j - MIN_HAIRPIN, j]))
        if val > _BIG:
            raise _RescaleNeeded(ln_s + math.log(val) / t)
        E[t] = val
    z = E[n]
    if z < _SMALL:
        shift = math.log(z) / n if z > 0.0 else -650.0 / n
        raise _RescaleNeeded(ln_s + shift)
    S = np.zeros(n + 1)
    S[n] = 1.0
    for t in range(n - 1, -1, -1):
        val = S[t + 1] * spow[1]
        if t <= n - (MIN_HAIRPIN + 2):
            val += _ESTEM * float(np.dot(QbA[t, t + MIN_HAIRPIN + 1:n],
                                         S[t + MIN_HAIRPIN + 2:n + 1]))
        S[t] = val

    # ---- outside (adjoint), span descending ----
    bQb = np.zeros((n, n))
    bQbA = np.zeros((n, n))
    bQm = np.zeros((n, n))
    bQm1 = np.zeros((n, n))
    for d in range(n - 1, MIN_HAIRPIN, -1):
        ld = n - d
        # 1) bQm(d) is final: push to smaller bQm and to bQm1
        bqm_d = _dv(bQm, d).copy()
        if bqm_d.any():
            if d >= 1:
                tgt = _sv(bQm, 0, n + 1, 1, ld, d)         # bQm[i, i+tau]
                fac = _sv(Qm1, n + d, n + 1, n, ld, d)     # Qm1[i+tau+1, i+d]
                tgt += bqm_d[:, None] * fac
            tgtb = _sv(bQm1, d, n + 1, n, ld, d + 1)       # bQm1[i+tau, i+d]
            amat = np.empty((ld, d + 1))
            amat[:, :] = ecspow[None, :d + 1]
            if d >= 1:
                amat[:, 1:] += _sv(Qm, 0, n + 1, 1, ld, d)  # Qm[i, i+tau-1]
            tgtb += bqm_d[:, None] * amat
        # 2) bQm1(d) final: push the unpaired-base chain down one span
        bqm1_d = _dv(bQm1, d)
        if d >= 1:
            _dv(bQm1, d - 1)[:ld] += bqm1_d * ecs
        # 3) bQb(d): exterior + interior pulls + multiloop-branch source
        eau_d = _dv(eau, d)
        tot = _ESTEM * E[:ld] * S[d + 1:d + 1 + ld] * eau_d
        gen = np.zeros(ld)
        for total in range(2, MAXLOOP + 1):
            dout = d + total + 2
            if dout > n - 1:
                break
            coef_scale = spow[total + 2]
            src = _dv(bQbA, dout)           # len n - dout = ld - total - 2
            for (d1, d2, ebz) in _COMBOS_BY_TOTAL[total]:
                gen[d1 + 1: ld - d2 - 1] += (ebz * coef_scale) * src
        tot = tot + gen * eau_d
        if d + 2 <= n - 1:                  # enclosed by a stack
            src = _dv(bQb, d + 2)           # len ld - 2
            po = _dv(pt, d + 2)
            pk = ptc[np.arange(1, ld - 1), np.arange(1, ld - 1) + d]
            est = _ESTACK[np.clip(po, 0, 5), pk]
            tot[1:ld - 1] += np.where(po >= 0, est, 0.0) * spow[2] * src
        if d + 3 <= n - 1:                  # enclosed across a bulge of 1
            src = _dv(bQb, d + 3)           # len ld - 3
            po3 = _dv(pt, d + 3)
            for off in (2, 1):              # outer (d1,d2) = (1,0) / (0,1)
                pk = ptc[np.arange(off, off + ld - 3),
                         np.arange(off, off + ld - 3) + d]
                eb1 = _EB1_STACK[np.clip(po3, 0, 5), pk]
                tot[off:off + ld - 3] += np.where(po3 >= 0, eb1, 0.0) \
                    * spow[3] * src
        tot = tot + bqm1_d * eau_d * _EB
        # the inside masks Qb to canonical cells; the adjoint must carry the
        # same mask, or non-pairs (which still receive exterior adjoints)
        # would leak through the interior/multiloop pulls
        tot = np.where(_dv(pt, d) >= 0, tot, 0.0)
        mx = np.abs(tot).max() if ld else 0.0
        if not np.isfinite(mx) or mx > _BIG:
            raise _RescaleNeeded(ln_s - 0.25)
        _dv(bQb, d)[:] = tot
        _dv(bQbA, d)[:] = tot * eau_d
        # 4) push bQb(d)'s multiloop content to bQm / bQm1
        if d >= 11:
            w = d - 3
            wvec = tot * (_CML * spow[2]) * eau_d
            if wvec.any():
                t1 = _sv(bQm, n + 1, n + 1, 1, ld, w)       # bQm[I+1, I+1+tau]
                f1 = _sv(Qm1, 2 * n + d - 1, n + 1, n, ld, w)
                t1 += wvec[:, None] * f1
                t2 = _sv(bQm1, 2 * n + d - 1, n + 1, n, ld, w)
                f2 = _sv(Qm, n + 1, n + 1, 1, ld, w)
                t2 += wvec[:, None] * f2

    with np.errstate(invalid="ignore", over="ignore"):
        probs = Qb * bQb / z
    probs = np.clip(np.nan_to_num(probs, nan=0.0), 0.0, 1.0)
    return probs, math.log(z) + n * ln_s


def _log_partition_and_bpp(enc: np.ndarray):
    """(probs, logZ) with automatic scale retries (at most a handful: each
    retry re-estimates ln(s) from the observed over/underflow)."""
    ln_s = 0.6
    for _ in range(8):
        try:
            return _inside_outside(enc, ln_s)
        except _RescaleNeeded as e:
            new = e.new_ln_s
            # nudge past the boundary so the retry has headroom
            ln_s = new + (0.05 if new > ln_s else -0.05)
    raise RuntimeError("bpp scale estimation did not converge")


def basepair_probability_matrix(sequence: str) -> np.ndarray:
    """[L, L] symmetric base-pair probability matrix for one sequence."""
    from gpubench.reference.ribosum import encode_rna5

    encoded = encode_rna5(sequence)
    length = int(encoded.shape[0])
    if length < MIN_HAIRPIN + 2:
        return np.zeros((length, length), np.float32)
    probs, _ = _log_partition_and_bpp(encoded)
    probs = probs.astype(np.float32)
    probs = np.clip(probs + probs.T, 0.0, 1.0)  # upper-triangular input
    return probs


def basepair_probabilities(sequence: str) -> Dict[Tuple[int, int], float]:
    """Probabilities as a {(i, j): p} dict (i < j), analogous to ViennaRNA's
    ``bppm`` consumed at ``io.hpp:311-330``."""
    probs = basepair_probability_matrix(sequence)
    out: Dict[Tuple[int, int], float] = {}
    upper = np.triu_indices_from(probs, k=1)
    for i, j in zip(*upper):
        p = float(probs[i, j])
        if p > 0.0:
            out[(int(i), int(j))] = p
    return out

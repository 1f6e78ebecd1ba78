"""Host-side construction of the packed per-pair Lagrange model.

The reference builds per-edge priority queues and hash maps
(``reference/src/lagrange.hpp:229-310``).  The TPU-native layout is a
flat array of *directed dual variables*: one entry per ordered pair of
interacting alignment edges (l -> m), carrying

* ``dual_l`` / ``dual_m``: flat alignment-edge ids (a * LB + b),
* ``sscore``: the structural profit (``lagrange.hpp:289``),
* ``rev``: the index of the opposite direction (m -> l), which always exists
  because adjacency and the non-crossing predicate are symmetric.

On device, "max profit partner per edge" becomes a segment max over
``dual_l`` -- recompute beats incremental priority-queue surgery on a vector
machine (SURVEY §7).

Array order is **edge-major** (sorted by (l, m), the construction order of
the reference loop): entries of one alignment edge are contiguous, so the
device solver computes per-edge maxima with masked doubling scans instead of
scatter/gather round trips through the dense edge grid.  ``qperm`` carries
the static matching-queue order (-2*score, lineL, lineR --
``matching.hpp:149-151``; duals never enter the queue key) as a permutation,
so the device matching reads its candidates presorted without a per-iteration
sort.  Order only affects internal dual numbering, never results (ties are
resolved by partner edge id, not dual id).
"""

from __future__ import annotations

import ctypes
import os
import threading
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from lara_tpu_torch.io.records import RnaRecord
from lara_tpu_torch.params import Parameters
from lara_tpu_torch.scoring.ribosum import encode_rna5
from lara_tpu_torch.types import contact_weight_to_int, seq_scale_factor
from lara_tpu_torch.utils import log, timing


@dataclass
class PairModel:
    la: int
    lb: int
    seq_a: np.ndarray      # [la] int8 Rna5 ranks
    seq_b: np.ndarray
    active: np.ndarray     # [la, lb] bool (edge filter result)
    seq_score: np.ndarray  # [la, lb] int32 scaled sequence profits
    dual_l: np.ndarray     # [D] int32 (edge-major: sorted by (l, m))
    dual_m: np.ndarray     # [D] int32
    sscore: np.ndarray     # [D] int32
    rev: np.ndarray        # [D] int32
    qperm: np.ndarray      # [D] int32: queue position -> edge-major index
    #: float32 sequence-scale factor applied to seq_score (the driver
    #: re-derives seq_score on device from seq_a/seq_b + this scale)
    scale: float = 0.0


_ADJ_CACHE: dict = {}


def adjacency_arrays(record: RnaRecord, length: int, precise: bool):
    """Padded adjacency: partners [length, K] (pad -1) and weights [length, K].

    Weights carry the reference's int truncation (``Contact`` holds int32,
    ``data_types.hpp:70``) unless ``precise`` is set.

    Memoized per record object (records recur in ~N pairs of the all-pairs
    batch; the python edge loop dominated the host model build otherwise).
    """
    key = (id(record), length, precise)
    hit = _ADJ_CACHE.get(key)
    if hit is not None and hit[0] is record:
        return hit[1], hit[2]
    adj: List[List[Tuple[int, float]]] = [[] for _ in range(length)]
    for (i, j, w) in record.structure_edges:
        weight = float(w) if precise else float(contact_weight_to_int(w))
        adj[i].append((j, weight))
        adj[j].append((i, weight))
    k_max = max((len(a) for a in adj), default=0)
    k_max = max(k_max, 1)
    partners = np.full((length, k_max), -1, dtype=np.int32)
    weights = np.zeros((length, k_max), dtype=np.float32)
    for i, lst in enumerate(adj):
        for k, (j, w) in enumerate(lst):
            partners[i, k] = j
            weights[i, k] = w
    if len(_ADJ_CACHE) > 4096:
        _ADJ_CACHE.clear()
    _ADJ_CACHE[key] = (record, partners, weights)
    return partners, weights


def effective_balance(params: Parameters, identity: float) -> float:
    """The structural-score weight for one pair.

    ``-b <float>``: the reference's constant factor (``lagrange.hpp:289``).
    ``-b auto``: keyed on the pair's measured ``avSeqId`` -- the quantity
    the reference's edge filter already computes for ``-c``
    (``edge_filter.hpp:156-157``: optimal alignment score / 8192 /
    max(len)).  NOTE the scale: this is a Ribosum score RATE, not a match
    fraction -- identical sequences measure ~0.95, the ~70%-identity
    benchmark families 0.05-0.6, deeply diverged (~35%) families < 0.

    Calibration (benchmark/RESULTS.md round-5 balance sweeps):
    near-identical pairs are insensitive to balance (keep 1.0 for
    reference parity); at moderate identity the sequence signal is strong
    and predicted-structure noise dominates, so a light structural touch
    wins (0.25: committed families 0.985 SPS, hold-out 0.779 -- both
    their measured optima); once the sequence signal degrades the
    structural term must carry more despite its noise (0.5: low-identity
    families 0.803 vs 0.718 at 0.25).
    """
    if not params.balance_auto:
        return float(params.balance)
    if identity >= 0.8:
        return 1.0
    return 0.25 if identity >= 0.0 else 0.5


_NATIVE_BUILD = None
_NATIVE_LOCK = threading.Lock()


def _native_build():
    """ctypes handle to the C++ model_build library (None if unavailable),
    loaded once per process, even when the ``-j`` pool's workers ask
    first."""
    global _NATIVE_BUILD
    if _NATIVE_BUILD is None:
        with _NATIVE_LOCK:
            if _NATIVE_BUILD is None:
                _NATIVE_BUILD = _load_native_build()
    return _NATIVE_BUILD or None


def _load_native_build():
    """The library's handle, or False where ``LARA_NO_NATIVE_BUILD`` is set
    or it cannot be built or loaded; the reason for the NumPy build is
    logged at verbosity 1."""
    if os.environ.get("LARA_NO_NATIVE_BUILD"):
        return False
    try:
        from lara_tpu_torch.native import shared_library

        lib = ctypes.CDLL(shared_library("model_build"))
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.lara_build_model.restype = ctypes.c_int
        lib.lara_build_model.argtypes = [
            ctypes.c_int, ctypes.c_int, u8p,
            i32p, f32p, ctypes.c_int,
            i32p, f32p, ctypes.c_int,
            ctypes.c_float,
            i32p, i32p, i32p, i32p, i32p, ctypes.c_int,
        ]
    except Exception as exc:
        log(1, "   * native model build unavailable, NumPy build instead: "
               f"{exc!r}")
        return False
    return lib


def build_pair_model(
    rec_a: RnaRecord,
    rec_b: RnaRecord,
    params: Parameters,
    active: np.ndarray,
    opt_score: int,
) -> PairModel:
    """The ``Lagrange`` constructor body, given the edge-filter result:
    native C++ when the toolchain is available (it releases the GIL, so the
    driver's ``-j`` pool parallelises for real), NumPy otherwise.  Both are
    bit-identical (``tests/test_interactions_native.py``).  Timed as the
    phase "interaction build: pair" on the thread that runs it, and the
    native call alone as "interaction build: native call"."""
    with timing.phase("interaction build: pair"):
        return _build_pair_model(rec_a, rec_b, params, active, opt_score)


def _build_pair_model(rec_a, rec_b, params, active, opt_score) -> PairModel:
    seq_a = encode_rna5(rec_a.sequence).astype(np.int32)
    seq_b = encode_rna5(rec_b.sequence).astype(np.int32)
    la, lb = len(seq_a), len(seq_b)

    from lara_tpu_torch.types import av_seq_id

    identity = av_seq_id(opt_score, la, lb)
    scale = seq_scale_factor(params.sequence_scale, identity)
    balance = effective_balance(params, identity)
    mat = np.asarray(params.score_matrix, dtype=np.int32)[seq_a[:, None], seq_b[None, :]]
    seq_score = np.trunc(np.float32(scale) * mat.astype(np.float32)).astype(np.int32)

    pa, wa = adjacency_arrays(rec_a, la, params.precise_bpp)
    pb, wb = adjacency_arrays(rec_b, lb, params.precise_bpp)
    ka, kb = pa.shape[1], pb.shape[1]

    act = np.ascontiguousarray(active, dtype=bool)
    lib = _native_build()
    if lib is not None:
        # exact candidate upper bound: sum over active edges of deg_a * deg_b
        dega = (pa >= 0).sum(axis=1).astype(np.int64)
        degb = (pb >= 0).sum(axis=1).astype(np.int64)
        a_ids, b_ids = np.nonzero(act)
        cap = int((dega[a_ids] * degb[b_ids]).sum()) if len(a_ids) else 0
        out_l = np.empty(cap, np.int32)
        out_m = np.empty(cap, np.int32)
        out_s = np.empty(cap, np.int32)
        out_rev = np.empty(cap, np.int32)
        out_q = np.empty(cap, np.int32)
        d = 0
        if cap:
            args = (la, lb, act.astype(np.uint8).reshape(-1),
                    np.ascontiguousarray(pa, np.int32).reshape(-1),
                    np.ascontiguousarray(wa, np.float32).reshape(-1), ka,
                    np.ascontiguousarray(pb, np.int32).reshape(-1),
                    np.ascontiguousarray(wb, np.float32).reshape(-1), kb,
                    np.float32(balance),
                    out_l, out_m, out_s, out_rev, out_q, cap)
            with timing.phase("interaction build: native call"):
                d = lib.lara_build_model(*args)
        if d < 0:
            raise AssertionError("native model build failed (asymmetric table)")
        return PairModel(la, lb, seq_a, seq_b, act, seq_score,
                         out_l[:d].copy(), out_m[:d].copy(), out_s[:d].copy(),
                         out_rev[:d].copy(), out_q[:d].copy(),
                         scale=float(scale))

    return _build_pair_model_numpy(rec_a, rec_b, params, act, seq_score,
                                   seq_a, seq_b, pa, wa, pb, wb, scale,
                                   balance)


def _build_pair_model_numpy(rec_a, rec_b, params, act, seq_score,
                            seq_a, seq_b, pa, wa, pb, wb,
                            scale=0.0, balance=None) -> PairModel:
    """Vectorized NumPy mirror of the native model_build library."""
    la, lb = len(seq_a), len(seq_b)
    ka, kb = pa.shape[1], pb.shape[1]

    # enumerate candidates in edge-major, (head, tail)-contact order
    a_ids, b_ids = np.nonzero(act)
    e_count = len(a_ids)
    if e_count == 0:
        empty = np.zeros(0, dtype=np.int32)
        return PairModel(la, lb, seq_a, seq_b, act, seq_score,
                         empty, empty, empty, empty, empty,
                         scale=float(scale))

    # [E, KA, KB] candidate partner coordinates
    a2 = pa[a_ids][:, :, None]                      # [E, KA, 1]
    b2 = pb[b_ids][:, None, :]                      # [E, 1, KB]
    w_head = wa[a_ids][:, :, None]
    w_tail = wb[b_ids][:, None, :]
    a1 = a_ids[:, None, None]
    b1 = b_ids[:, None, None]

    valid = (a2 >= 0) & (b2 >= 0)
    a2c = np.clip(a2, 0, la - 1)
    b2c = np.clip(b2, 0, lb - 1)
    valid &= act[a2c, b2c]
    non_crossing = ((a1 < a2c) & (b1 < b2c)) | ((a2c < a1) & (b2c < b1))
    valid &= non_crossing

    flat_valid = valid.reshape(e_count, ka * kb)
    sel = np.nonzero(flat_valid.reshape(-1))[0]
    l_edge = (np.repeat(a_ids * lb + b_ids, ka * kb))[sel].astype(np.int32)
    m_edge = (a2c * lb + b2c).reshape(-1)[sel].astype(np.int32)

    # structScore = trunc(balance * (head + tail) / 2 * 8192) in float32
    if balance is None:
        balance = params.balance
    ssum = (w_head + w_tail).reshape(-1)[sel].astype(np.float32)
    sscore = np.trunc(
        np.float32(balance) * ssum / np.float32(2.0) * np.float32(8192.0)
    ).astype(np.int32)

    # enforce the edge-major invariant: sorted by (l, m) so each edge's
    # entries are one contiguous run (construction order is already l-major;
    # this also orders partners ascending within a run)
    order = np.lexsort((m_edge, l_edge))
    l_edge = l_edge[order]
    m_edge = m_edge[order]
    sscore = sscore[order]

    # reverse index: (m, l) always exists, found by binary search on (l, m)
    keys_lm = l_edge.astype(np.int64) * (la * lb) + m_edge
    keys_ml = m_edge.astype(np.int64) * (la * lb) + l_edge
    rev = np.searchsorted(keys_lm, keys_ml).astype(np.int32)
    assert np.array_equal(l_edge[rev], m_edge) and np.array_equal(m_edge[rev], l_edge), \
        "interaction table is not symmetric"

    # static matching-queue order as a permutation (see module docstring)
    qperm = np.lexsort((m_edge, l_edge, -2 * sscore.astype(np.int64))).astype(np.int32)

    return PairModel(la, lb, seq_a, seq_b, act, seq_score,
                     l_edge, m_edge, sscore, rev, qperm,
                     scale=float(scale))

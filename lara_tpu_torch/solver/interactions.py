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
import functools
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from lara_tpu_torch.io.records import RnaRecord
from lara_tpu_torch.params import Parameters
from lara_tpu_torch.scoring.ribosum import encode_rna5
from lara_tpu_torch.types import av_seq_id, contact_weight_to_int, \
    seq_scale_factor
from lara_tpu_torch.utils import log, timing


@dataclass
class PairModel:
    la: int
    lb: int
    seq_a: np.ndarray      # [la] int32 Rna5 ranks
    seq_b: np.ndarray
    active: np.ndarray     # [la, lb] bool (edge filter result)
    dual_l: np.ndarray     # [D] int32 (edge-major: sorted by (l, m))
    dual_m: np.ndarray     # [D] int32
    sscore: np.ndarray     # [D] int32
    rev: np.ndarray        # [D] int32
    qperm: np.ndarray      # [D] int32: queue position -> edge-major index
    #: float32 sequence-scale factor applied to seq_score (the one-device
    #: driver re-derives seq_score on device from seq_a/seq_b + this scale)
    scale: float = 0.0
    #: [nk, nk] int32 substitution matrix that seq_score is gathered from
    submat: Optional[np.ndarray] = field(default=None, repr=False)

    @functools.cached_property
    def seq_score(self) -> np.ndarray:
        """[la, lb] int32 scaled sequence profits, gathered on first read:
        ``trunc(float32(scale) * submat[seq_a, seq_b])`` (``getSeqScore``,
        ``lagrange.hpp:223-226``).  The packed upload never reads it;
        ``_model_rows`` (the tests' reference), the hybrid, the native
        baseline and the linear library score do."""
        mat = self.submat[self.seq_a[:, None], self.seq_b[None, :]]
        return np.trunc(np.float32(self.scale)
                        * mat.astype(np.float32)).astype(np.int32)


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
    loaded once per process, even when several threads ask first."""
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
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        lib.lara_build_chunk.restype = ctypes.c_int
        lib.lara_build_chunk.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            i32p, i32p,
            ptrs, ptrs, i32p,
            ptrs, ptrs, i32p,
            f32p, ctypes.c_int, i32p, f64p, ctypes.POINTER(ctypes.c_void_p),
        ]
        lib.lara_chunk_take.restype = None
        lib.lara_chunk_take.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_int64]
    except Exception as exc:
        log(1, "   * native model build unavailable, NumPy build instead: "
               f"{exc!r}")
        return False
    return lib


class _PairInputs(NamedTuple):
    """The scalar, per-pair part of the ``Lagrange`` constructor: encoded
    sequences, sequence scale, structural balance, padded adjacency."""

    seq_a: np.ndarray
    seq_b: np.ndarray
    scale: float
    balance: float
    pa: np.ndarray
    wa: np.ndarray
    pb: np.ndarray
    wb: np.ndarray


def _pair_inputs(rec_a: RnaRecord, rec_b: RnaRecord, params: Parameters,
                 opt_score: int) -> _PairInputs:
    seq_a = encode_rna5(rec_a.sequence).astype(np.int32)
    seq_b = encode_rna5(rec_b.sequence).astype(np.int32)
    la, lb = len(seq_a), len(seq_b)
    identity = av_seq_id(opt_score, la, lb)
    scale = seq_scale_factor(params.sequence_scale, identity)
    pa, wa = adjacency_arrays(rec_a, la, params.precise_bpp)
    pb, wb = adjacency_arrays(rec_b, lb, params.precise_bpp)
    return _PairInputs(seq_a, seq_b, float(scale),
                       effective_balance(params, identity), pa, wa, pb, wb)


def build_chunk(pairs: Sequence[Tuple[RnaRecord, RnaRecord]],
                params: Parameters, active: np.ndarray,
                opt_scores: Sequence[int], workers: int) -> List[PairModel]:
    """The ``Lagrange`` constructor body for every pair of a chunk, given
    the edge filter's ``active`` grid ``[B, >= la, >= lb]`` (pair k's
    cells at ``active[k, :la, :lb]``, read in place) and optimal scores.

    Native: one call into the model_build library builds every pair on
    ``min(workers, B)`` C++ threads with the interpreter's lock released;
    Python keeps the scalar work per pair and the models' views of the
    call's flat outputs.  The native library's per-pair seconds are booked
    as "interaction build: native call", and with the Python work around
    the call as "interaction build: pair", one count a pair each.
    NumPy (no toolchain, or ``LARA_NO_NATIVE_BUILD``): each pair built
    by the mirror on a pool of ``workers`` threads, each under the phase
    "interaction build: pair".  Both give the same models bit for bit
    (``tests/test_torch_model_build.py``)."""
    b = len(pairs)
    active = np.asarray(active, dtype=bool)
    if active.ndim != 3 or active.shape[0] != b:
        raise ValueError(f"active grid {active.shape} for {b} pairs")
    submat = np.asarray(params.score_matrix, dtype=np.int32)
    lib = _native_build()
    if lib is None:
        return _build_chunk_numpy(pairs, params, active, opt_scores,
                                  workers, submat)
    if b == 0:
        return []
    start = time.perf_counter()
    inputs = [_pair_inputs(rec_a, rec_b, params, int(opt))
              for (rec_a, rec_b), opt in zip(pairs, opt_scores)]
    la = np.array([len(x.seq_a) for x in inputs], np.int32)
    lb = np.array([len(x.seq_b) for x in inputs], np.int32)
    if la.max() > active.shape[1] or lb.max() > active.shape[2]:
        raise ValueError(f"active grid {active.shape} smaller than a pair "
                         f"({la.max()} x {lb.max()})")
    if active.strides[2] != 1:
        active = np.ascontiguousarray(active)

    def tables(name, dtype):
        keep = [np.ascontiguousarray(getattr(x, name), dtype) for x in inputs]
        return keep, (ctypes.c_void_p * b)(*(t.ctypes.data for t in keep))

    pa, pa_ptr = tables("pa", np.int32)
    wa, wa_ptr = tables("wa", np.float32)
    pb, pb_ptr = tables("pb", np.int32)
    wb, wb_ptr = tables("wb", np.float32)
    ka = np.array([t.shape[1] for t in pa], np.int32)
    kb = np.array([t.shape[1] for t in pb], np.int32)
    balance = np.array([x.balance for x in inputs], np.float32)
    counts = np.zeros(b, np.int32)
    seconds = np.zeros(b, np.float64)
    handle = ctypes.c_void_p()
    call = time.perf_counter()
    rc = lib.lara_build_chunk(
        b, active.ctypes.data, active.strides[0], active.strides[1], la, lb,
        pa_ptr, wa_ptr, ka, pb_ptr, wb_ptr, kb, balance, int(workers),
        counts, seconds, ctypes.byref(handle))
    call = time.perf_counter() - call
    if rc == -2:
        raise AssertionError("native model build failed (asymmetric table)")
    if rc:
        raise MemoryError(f"native model build failed ({rc})")
    total = int(counts.sum())
    try:
        flat = np.empty((5, total), np.int32)
    except MemoryError:
        lib.lara_chunk_take(handle, None, 0)
        raise
    lib.lara_chunk_take(handle, flat.ctypes.data, total)
    offsets = np.zeros(b + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    models = []
    for k, x in enumerate(inputs):
        lo, hi = offsets[k], offsets[k + 1]
        dual_l, dual_m, sscore, rev, qperm = flat[:, lo:hi]
        models.append(PairModel(int(la[k]), int(lb[k]), x.seq_a, x.seq_b,
                                active[k, : la[k], : lb[k]], dual_l, dual_m,
                                sscore, rev, qperm, scale=x.scale,
                                submat=submat))
    native = float(seconds.sum())
    timing.add("interaction build: native call", native, b)
    timing.add("interaction build: pair",
               native + (time.perf_counter() - start - call), b)
    return models


def _build_chunk_numpy(pairs, params, active, opt_scores, workers, submat):
    def build(k):
        rec_a, rec_b = pairs[k]
        with timing.phase("interaction build: pair"):
            x = _pair_inputs(rec_a, rec_b, params, int(opt_scores[k]))
            act = np.ascontiguousarray(
                active[k, : len(x.seq_a), : len(x.seq_b)])
            return _build_pair_model_numpy(x, act, submat)

    workers = min(int(workers), max(1, len(pairs)))
    if workers > 1:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            return list(pool.map(build, range(len(pairs))))
    return [build(k) for k in range(len(pairs))]


def build_pair_model(
    rec_a: RnaRecord,
    rec_b: RnaRecord,
    params: Parameters,
    active: np.ndarray,
    opt_score: int,
) -> PairModel:
    """One pair's model, given its ``[la, lb]`` edge-filter result: the
    chunk build (:func:`build_chunk`) of one pair on the calling thread."""
    return build_chunk([(rec_a, rec_b)], params,
                       np.asarray(active, dtype=bool)[None], [opt_score],
                       1)[0]


def _build_pair_model_numpy(x: _PairInputs, act: np.ndarray,
                            submat: np.ndarray) -> PairModel:
    """Vectorized NumPy mirror of the native model_build library."""
    seq_a, seq_b, pa, wa, pb, wb = x.seq_a, x.seq_b, x.pa, x.wa, x.pb, x.wb
    la, lb = len(seq_a), len(seq_b)
    ka, kb = pa.shape[1], pb.shape[1]

    # enumerate candidates in edge-major, (head, tail)-contact order
    a_ids, b_ids = np.nonzero(act)
    e_count = len(a_ids)
    if e_count == 0:
        empty = np.zeros(0, dtype=np.int32)
        return PairModel(la, lb, seq_a, seq_b, act,
                         empty, empty, empty, empty, empty,
                         scale=x.scale, submat=submat)

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
    ssum = (w_head + w_tail).reshape(-1)[sel].astype(np.float32)
    sscore = np.trunc(
        np.float32(x.balance) * ssum / np.float32(2.0) * np.float32(8192.0)
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

    return PairModel(la, lb, seq_a, seq_b, act,
                     l_edge, m_edge, sscore, rev, qperm,
                     scale=x.scale, submat=submat)

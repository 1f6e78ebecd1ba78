"""Single-thread native CPU baseline: the full per-pair solve in C++.

This is the project's defensible LaRA-2-equivalent performance anchor (the
reference binary cannot be built here -- empty vendored submodules).  One
call = one pair: C++ edge filter, C++ Gotoh + traceback per iteration, and
the native Lagrange bookkeeping (``lagrange_host.cpp``), mirroring one
scalar solver slot of ``reference/src/subgradient_solver.hpp:219-331``.
The interaction model is built by the vectorized NumPy constructor
(:func:`lara_tpu_torch.solver.interactions.build_pair_model`), which is at least
as fast as the reference's per-edge C++ loops (``lagrange.hpp:264-300``).

Results are asserted bit-identical to :mod:`reference_driver` in
``tests/test_baseline_native.py``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from lara_tpu_torch.io.records import RnaRecord
from lara_tpu_torch.native import shared_library
from lara_tpu_torch.params import Parameters
from lara_tpu_torch.scoring.ribosum import encode_rna5
from lara_tpu_torch.solver.reference_driver import PairResult
from lara_tpu_torch.types import f2i

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(
            shared_library("baseline",
                           extra_sources=("lagrange_host", "blossom")))
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.lara_baseline_edge_filter.restype = ctypes.c_int
        lib.lara_baseline_edge_filter.argtypes = [
            ctypes.c_int, ctypes.c_int, i32p, i32p, i32p, ctypes.c_int,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, u8p, i64p,
        ]
        lib.lara_baseline_solve.restype = ctypes.c_int
        lib.lara_baseline_solve.argtypes = [
            ctypes.c_int, ctypes.c_int, i32p, u8p,
            ctypes.c_int, i32p, i32p, i32p, i32p,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_int32, ctypes.c_int32,
            i32p, ctypes.c_int, i64p,
        ]
        _lib = lib
    return _lib


def edge_filter(seq_a: np.ndarray, seq_b: np.ndarray, submat: np.ndarray,
                go: int, ge: int, subopt_int: int) -> Tuple[np.ndarray, int]:
    """C++ ``generateEdges`` (``edge_filter.hpp:131-158``): returns
    (active bool [la, lb], optimal score)."""
    lib = _load()
    la, lb = len(seq_a), len(seq_b)
    submat = np.ascontiguousarray(submat, np.int32)
    active = np.zeros(la * lb, np.uint8)
    opt = np.zeros(1, np.int64)
    rc = lib.lara_baseline_edge_filter(
        la, lb,
        np.ascontiguousarray(seq_a, np.int32),
        np.ascontiguousarray(seq_b, np.int32),
        submat.reshape(-1), submat.shape[1],
        np.int32(go), np.int32(ge), np.int32(subopt_int), active, opt)
    if rc != 0:
        raise AssertionError("forward/backward optimal scores differ")
    return active.reshape(la, lb).astype(bool), int(opt[0])


def solve_pair(rec_a: RnaRecord, rec_b: RnaRecord, params: Parameters,
               seq_indices: Tuple[int, int]) -> PairResult:
    """Full native solve of one pair; same contract as
    :func:`reference_driver.solve_pair` (``rec_a`` is the longer sequence)."""
    from lara_tpu_torch.solver import interactions

    lib = _load()
    seq_a = encode_rna5(rec_a.sequence).astype(np.int32)
    seq_b = encode_rna5(rec_b.sequence).astype(np.int32)
    go, ge = int(params.gap_open_int), int(params.gap_extend_int)
    active, opt = edge_filter(seq_a, seq_b, params.score_matrix, go, ge,
                              int(f2i(params.suboptimal_diff)))
    model = interactions.build_pair_model(rec_a, rec_b, params, active, opt)

    la, lb = model.la, model.lb
    cap = min(la, lb)
    cols = np.zeros(3 * cap, np.int32)
    meta = np.zeros(4, np.int64)
    n = lib.lara_baseline_solve(
        la, lb,
        np.ascontiguousarray(model.seq_score, np.int32).reshape(-1),
        np.ascontiguousarray(model.active, np.uint8).reshape(-1),
        len(model.dual_l),
        np.ascontiguousarray(model.dual_l, np.int32),
        np.ascontiguousarray(model.dual_m, np.int32),
        np.ascontiguousarray(model.sscore, np.int32),
        np.ascontiguousarray(model.rev, np.int32),
        np.int32(go), np.int32(ge),
        int(params.num_iterations), int(params.max_nondecr_iterations),
        float(params.step_size_factor), int(params.matching),
        int(params.library_score_is_linear),
        np.int32(params.library_score_min), np.int32(params.library_score_max),
        cols, cap, meta)
    if n < 0:
        raise RuntimeError("native baseline solve failed")
    columns = [(int(cols[3 * i]), int(cols[3 * i + 1]), int(cols[3 * i + 2]))
               for i in range(n)]
    swap = seq_indices[0] > seq_indices[1]
    if swap:
        columns = [(b, a, w) for (a, b, w) in columns]
    return PairResult(
        seq_indices=(min(seq_indices), max(seq_indices)),
        columns=columns,
        score=int(meta[1]),
        iterations=int(meta[3]),
        best_upper=int(meta[2]),
        best_lower=int(meta[1]),
    )

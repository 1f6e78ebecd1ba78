"""ctypes binding for the native per-pair Lagrange bookkeeping engine."""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from lara_tpu_torch.native import shared_library

_lib = None


def _load():
    global _lib
    if _lib is None:
        # blossom.cpp is linked in for the -m 0 exact-matching branch
        lib = ctypes.CDLL(shared_library("lagrange_host",
                                         extra_sources=("blossom",)))
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.lara_lagrange_create.restype = ctypes.c_void_p
        lib.lara_lagrange_create.argtypes = [
            ctypes.c_int, ctypes.c_int, i32p, u8p,
            ctypes.c_int, i32p, i32p, i32p, i32p,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int,
        ]
        lib.lara_lagrange_step.restype = ctypes.c_int
        lib.lara_lagrange_step.argtypes = [
            ctypes.c_void_p, i32p, ctypes.c_int, ctypes.c_int32, ctypes.c_int32,
        ]
        lib.lara_lagrange_step_sparse.restype = ctypes.c_int
        lib.lara_lagrange_step_sparse.argtypes = [
            ctypes.c_void_p, i32p, ctypes.c_int, ctypes.c_int32, ctypes.c_int32,
            i32p, i32p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.lara_lagrange_result.restype = ctypes.c_int
        lib.lara_lagrange_result.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int32, ctypes.c_int32,
            i32p, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ]
        lib.lara_lagrange_destroy.restype = None
        lib.lara_lagrange_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class PairSolver:
    """One pair's Lagrange state living in C++; the PSSM is written in place
    into the caller-provided (possibly strided) int32 buffer."""

    def __init__(self, model, params, pssm_buffer: np.ndarray) -> None:
        lib = _load()
        assert pssm_buffer.dtype == np.int32
        assert pssm_buffer.shape[0] >= model.la and pssm_buffer.shape[1] >= model.lb
        assert pssm_buffer.strides[1] == 4  # row-major contiguous rows
        self._lib = lib
        self.la, self.lb = model.la, model.lb
        self._buf = pssm_buffer  # keep alive
        n_dual = len(model.dual_l)
        self._handle = lib.lara_lagrange_create(
            model.la, model.lb,
            np.ascontiguousarray(model.seq_score, np.int32).reshape(-1),
            np.ascontiguousarray(model.active, np.uint8).reshape(-1),
            n_dual,
            np.ascontiguousarray(model.dual_l, np.int32),
            np.ascontiguousarray(model.dual_m, np.int32),
            np.ascontiguousarray(model.sscore, np.int32),
            np.ascontiguousarray(model.rev, np.int32),
            int(params.num_iterations), int(params.max_nondecr_iterations),
            float(params.step_size_factor), int(params.matching),
            pssm_buffer.ctypes.data, pssm_buffer.strides[0] // 4,
        )
        if not self._handle:
            raise RuntimeError("lara_lagrange_create failed")

    def step(self, lines: np.ndarray, gap_score: int, upper: int) -> int:
        """lines: [n, 2] int32 ascending; returns 1 done, 0 continue."""
        lines = np.ascontiguousarray(lines, np.int32)
        status = self._lib.lara_lagrange_step(
            self._handle, lines.reshape(-1), lines.shape[0],
            np.int32(gap_score), np.int32(upper),
        )
        if status < 0:
            raise AssertionError(f"native lagrange invariant violated ({status})")
        return status

    def step_sparse(self, lines: np.ndarray, gap_score: int, upper: int,
                    upd_idx: np.ndarray, upd_val: np.ndarray
                    ) -> Tuple[int, int]:
        """Like :meth:`step` but records the changed PSSM entries into the
        caller-provided arrays.  Returns (status, n_updates); n_updates == -1
        means the capacity overflowed and the full PSSM must be re-uploaded."""
        import ctypes

        lines = np.ascontiguousarray(lines, np.int32)
        n_upd = ctypes.c_int(0)
        status = self._lib.lara_lagrange_step_sparse(
            self._handle, lines.reshape(-1), lines.shape[0],
            np.int32(gap_score), np.int32(upper),
            upd_idx, upd_val, upd_idx.shape[0], ctypes.byref(n_upd),
        )
        if status < 0:
            raise AssertionError(f"native lagrange invariant violated ({status})")
        return status, int(n_upd.value)

    def result(self, params) -> Tuple[List[Tuple[int, int, int]], int, int, int]:
        """Returns (columns, best_lower, best_upper, iterations)."""
        cap = min(self.la, self.lb)
        cols = np.zeros(3 * cap, np.int32)
        meta = np.zeros(4, np.int64)
        n = self._lib.lara_lagrange_result(
            self._handle, int(params.library_score_is_linear),
            np.int32(params.library_score_min), np.int32(params.library_score_max),
            cols, cap, meta,
        )
        if n < 0:
            raise RuntimeError("lagrange result capacity exceeded")
        columns = [
            (int(cols[3 * i]), int(cols[3 * i + 1]), int(cols[3 * i + 2]))
            for i in range(n)
        ]
        return columns, int(meta[1]), int(meta[2]), int(meta[3])

    def close(self) -> None:
        if self._handle:
            self._lib.lara_lagrange_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

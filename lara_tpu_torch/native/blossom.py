"""ctypes binding for the native exact maximum-weight matching.

Drop-in provider for :func:`lara_tpu_torch.solver.matching_ref.exact_matching`'s
fast path (the ``-m 0`` LEMON-equivalent).  Vertex ids are arbitrary ints
(line indices); they are compacted before the C call.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import numpy as np

from lara_tpu_torch.native import shared_library

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(shared_library("blossom"))
        lib.lara_max_weight_matching.restype = ctypes.c_longlong
        lib.lara_max_weight_matching.argtypes = [
            ctypes.c_int,
            ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ]
        _lib = lib
    return _lib


def max_weight_matching(
    edges: Sequence[Tuple[int, int, int]],
) -> Tuple[int, List[Tuple[int, int]]]:
    """Maximum-weight matching over ``(u, v, weight)`` edges.

    Returns ``(total_weight, matched_pairs)``; non-positive-weight edges can
    never improve a (non-perfect) maximum-weight matching and are dropped.
    """
    edges = [(u, v, w) for (u, v, w) in edges if w > 0 and u != v]
    if not edges:
        return 0, []
    vertex_ids = sorted({u for (u, _, _) in edges} | {v for (_, v, _) in edges})
    compact: Dict[int, int] = {vid: idx for idx, vid in enumerate(vertex_ids)}
    n = len(vertex_ids)
    us = np.array([compact[u] for (u, _, _) in edges], np.int32)
    vs = np.array([compact[v] for (_, v, _) in edges], np.int32)
    ws = np.array([w for (_, _, w) in edges], np.int64)
    mate = np.empty(n, np.int32)
    total = _load().lara_max_weight_matching(n, len(edges), us, vs, ws, mate)
    pairs = [
        (vertex_ids[v], vertex_ids[int(mate[v])])
        for v in range(n)
        if mate[v] > v
    ]
    return int(total), pairs

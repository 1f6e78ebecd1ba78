"""Core scalar types and the fixed-point policy of lara-tpu.

The reference engine (seqan/lara) computes all profit arithmetic in int32
fixed point with a scale factor of 8192 (``reference/src/data_types.hpp:66-78``).
Floats enter the computation only at well-defined conversion points, always as
C++ ``float`` (IEEE binary32) followed by an int conversion that truncates
toward zero.  This module centralises those conversion rules so that every
layer of lara-tpu (NumPy reference driver, JAX device solver, Pallas kernels)
reproduces bit-identical integers.

Conversion points replicated here:

* score-matrix / gap-cost setup: ``value * 8192.f`` then truncation
  (``parameters.hpp:303-314``),
* structural profit: ``balance * (head + tail) / 2 * 8192.f`` then truncation
  (``lagrange.hpp:289``),
* sequence score scaling: ``seqScale * matval`` then truncation
  (``lagrange.hpp:223-226``),
* subgradient step: float32 throughout, with the dual held in int32 and the
  update truncated back (``subgradient_solver.hpp:265-271``).
"""

from __future__ import annotations

import numpy as np

# int32 fixed-point scale: data_types.hpp:78
FACTOR2INT = np.float32(8192.0)

# data_types.hpp:77 -- int32 max / 3 * 2 with C++ integer division.
INFINITY = np.int32((2**31 - 1) // 3 * 2)  # 1431655764

# score.hpp:92 -- int32 lowest / 3 * 2, C++ division truncates toward zero:
# (-2147483648) / 3 == -715827882, * 2 == -1431655764.
PSSM_INIT = np.int32(-1431655764)


def f2i(value) -> np.int32:
    """float -> int32 fixed point: trunc(float32(value) * 8192.f).

    Mirrors the ``val * factor2int`` conversions in ``parameters.hpp:303-322``:
    single-precision multiply, then C++ float->int conversion (truncation
    toward zero).
    """
    return np.int32(np.trunc(np.float32(value) * FACTOR2INT))


def struct_score(balance, head, tail) -> np.int32:
    """Structural profit of a partner-edge pair in fixed point.

    ``lagrange.hpp:289``: ``balance * (head + tail) / 2 * factor2int`` where
    ``head``/``tail`` are the *int-truncated* contact probabilities (the
    reference stores contact weights in ``Contact = pair<int32, size_t>``,
    ``data_types.hpp:70``, so probabilities lose their fractional part when the
    contacts are extracted at ``lagrange.hpp:130-137``).
    """
    b = np.float32(balance)
    s = np.float32(np.int32(head) + np.int32(tail))
    return np.int32(np.trunc(b * s / np.float32(2.0) * FACTOR2INT))


def contact_weight_to_int(weight) -> np.int32:
    """Truncate a structure-graph edge weight to int32.

    The reference's ``Contact`` pair holds ``ScoreType`` (int32) as first
    element (``data_types.hpp:70``); ``extractContacts`` reads the double edge
    cargo into a C++ ``float`` (``lagrange.hpp:135``) and then narrows it into
    the int32 pair member, truncating toward zero.  We therefore round the
    double to binary32 first, then truncate.
    """
    return np.int32(np.trunc(np.float32(weight)))


def seq_scale_factor(sequence_scale, av_seq_id) -> np.float32:
    """``sequenceScaleFactor = params.sequenceScale * avSeqId + 1`` (lagrange.hpp:252)."""
    return np.float32(np.float32(sequence_scale) * np.float32(av_seq_id) + np.float32(1.0))


def av_seq_id(optimal_score, len_a, len_b) -> np.float32:
    """``edge_filter.hpp:156-157``: optScore / 8192.f / max(lenA, lenB)."""
    m = np.float32(max(int(len_a), int(len_b)))
    return np.float32(np.float32(np.int32(optimal_score)) / FACTOR2INT / m)

"""RIBOSUM sequence-scoring tables over the Rna5 alphabet (A, C, G, U, N).

The reference ships 510 static RIBOSUM tables (``reference/src/
rna_score_matrices.hpp``); only the Rna5 Ribosum65N family is ever used by
default (``parameters.hpp:308-316`` selects
``RnaScoringMatrixData_<float, seqan::Rna5, Ribosum65N>``, data at
``rna_score_matrices.hpp:3948-3969``).  lara-tpu keeps the default table and
loads any other matrix from a SeqAn-style score-matrix file via
:func:`load_score_matrix` (the ``-s`` flag), which covers all 510 variants
without baking megabytes of constants into the package.

Fixed-point conversion: each float entry is multiplied by 8192.f in single
precision and truncated toward zero (``parameters.hpp:310-314``).
"""

from __future__ import annotations

import numpy as np

from lara_tpu_torch.types import f2i

#: Rna5 alphabet ordering used throughout (SeqAn Rna5 rank order).
RNA5_ALPHABET = "ACGUN"

#: Ribosum65N over Rna5, row/col order A C G U N
#: (rna_score_matrices.hpp:3958-3967).
RIBOSUM65N_FLOAT = np.array(
    [
        [1.392427, -0.790206, -0.503302, -0.467629, -1.506506],
        [-0.790206, 0.838942, -1.506506, -0.294126, -1.506506],
        [-0.503302, -1.506506, 0.76724, -0.718789, -1.506506],
        [-0.467629, -0.294126, -0.718789, 0.874874, -1.506506],
        [-1.506506, -1.506506, -1.506506, -1.506506, -1.506506],
    ],
    dtype=np.float32,
)


def to_fixed(matrix_float: np.ndarray) -> np.ndarray:
    """Convert a float score matrix to int32 fixed point (x8192, truncated)."""
    out = np.empty(matrix_float.shape, dtype=np.int32)
    flat_in = matrix_float.reshape(-1)
    flat_out = out.reshape(-1)
    for idx in range(flat_in.size):
        flat_out[idx] = f2i(flat_in[idx])
    return out


def ribosum65n_fixed() -> np.ndarray:
    """The default 5x5 int32 sequence-score matrix."""
    return to_fixed(RIBOSUM65N_FLOAT)


def encode_rna5(sequence: str) -> np.ndarray:
    """Encode an RNA string into Rna5 ranks (A=0 C=1 G=2 U=3, other=N=4).

    SeqAn converts input through Iupac -> Rna5, mapping T to U and every
    ambiguity code to N (``io.hpp:170,196``).
    """
    table = np.full(256, 4, dtype=np.int8)
    for rank, char in enumerate(RNA5_ALPHABET):
        table[ord(char)] = rank
        table[ord(char.lower())] = rank
    for t_char in "Tt":
        table[ord(t_char)] = 3  # T -> U
    arr = np.frombuffer(sequence.encode("ascii"), dtype=np.uint8)
    return table[arr].astype(np.int8)


def load_score_matrix(path: str) -> np.ndarray:
    """Load a SeqAn score-matrix file as a float 5x5 Rna5 matrix.

    Format (seqan::loadScoreMatrix): comment lines start with ``#``; the first
    non-comment line holds the column alphabet; each subsequent line is
    ``<rowchar> <v0> <v1> ...``.  Rows/columns are mapped onto the Rna5
    alphabet; missing entries keep a large negative default.
    """
    with open(path, "r", encoding="utf-8") as handle:
        lines = [ln.rstrip("\n") for ln in handle]
    rows = [ln for ln in lines if ln.strip() and not ln.lstrip().startswith("#")]
    if not rows:
        raise ValueError(f"empty score matrix file: {path}")
    header = rows[0].split()
    matrix = np.full((5, 5), -1.506506, dtype=np.float32)
    rank = {c: i for i, c in enumerate(RNA5_ALPHABET)}
    col_ranks = [rank.get(c.upper().replace("T", "U"), 4) for c in header]
    for row in rows[1:]:
        parts = row.split()
        if not parts:
            continue
        row_char = parts[0].upper().replace("T", "U")
        if row_char not in rank:
            continue
        r = rank[row_char]
        for col_idx, value in enumerate(parts[1 : 1 + len(col_ranks)]):
            matrix[r, col_ranks[col_idx]] = np.float32(value)
    return matrix

"""Consistency-based progressive multiple sequence alignment from the
pairwise structural library.

The reference emits a T-Coffee library and delegates the MSA itself to the
external ``t_coffee -lib`` binary (``README.rst:105-121``, benchmark notebook
cells 5-9).  lara-tpu ships this stage natively so the full pipeline --
sequences -> pairwise structural alignments -> library -> MSA -> SPS/MCC --
runs without external tools:

* **Library**: the (pos1, pos2, weight) support lists per sequence pair,
  either in memory (:class:`lara_tpu_torch.io.writers.OutputLibrary`) or parsed
  from a ``.lib`` file (:func:`read_lib`).
* **Consistency transform**: T-Coffee's triplet extension -- the weight of
  aligning (s,i) with (t,j) is reinforced by every third sequence u whose
  library links (s,i)-(u,k) and (u,k)-(t,j) (Notredame 2000's scheme).
* **Guide tree**: UPGMA over normalized pairwise library scores.
* **Progressive profile alignment**: Needleman-Wunsch over profile columns,
  column-pair score = sum of (extended) library weights across member
  residues; gaps cost nothing, exactly like T-Coffee's default scheme where
  all signal lives in the library weights.

Everything is NumPy; profile merges are vectorized gathers over dense
per-pair weight matrices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

Pair = Tuple[int, int]


@dataclass
class Library:
    """Pairwise support: names, sequences and per-pair weighted residue links."""

    names: List[str]
    sequences: List[str]
    entries: Dict[Pair, List[Tuple[int, int, float]]]  # 0-based positions

    @property
    def n(self) -> int:
        return len(self.sequences)


def read_lib(filename: str) -> Library:
    """Parse a T-Coffee library file (the format written by ``printLib``,
    ``reference/src/io.hpp:387-404``)."""
    names: List[str] = []
    sequences: List[str] = []
    entries: Dict[Pair, List[Tuple[int, int, float]]] = {}
    current: Pair | None = None
    with open(filename) as handle:
        header = handle.readline()
        if "T-COFFEE_LIB_FORMAT_01" not in header:
            raise ValueError(f"{filename}: not a T-Coffee library")
        count = int(handle.readline())
        for _ in range(count):
            parts = handle.readline().split()
            names.append(parts[0])
            sequences.append(parts[2])
        for line in handle:
            line = line.strip()
            if not line or line.startswith("!"):
                continue
            if line.startswith("#"):
                a, b = line[1:].split()
                current = (int(a) - 1, int(b) - 1)
                entries.setdefault(current, [])
            else:
                p1, p2, w = line.split()
                assert current is not None
                entries[current].append((int(p1) - 1, int(p2) - 1, float(w)))
    return Library(names=names, sequences=sequences, entries=entries)


def from_output_library(outlib) -> Library:
    """Adapt an in-memory :class:`~lara_tpu_torch.io.writers.OutputLibrary`."""
    names = [r.name for r in outlib.records]
    sequences = [r.sequence for r in outlib.records]
    entries: Dict[Pair, List[Tuple[int, int, float]]] = {}
    for (ia, ib), columns, _score in outlib.sorted_entries:
        entries[(ia, ib)] = [
            (int(a), int(b), float(w)) for (a, b, w) in columns
        ]
    return Library(names=names, sequences=sequences, entries=entries)


def _weight_matrices(lib: Library) -> Dict[Pair, np.ndarray]:
    mats: Dict[Pair, np.ndarray] = {}
    for (ia, ib), columns in lib.entries.items():
        mat = np.zeros((len(lib.sequences[ia]), len(lib.sequences[ib])), np.float32)
        for (a, b, w) in columns:
            mat[a, b] += w
        mats[(ia, ib)] = mat
    return mats


def _get(mats: Dict[Pair, np.ndarray], s: int, t: int) -> np.ndarray | None:
    if (s, t) in mats:
        return mats[(s, t)]
    if (t, s) in mats:
        return mats[(t, s)].T
    return None


def extend_library(lib: Library, mats: Dict[Pair, np.ndarray]) -> Dict[Pair, np.ndarray]:
    """Triplet consistency extension: W'(s,t) += sum_u W(s,u) @ W(u,t),
    scaled so direct evidence keeps dominating (T-Coffee uses min over the
    two path legs; the matmul form is its dense-batch equivalent and maps to
    the MXU when run on device -- here NumPy BLAS)."""
    extended: Dict[Pair, np.ndarray] = {}
    n = lib.n
    for (s, t), direct in mats.items():
        acc = direct.astype(np.float64).copy()
        for u in range(n):
            if u == s or u == t:
                continue
            left = _get(mats, s, u)
            right = _get(mats, u, t)
            if left is None or right is None:
                continue
            # min(leg1, leg2) summed over u's residues ~ path support;
            # normalize by the max possible weight to keep scales stable
            acc += np.minimum(
                left[:, :, None], right[None, :, :]
            ).sum(axis=1) / max(1, n - 2)
        extended[(s, t)] = acc.astype(np.float32)
    return extended


def _upgma(similarity: np.ndarray) -> List[Tuple[int, int]]:
    """UPGMA merge order; returns list of (cluster_a, cluster_b) with new
    clusters numbered n, n+1, ..."""
    n = similarity.shape[0]
    active = {i: [i] for i in range(n)}
    sim = {(i, j): similarity[i, j] for i in range(n) for j in range(i + 1, n)}
    merges: List[Tuple[int, int]] = []
    next_id = n
    while len(active) > 1:
        (best_i, best_j), _ = max(
            sim.items(), key=lambda kv: (kv[1], -kv[0][0], -kv[0][1])
        )
        members = active[best_i] + active[best_j]
        del active[best_i], active[best_j]
        sim = {k: v for k, v in sim.items()
               if best_i not in k and best_j not in k}
        # average-linkage similarity of every surviving cluster vs the merge
        active[next_id] = members
        for other, other_members in active.items():
            if other == next_id:
                continue
            total = sum(
                similarity[x, y] for x in other_members for y in members
            )
            sim[(min(other, next_id), max(other, next_id))] = total / (
                len(other_members) * len(members)
            )
        merges.append((best_i, best_j))
        next_id += 1
    return merges


@dataclass
class Profile:
    """Alignment of a subset of sequences: positions[s, c] = residue index of
    sequence s in column c, or -1 for a gap."""

    seq_ids: List[int]
    positions: np.ndarray  # [len(seq_ids), ncols] int32


def _align_profiles(pa: Profile, pb: Profile,
                    mats: Dict[Pair, np.ndarray]) -> Profile:
    na, nb = pa.positions.shape[1], pb.positions.shape[1]
    score = np.zeros((na, nb), np.float32)
    for si, s in enumerate(pa.seq_ids):
        pos_a = pa.positions[si]
        for ti, t in enumerate(pb.seq_ids):
            mat = _get(mats, s, t)
            if mat is None:
                continue
            pos_b = pb.positions[ti]
            ga = pos_a >= 0
            gb = pos_b >= 0
            sub = mat[np.clip(pos_a, 0, None)[:, None],
                      np.clip(pos_b, 0, None)[None, :]]
            score += np.where(ga[:, None] & gb[None, :], sub, 0.0)

    # NW over columns, gap cost 0 (all signal in the consistency weights);
    # ties prefer diagonal, then consuming A -- deterministic output
    dp = np.zeros((na + 1, nb + 1), np.float32)
    move = np.zeros((na + 1, nb + 1), np.int8)  # 0 diag, 1 up (A), 2 left (B)
    for i in range(1, na + 1):
        move[i, 0] = 1
    for j in range(1, nb + 1):
        move[0, j] = 2
    for i in range(1, na + 1):
        diag = dp[i - 1, :-1] + score[i - 1]
        up = dp[i - 1, 1:]
        row = dp[i]
        mv = move[i]
        for j in range(1, nb + 1):
            d = diag[j - 1]
            u = up[j - 1]
            l = row[j - 1]
            if d >= u and d >= l:
                row[j] = d
                mv[j] = 0
            elif u >= l:
                row[j] = u
                mv[j] = 1
            else:
                row[j] = l
                mv[j] = 2
    # traceback
    cols: List[Tuple[int, int]] = []  # (colA or -1, colB or -1)
    i, j = na, nb
    while i > 0 or j > 0:
        m = move[i, j]
        if m == 0:
            cols.append((i - 1, j - 1))
            i -= 1
            j -= 1
        elif m == 1:
            cols.append((i - 1, -1))
            i -= 1
        else:
            cols.append((-1, j - 1))
            j -= 1
    cols.reverse()
    ncols = len(cols)
    out = np.full((len(pa.seq_ids) + len(pb.seq_ids), ncols), -1, np.int32)
    for c, (ca, cb) in enumerate(cols):
        if ca >= 0:
            out[: len(pa.seq_ids), c] = pa.positions[:, ca]
        if cb >= 0:
            out[len(pa.seq_ids):, c] = pb.positions[:, cb]
    return Profile(seq_ids=pa.seq_ids + pb.seq_ids, positions=out)


def align(lib: Library, extend: bool = True) -> List[Tuple[str, str]]:
    """Build the MSA; returns [(name, gapped_sequence)] in input order."""
    mats = _weight_matrices(lib)
    if extend and lib.n > 2:
        mats = extend_library(lib, mats)

    n = lib.n
    similarity = np.zeros((n, n), np.float64)
    for (s, t), mat in mats.items():
        norm = min(len(lib.sequences[s]), len(lib.sequences[t]))
        similarity[s, t] = similarity[t, s] = float(mat.sum()) / max(1, norm)

    profiles: Dict[int, Profile] = {
        i: Profile(seq_ids=[i],
                   positions=np.arange(len(lib.sequences[i]), dtype=np.int32)[None, :])
        for i in range(n)
    }
    merges = _upgma(similarity)
    next_id = n
    for (a, b) in merges:
        profiles[next_id] = _align_profiles(profiles.pop(a), profiles.pop(b), mats)
        next_id += 1
    final = profiles[next_id - 1]

    out: List[Tuple[str, str]] = [("", "")] * n
    for row, seq_id in enumerate(final.seq_ids):
        seq = lib.sequences[seq_id]
        gapped = "".join(
            seq[p] if p >= 0 else "-" for p in final.positions[row]
        )
        out[seq_id] = (lib.names[seq_id], gapped)
    return out


def write_fasta(msa: Sequence[Tuple[str, str]], target) -> None:
    for name, gapped in msa:
        target.write(f">{name}\n{gapped}\n")


def main(argv=None) -> int:
    import argparse
    import sys

    parser = argparse.ArgumentParser(
        description="Progressive consistency MSA from a T-Coffee pairwise library "
        "(native replacement for the reference pipeline's t_coffee -lib step)."
    )
    parser.add_argument("library", help="T-Coffee .lib file (lara-tpu -w output)")
    parser.add_argument("-o", "--output", default="", help="aligned fasta (default stdout)")
    parser.add_argument("--no-extend", action="store_true",
                        help="skip the triplet consistency extension")
    args = parser.parse_args(argv)
    lib = read_lib(args.library)
    msa = align(lib, extend=not args.no_extend)
    if args.output:
        with open(args.output, "w") as handle:
            write_fasta(msa, handle)
    else:
        try:
            write_fasta(msa, sys.stdout)
        except BrokenPipeError:  # e.g. piped into head
            pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

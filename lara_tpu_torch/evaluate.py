"""Alignment-quality evaluation: MCC and SPS.

Mirrors the benchmark harness of the reference C++ LaRA
(``benchmark/mcc_eval.py``, ``benchmark_tutorial.ipynb`` cells 11-13):

* :func:`mcc` -- Matthews correlation coefficient between the base-pair sets
  induced by consensus structures of a reference and a test alignment, with
  the reference script's exact confusion-matrix semantics
  (``mcc_eval.py:72-97``): per-sequence base pairs in sequence coordinates,
  ``tn`` as the pair-universe complement, zero-denominator guard.
* :func:`sps` -- sum-of-pairs score (the role ``compalignp`` plays in the
  reference pipeline): the fraction of reference-aligned residue pairs that
  the test alignment reproduces.

Consensus structures come from ``RNAalifold`` when available (reference
behavior, ``mcc_eval.py:25-26``); otherwise the built-in consensus folder is
used: per-sequence McCaskill base-pair probabilities (:mod:`lara_tpu_torch.
solver.bpp_predict`) averaged over alignment columns, then a maximum-
expected-accuracy Nussinov DP extracts the nested consensus structure.  No
Biopython dependency; MSA parsing is self-contained (fasta + clustal).

The port's copy of :mod:`lara_tpu.evaluate` (JAX-free numpy, the same
arithmetic), so that ``python -m lara_tpu_torch.evaluate`` scores an
alignment with nothing of the JAX package loaded.
"""

from __future__ import annotations

import math
import os
import shutil
import subprocess
from typing import Dict, List, Sequence, Tuple

import numpy as np

MIN_HAIRPIN = 3


# ---------------------------------------------------------------- MSA parsing

def read_msa(filename: str) -> List[Tuple[str, str]]:
    """[(name, gapped_seq)] from aligned fasta or clustal (.aln) files."""
    if filename.endswith(".aln"):
        return _read_clustal(filename)
    return _read_aligned_fasta(filename)


def _read_aligned_fasta(filename: str) -> List[Tuple[str, str]]:
    records: List[Tuple[str, List[str]]] = []
    with open(filename) as handle:
        for line in handle:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                records.append((line[1:].split()[0], []))
            elif records:
                records[-1][1].append(line)
    out = [(name, "".join(parts)) for name, parts in records]
    _check_aligned(out, filename)
    return out


def _read_clustal(filename: str) -> List[Tuple[str, str]]:
    chunks: Dict[str, List[str]] = {}
    order: List[str] = []
    with open(filename) as handle:
        for line in handle:
            if line.startswith(("CLUSTAL", "MUSCLE", "//")) or not line.strip():
                continue
            parts = line.split()
            if len(parts) < 2 or set(parts[1]) <= {"*", ":", ".", " "}:
                continue
            name, segment = parts[0], parts[1]
            if name not in chunks:
                chunks[name] = []
                order.append(name)
            chunks[name].append(segment)
    out = [(name, "".join(chunks[name])) for name in order]
    _check_aligned(out, filename)
    return out


def _check_aligned(records: Sequence[Tuple[str, str]], filename: str) -> None:
    if not records:
        raise ValueError(f"no sequences in {filename}")
    width = len(records[0][1])
    for name, seq in records:
        if len(seq) != width:
            raise ValueError(
                f"{filename}: sequence {name} has length {len(seq)} != {width}"
            )


def _is_gap(char: str) -> bool:
    return char in "-.~"


# --------------------------------------------------------- consensus folding

def parse_structure(structure: str) -> List[Tuple[int, int]]:
    """Paired column indexes from a dot-bracket string (mcc_eval.py:31-41)."""
    paired: List[Tuple[int, int]] = []
    stack: List[int] = []
    for idx, char in enumerate(structure):
        if char == "(":
            stack.append(idx)
        elif char == ")":
            paired.append((stack.pop(), idx))
    if stack:
        raise ValueError("unbalanced dot-bracket string")
    return paired


def rnaalifold_available() -> bool:
    return shutil.which("RNAalifold") is not None


def consensus_structure_rnaalifold(filename: str) -> str:
    """Reference path: consensus from the external RNAalifold binary
    (``mcc_eval.py:25-26``)."""
    proc = subprocess.run(
        ["RNAalifold", "--noPS", filename],
        capture_output=True,
        check=True,
        text=True,
    )
    return proc.stdout.split("\n")[1].split(" ")[0]


def consensus_structure_builtin(msa: Sequence[Tuple[str, str]]) -> str:
    """Built-in consensus: column-averaged per-sequence McCaskill BPPs +
    maximum-expected-accuracy extraction (nested, min hairpin 3)."""
    from lara_tpu_torch.solver import bpp_predict

    width = len(msa[0][1])
    mean_p = np.zeros((width, width), np.float64)
    for _name, gapped in msa:
        ungapped = "".join(c for c in gapped if not _is_gap(c))
        if len(ungapped) < MIN_HAIRPIN + 2:
            continue
        probs = bpp_predict.basepair_probability_matrix(ungapped)
        col_of = [idx for idx, c in enumerate(gapped) if not _is_gap(c)]
        pos = np.asarray(col_of)
        ii, jj = np.triu_indices(len(ungapped), k=1)
        mean_p[pos[ii], pos[jj]] += probs[ii, jj]
    mean_p /= len(msa)

    # MEA/Nussinov over mean probabilities: maximize total paired probability.
    # score[i][j+1] = best over interval [i..j]; inner split vectorized over k.
    score = np.zeros((width + 1, width + 1), np.float64)
    choice = np.full((width, width), -1, np.int32)  # -1 = j unpaired
    for span in range(MIN_HAIRPIN + 1, width):
        for i in range(0, width - span):
            j = i + span
            best = score[i][j]  # j unpaired: interval [i..j-1]
            pick = -1
            ks = np.arange(i, j - MIN_HAIRPIN)
            pk = mean_p[ks, j]
            usable = pk > 0.003
            if usable.any():
                vals = score[i, ks] + pk + score[ks + 1, j]
                vals = np.where(usable, vals, -1.0)
                kbest = int(np.argmax(vals))
                if vals[kbest] > best + 1e-12:
                    best = float(vals[kbest])
                    pick = int(ks[kbest])
            score[i][j + 1] = best
            choice[i, j] = pick
    structure = ["."] * width
    stack = [(0, width - 1)]
    while stack:
        i, j = stack.pop()
        if j - i <= MIN_HAIRPIN:
            continue
        k = choice[i, j]
        if k < 0:
            stack.append((i, j - 1))
        else:
            structure[k] = "("
            structure[j] = ")"
            if k > i:
                stack.append((i, k - 1))
            stack.append((k + 1, j - 1))
    return "".join(structure)


def consensus_structure(filename: str, mode: str = "auto") -> Tuple[List[Tuple[str, str]], str]:
    msa = read_msa(filename)
    if mode == "rnaalifold" or (mode == "auto" and rnaalifold_available()):
        structure = consensus_structure_rnaalifold(filename)
        if len(structure) != len(msa[0][1]):
            raise ValueError("RNAalifold structure length mismatch")
    else:
        structure = consensus_structure_builtin(msa)
    return msa, structure


# ------------------------------------------------------------------ metrics

def to_seq_pos(aligned_seq: str, basepairs: Sequence[Tuple[int, int]]):
    """Column pairs -> sequence-position pairs, dropping any pair with a gap
    in this sequence (``mcc_eval.py:45-54``)."""
    pos: List[object] = []
    idx = 0
    for char in aligned_seq:
        if _is_gap(char):
            pos.append(None)
        else:
            pos.append(idx)
            idx += 1
    return [
        (pos[x], pos[y])
        for x, y in basepairs
        if pos[x] is not None and pos[y] is not None
    ]


def mcc_from_pairs(
    ref_msa: Sequence[Tuple[str, str]],
    ref_pairs: Sequence[Tuple[int, int]],
    test_msa: Sequence[Tuple[str, str]],
    test_pairs: Sequence[Tuple[int, int]],
) -> float:
    """Confusion-matrix MCC with the reference's semantics
    (``mcc_eval.py:72-97``); sequences are matched by order."""
    tp = fp = fn = tn = 0
    for (_, ref_seq), (_, test_seq) in zip(ref_msa, test_msa):
        ref_set = set(to_seq_pos(ref_seq, ref_pairs))
        test_set = set(to_seq_pos(test_seq, test_pairs))
        l_tp = len(test_set & ref_set)
        l_fp = len(test_set - ref_set)
        l_fn = len(ref_set - test_set)
        seq_len = sum(1 for c in ref_seq if not _is_gap(c))
        l_tn = seq_len * (seq_len - 1) // 2 - l_tp - l_fp - l_fn
        tp += l_tp
        fp += l_fp
        fn += l_fn
        tn += l_tn
    if (tp + fp) == 0 or (tp + fn) == 0 or (tn + fp) == 0 or (tn + fn) == 0:
        return float(tp * tn - fp * fn)
    return (tp * tn - fp * fn) / math.sqrt(
        (tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)
    )


def mcc(ref_file: str, test_file: str, consensus: str = "auto") -> float:
    ref_msa, ref_struct = consensus_structure(ref_file, consensus)
    test_msa, test_struct = consensus_structure(test_file, consensus)
    return mcc_from_pairs(
        ref_msa, parse_structure(ref_struct), test_msa, parse_structure(test_struct)
    )


def _aligned_pairs(msa: Sequence[Tuple[str, str]]):
    """All reference residue pairs: {((seq_a, pos_a), (seq_b, pos_b))} for
    residues of different sequences sharing one alignment column."""
    by_name = {}
    columns: List[List[Tuple[int, int]]] = []
    width = len(msa[0][1])
    counters = [0] * len(msa)
    for col in range(width):
        members = []
        for s, (_name, seq) in enumerate(msa):
            if not _is_gap(seq[col]):
                members.append((s, counters[s]))
                counters[s] += 1
        columns.append(members)
    pairs = set()
    for members in columns:
        for a in range(len(members)):
            for b in range(a + 1, len(members)):
                pairs.add((members[a], members[b]))
    return pairs


def sps(ref_file: str, test_file: str) -> float:
    """Sum-of-pairs score: |aligned residue pairs shared| / |reference pairs|
    (the quantity ``compalignp -r ref -t test`` reports in the reference
    pipeline, notebook cell 11).  Sequences are matched by order."""
    ref_msa = read_msa(ref_file)
    test_msa = read_msa(test_file)
    ref_pairs = _aligned_pairs(ref_msa)
    test_pairs = _aligned_pairs(test_msa)
    if not ref_pairs:
        return 0.0
    return len(ref_pairs & test_pairs) / len(ref_pairs)


def main(argv: Sequence[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="Alignment quality metrics (MCC / SPS) for structured RNA alignments."
    )
    parser.add_argument("metric", choices=("mcc", "sps"))
    parser.add_argument("reference")
    parser.add_argument("test")
    parser.add_argument(
        "--consensus",
        default="auto",
        choices=("auto", "rnaalifold", "builtin"),
        help="consensus-structure engine for MCC (auto: RNAalifold if in PATH)",
    )
    args = parser.parse_args(argv)
    if args.metric == "mcc":
        value = mcc(args.reference, args.test, args.consensus)
    else:
        value = sps(args.reference, args.test)
    print(f"{value:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The bench's workloads and its parity contract, for the port's own
scripts (``chip_smoke.py``) and tests.

Copies of ``bench.py``'s ``make_family``, ``make_long_family`` and
``_full_depth_ok`` (``bench.py:39,71,115``) on the port's own records and
structure predictor, so that the port's scripts import neither ``bench``
nor ``lara_tpu``; ``tests/test_torch_standalone.py`` holds them equal.
:func:`without_structure` is the port's own: the structure-free family of
``benchmark/PROFILE.md:208-212``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def make_family(n=12, length=72, seed=7):
    """Point-mutated tRNA family with McCaskill base-pair-probability edges
    (the shape of the reference's RNAfold-dotplot inputs, ``io.hpp:202-284``):
    soft, partially conflicting partner candidates exercise the full
    subgradient loop, unlike a fixed consensus structure."""
    from lara_tpu_torch.io.records import MIN_PROB, RnaRecord
    from lara_tpu_torch.solver import bpp_predict

    rng = np.random.default_rng(seed)
    base = list(
        "GCGGAUUUAGCUCAGUUGGGAGAGCGCCAGACUGAAGAUCUGGAGGUCCUGUGUUCGAUCCACAGAAUUCGC"
    )[:length]
    records = []
    for k in range(n):
        seq = list(base)
        for _ in range(int(rng.integers(2, 7))):
            seq[int(rng.integers(0, length))] = "ACGU"[rng.integers(0, 4)]
        sequence = "".join(seq)
        probs = bpp_predict.basepair_probabilities(sequence)
        # keep peaked pairs only (p > 0.05): the builtin flat-energy ensemble
        # over-generates weak pairs relative to RNAfold's Turner-model dot
        # plots (~1-3 partners/position above threshold), and the benchmark
        # should reflect the reference protocol's input shape
        edges = [
            (i, j, math.log(p / MIN_PROB))
            for (i, j), p in sorted(probs.items())
            if p > 0.05
        ]
        records.append(RnaRecord(name=f"trna{k}", sequence=sequence, bpp_edges=edges))
    return records


def make_long_family(n=2, length=1530, seed=47, mutations=None):
    """Point-mutated copies of a stem-scaffolded long molecule with sparse
    dotplot-style bpp edges (nested stems marching down the sequence plus
    competing weak partners) -- the 16S-rRNA input shape of BASELINE config 4
    and the reference's dense-matrix stress case (``edge_filter.hpp:73-75``,
    ``parameters.hpp:125-126``)."""
    from lara_tpu_torch.io.records import MIN_PROB, RnaRecord

    rng = np.random.default_rng(seed)
    stems = []
    pos = 10
    while pos + 120 < length:
        span = int(rng.integers(60, 110))
        n_bp = int(rng.integers(6, 12))
        for k in range(n_bp):
            stems.append((pos + k, pos + span - k))
        pos += span + int(rng.integers(10, 30))
    bases = "ACGU"
    comp = {"A": "U", "C": "G", "G": "C", "U": "A"}
    seq = [bases[rng.integers(0, 4)] for _ in range(length)]
    for (i, j) in stems:
        seq[j] = comp[seq[i]]
    if mutations is None:
        mutations = max(4, length // 25)
    records = []
    for k in range(n):
        s = list(seq)
        if k:  # first record keeps the scaffold
            for _ in range(mutations):
                s[int(rng.integers(0, length))] = bases[rng.integers(0, 4)]
        edges = []
        for (i, j) in stems:
            p = float(rng.uniform(0.2, 0.95))
            edges.append((i, j, math.log(p / MIN_PROB)))
            if rng.random() < 0.3:  # competing weak partner
                j2 = min(length - 1, j + int(rng.integers(1, 4)))
                p2 = float(rng.uniform(0.05, 0.15))
                edges.append((i, j2, math.log(p2 / MIN_PROB)))
        edges.sort()
        records.append(RnaRecord(name=f"long{k}", sequence="".join(s),
                                 bpp_edges=edges))
    return records


def without_structure(records):
    """Copies of ``records`` with their base-pair edges removed: the
    structure-free family (``benchmark/PROFILE.md:208-212``), whose pairs
    have no dual entry, so every lane's bounds meet in its first
    iteration."""
    return [dataclasses.replace(r, bpp_edges=[]) for r in records]


def full_depth_ok(dev, columns, best_lower, best_upper, iterations):
    """One definition of the full-depth parity contract (shared by the
    300nt-golden, 16S-B=1, and batched-16S gates): byte-equal columns and
    equal bounds AND trajectory length."""
    return ([list(c) for c in dev.columns] == [list(c) for c in columns]
            and dev.best_lower == best_lower
            and dev.best_upper == best_upper
            and dev.iterations == iterations)

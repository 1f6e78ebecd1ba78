"""The one generator of the benchmark's traffic: a pool of RNA records made
from the run's seed in set-up, and the closed loop's family jobs drawn from
it.  A traffic mix is a data file beside this module (``<name>.json``) and a
configuration a data file under ``gpubench/configs/``; this module reads
both and holds no parameter of its own.  A configuration's
``generator.kind`` names the maker of its pool: ``trna_family`` and
``long_family`` are built in, any other kind is the file
``generators/<kind>.py`` beside this module (:func:`make_pool`).

:func:`make_family` and :func:`make_long_family` are frozen copies of the
port's ``lara_tpu_torch/workloads.py`` (themselves copies of ``bench.py``'s),
with two additions that leave their output unchanged: the McCaskill folds of
:func:`make_family` may run in worker processes, and
:func:`make_long_family` may draw its scaffold from a seed of its own, so
that a configuration fixes the molecule and the run's seed draws the
copies."""

from __future__ import annotations

import importlib.util
import math
import multiprocessing
import sys
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Iterator, List, Sequence

import numpy as np

from gpubench.reference.records import MIN_PROB, RnaRecord

#: where a generator kind that is not built in lives, ``<kind>.py``
GENERATORS = Path(__file__).resolve().parent / "generators"
#: yeast tRNA-Phe, the scaffold of ``bench.py``'s tRNA family
TRNA_BASE = ("GCGGAUUUAGCUCAGUUGGGAGAGCGCCAGACUGAAGAUCUGGAGGUCCUGUGUUCGAUCCACA"
             "GAAUUCGC")


def _peaked_edges(sequence: str, min_prob: float):
    from gpubench.traffic import bpp_predict

    probs = bpp_predict.basepair_probabilities(sequence)
    return [(i, j, math.log(p / MIN_PROB))
            for (i, j), p in sorted(probs.items()) if p > min_prob]


def make_family(n=12, length=72, seed=7, workers=1, min_prob=0.05):
    """Point-mutated tRNA family with McCaskill base-pair-probability edges
    of p > ``min_prob`` (the shape of the reference's RNAfold-dotplot
    inputs, ``io.hpp:202-284``); the folds run on ``workers`` spawned
    processes where that is more than one."""
    rng = np.random.default_rng(seed)
    base = list(TRNA_BASE)[:length]
    sequences = []
    for _ in range(n):
        seq = list(base)
        for _ in range(int(rng.integers(2, 7))):
            seq[int(rng.integers(0, length))] = "ACGU"[rng.integers(0, 4)]
        sequences.append("".join(seq))
    if workers > 1 and n > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=min(workers, n),
                                 mp_context=ctx) as pool:
            edges = list(pool.map(_peaked_edges, sequences,
                                  [min_prob] * n))
    else:
        edges = [_peaked_edges(s, min_prob) for s in sequences]
    return [RnaRecord(name=f"trna{k}", sequence=s, bpp_edges=e)
            for k, (s, e) in enumerate(zip(sequences, edges))]


def make_long_family(n=2, length=1530, seed=47, mutations=None,
                     scaffold_seed=None):
    """Point-mutated copies of a stem-scaffolded long molecule with sparse
    dotplot-style bpp edges (nested stems marching down the sequence plus
    competing weak partners): the 16S-rRNA input shape of BASELINE config 4
    (``edge_filter.hpp:73-75``).  With ``scaffold_seed`` the stems and the
    scaffold's sequence come from that seed and the copies from ``seed``;
    without it everything comes from ``seed``, as in the original."""
    rng = np.random.default_rng(seed)
    scaffold_rng = rng if scaffold_seed is None \
        else np.random.default_rng(scaffold_seed)
    stems = []
    pos = 10
    while pos + 120 < length:
        span = int(scaffold_rng.integers(60, 110))
        n_bp = int(scaffold_rng.integers(6, 12))
        for k in range(n_bp):
            stems.append((pos + k, pos + span - k))
        pos += span + int(scaffold_rng.integers(10, 30))
    bases = "ACGU"
    comp = {"A": "U", "C": "G", "G": "C", "U": "A"}
    seq = [bases[scaffold_rng.integers(0, 4)] for _ in range(length)]
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


def seeds(seed: int, count: int) -> List[int]:
    """``count`` independent 63-bit seeds from the run's ``--seed`` (any
    whole number, negative ones included)."""
    state = np.random.SeedSequence(seed % 2**64).generate_state(count,
                                                                np.uint64)
    return [int(s >> np.uint64(1)) for s in state]


def make_pool(config: dict, traffic: dict, seed: int,
              workers: int = 1) -> List[RnaRecord]:
    """The run's pool of ``traffic["pool_size"]`` records of the
    configuration's kind.  A kind that is not built in is the file
    ``generators/<kind>.py``, whose ``make(n, generator, seed, workers)``
    returns the pool (``generator`` is the configuration's whole entry)."""
    gen = config["generator"]
    n = int(traffic["pool_size"])
    kind = gen["kind"]
    if kind == "trna_family":
        return make_family(n, int(gen["length"]), seed, workers,
                           float(gen["min_prob"]))
    if kind == "long_family":
        return make_long_family(n, int(gen["length"]), seed,
                                gen.get("mutations"), gen["scaffold_seed"])
    path = GENERATORS / f"{kind}.py"
    if not (kind.isidentifier() and not kind.startswith("_")
            and path.is_file()):
        raise ValueError(f"unknown generator kind {kind!r}")
    # loaded under its package's dotted name, so that a worker process can
    # import what the generator sends it
    name = f"{__package__}.generators.{kind}"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return list(module.make(n, gen, seed, workers))


def families(pool_size: int, family_size: int, seed: int
             ) -> Iterator[List[int]]:
    """The closed loop's jobs: each a family of ``family_size`` distinct
    records of the pool, in a drawn order, one after the other, without
    end.  The same seed gives the same jobs."""
    if not 2 <= family_size <= pool_size:
        raise ValueError(f"family of {family_size} from a pool of "
                         f"{pool_size}")
    rng = np.random.default_rng(seed)
    while True:
        yield [int(k) for k in rng.choice(pool_size, family_size,
                                          replace=False)]


def write_ebpseq(records: Sequence[RnaRecord], path: str) -> None:
    """``records`` in the lara-tpu ebpseq dialect (the port's
    ``io/writers.py::write_ebpseq``, frozen), the file both the program
    and the reference read."""
    out = [f"## S{k}: {r.name}\n" for k, r in enumerate(records, start=1)]
    out.append("## M1: base-pair probabilities\n")
    out.append("## F1: fixed structure\n")
    for k, rec in enumerate(records, start=1):
        out.append(f"# S{k} M1\n")
        by_pos: dict = {}
        for (i, j, p) in rec.bpp_edges:
            by_pos.setdefault(i, []).append((p, j))
            by_pos.setdefault(j, []).append((p, i))
        for pos, base in enumerate(rec.sequence):
            entries = by_pos.get(pos)
            cell = ",".join(f"{p:g}/{q + 1}" for (p, q) in entries) \
                if entries else "-"
            out.append(f"{pos + 1} {base} {cell}\n")
    with open(path, "w", encoding="utf-8") as handle:
        handle.write("".join(out))

"""The output check that decides ``correct``: what the window's family jobs
produced, against the plain reference run again from the same input files.
The reference is the package that the configuration's ``reference`` names
(``harness.reference_package``), passed here by its dotted name; its
``driver``, ``params``, ``records``, ``writer`` and ``control`` modules are
read from it.

Every completed job is checked for completeness: its results and its
library each hold every pair of the family exactly once.  A sample of the
window's pairs, drawn from the seed, is solved again by the reference in
worker processes, once the window has closed and the program's state is
freed; each sampled pair's columns, score, best bounds and iterations, and
its block of the library file, must equal the reference's, and so must the
library's header and footer of every job that holds a sampled pair.  Every
number compared is exact, so every limit is 0.

The control (``rounding="bfloat16"``) is the reference with its float32
subgradient step rounded to bfloat16, put in the program's place: its
answers are judged by the same comparison.
"""

from __future__ import annotations

import importlib
import multiprocessing
import os
import re
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np

_BLOCK = re.compile(r"^# (\d+) (\d+)$", re.MULTILINE)


class Job(NamedTuple):
    """One completed family job of the window."""

    in_file: str
    out_file: str
    n_records: int
    results: list      # the program's PairResults (seq_indices, columns, ...)


class Answer(NamedTuple):
    columns: tuple
    score: int
    best_lower: int
    best_upper: int
    iterations: int


def answer_of(result) -> Answer:
    return Answer(tuple(tuple(int(x) for x in c) for c in result.columns),
                  int(result.score), int(result.best_lower),
                  int(result.best_upper), int(result.iterations))


def all_pairs(n: int) -> List[Tuple[int, int]]:
    return [(i, j) for i in range(n - 1) for j in range(i + 1, n)]


def unaccounted(job: Job, library: str) -> int:
    """Pairs of the family that the job's results or its library lack, or
    hold more than once, or that the family does not have."""
    expected = set(all_pairs(job.n_records))
    bad = 0
    for seen in ([tuple(r.seq_indices) for r in job.results],
                 [(int(i) - 1, int(j) - 1) for i, j in
                  _BLOCK.findall(library)]):
        bad += len(expected - set(seen)) + len(seen) - len(set(seen)) \
            + len(set(seen) - expected)
    return bad


def sample(jobs: Sequence[Job], count: int, seed: int
           ) -> List[Tuple[int, Tuple[int, int]]]:
    """``count`` (job index, pair) drawn from the seed among every pair of
    every job, without replacement (all of them where there are fewer)."""
    every = [(j, pair) for j, job in enumerate(jobs)
             for pair in all_pairs(job.n_records)]
    if not every:
        return []
    rng = np.random.default_rng(seed)
    picked = rng.choice(len(every), min(count, len(every)), replace=False)
    return [every[int(k)] for k in sorted(picked)]


# -- the reference's side, in worker processes ---------------------------

def _module(reference: str, name: str):
    """The module ``name`` of the reference package ``reference``."""
    return importlib.import_module(f"{reference}.{name}")


_RECORDS: Dict[Tuple[str, str], list] = {}


def _records(reference: str, path: str):
    if (reference, path) not in _RECORDS:
        _RECORDS.clear()
        _RECORDS[reference, path] = _module(reference,
                                            "records").read_ebpseq(path)
    return _RECORDS[reference, path]


def reference_answer(task) -> Answer:
    """Solve one pair ``(reference, in_file, (i, j), params, rounding)``
    with the reference package ``reference``: the pair oriented as the
    program orients it, longer sequence first
    (``subgradient_solver.hpp:112-120``)."""
    reference, path, (i, j), params, rounding = task
    store = _records(reference, path)
    a, b = (i, j) if len(store[i].sequence) >= len(store[j].sequence) \
        else (j, i)
    rnd = _module(reference, "control").to_bfloat16 \
        if rounding == "bfloat16" else np.float32
    result = _module(reference, "driver").solve_pair(
        store[a], store[b], _module(reference, "params").Parameters(**params),
        (a, b), rounding=rnd)
    return answer_of(result)


def reference_params(config: dict) -> dict:
    """The configuration's ``params`` that the reference reads."""
    keys = ("num_iterations", "max_nondecr_iterations", "step_size_factor",
            "matching", "suboptimal_diff", "balance", "sequence_scale",
            "gap_open", "gap_extend")
    return {k: config["params"][k] for k in keys if k in config["params"]}


def solve(tasks: list, workers: int) -> List[Answer]:
    """The reference's answers to ``tasks``, on ``workers`` spawned
    processes (here, where one)."""
    if workers <= 1 or len(tasks) <= 1:
        return [reference_answer(t) for t in tasks]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(workers, len(tasks)),
                             mp_context=ctx) as pool:
        return list(pool.map(reference_answer, tasks, chunksize=1))


def default_workers() -> int:
    return max(1, len(os.sched_getaffinity(0)))


def check(jobs: Sequence[Job], failed: int, config: dict, count: int,
          seed: int, workers: int, reference: str,
          control: bool = False) -> dict:
    """The numbers compared, each ``{"value", "limit"}``, and
    ``pairs_compared``, judged by the reference package ``reference``.
    With ``control``, also ``control_pairs_differing``: the sampled pairs
    on which the control's answers, in the program's place, differ from
    the reference's."""
    writer = _module(reference, "writer")
    read_ebpseq = _module(reference, "records").read_ebpseq

    missing = 0
    libraries = []
    for job in jobs:
        with open(job.out_file, encoding="utf-8") as handle:
            libraries.append(handle.read())
        missing += unaccounted(job, libraries[-1])
    picked = sample(jobs, count, seed)
    params = reference_params(config)
    tasks = [(reference, jobs[j].in_file, pair, params, None)
             for j, pair in picked]
    if control:
        tasks += [(reference, jobs[j].in_file, pair, params, "bfloat16")
                  for j, pair in picked]
    answers = solve(tasks, workers)
    truth = answers[:len(picked)]

    differing = 0
    split = {}
    for (j, pair), ref in zip(picked, truth):
        if j not in split:
            split[j] = writer.split(libraries[j])
        found = [r for r in jobs[j].results if tuple(r.seq_indices) == pair]
        differing += not (len(found) == 1 and answer_of(found[0]) == ref
                          and split[j][1].get(pair)
                          == [writer.block(pair, ref.columns)])
    heads_bad = sum(
        head != writer.header(read_ebpseq(jobs[j].in_file))
        or foot != writer.FOOTER for j, (head, _, foot) in split.items())
    numbers = {
        "jobs_failed": {"value": int(failed), "limit": 0},
        "pairs_unaccounted": {"value": int(missing), "limit": 0},
        "pairs_differing": {"value": int(differing), "limit": 0},
        "headers_differing": {"value": int(heads_bad), "limit": 0},
        "pairs_compared": len(picked),
    }
    if control:
        numbers["control_pairs_differing"] = {
            "value": sum(a != b for a, b in zip(answers[len(picked):],
                                                truth)),
            "limit": 0}
    return numbers


def passed(numbers: dict) -> bool:
    """Every number of the program's within its limit, and at least one
    pair compared."""
    return numbers["pairs_compared"] > 0 and all(
        v["value"] <= v["limit"] for k, v in numbers.items()
        if isinstance(v, dict) and not k.startswith("control_"))

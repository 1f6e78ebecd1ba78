"""Whole-program flow of the port: read inputs -> solve all pairs -> write
the library (``/root/reference/src/lara.cpp:44-61``).

Counterpart of :func:`lara_tpu.app.run`.  Pair enumeration
mirrors ``solve`` (``subgradient_solver.hpp:112-120``): every unordered pair
of input records, with the longer sequence first (ties keep the original
index order, per the ``>=`` comparison).
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Sequence, Tuple

import torch

from lara_tpu_torch.io.records import InputStorage
from lara_tpu_torch.io.writers import OutputLibrary
from lara_tpu_torch.parallel import mesh
from lara_tpu_torch.params import Parameters
from lara_tpu_torch.solver.reference_driver import PairResult
from lara_tpu_torch.utils import log, timing


def enumerate_pairs(store) -> List[Tuple[int, int]]:
    """All index pairs, longer sequence first; processed longest-first
    (the reference's length-sorted work queue, ``io.hpp:352-365``)."""
    pairs = []
    for idx_a in range(len(store) - 1):
        for idx_b in range(idx_a + 1, len(store)):
            if len(store[idx_a].sequence) >= len(store[idx_b].sequence):
                pairs.append((idx_a, idx_b))
            else:
                pairs.append((idx_b, idx_a))
    pairs.sort(key=lambda p: (-len(store[p[0]].sequence),
                              -len(store[p[1]].sequence)))
    return pairs


def load_input(params: Parameters) -> InputStorage:
    log(1, "2) Read input files...")
    return InputStorage(
        in_file=params.in_file,
        ref_file=params.ref_file,
        dotplot_files=params.dotplot_files,
        structure_scoring=params.structure_scoring,
        out_format=params.out_format,
        predict_structures=params.predict,
        threads=int(params.threads),
    )


class Run(NamedTuple):
    library: OutputLibrary  # every pair (of every host)
    results: List[PairResult]  # this host's pairs, in solve order


def run(params: Parameters, device: torch.device = None,
        devices: Sequence[torch.device] = None) -> Run:
    """Solve every pair of the input.  ``--backend device`` (the default)
    runs on ``devices``, else on ``[device]``, else on every device of this
    process (:func:`lara_tpu_torch.parallel.mesh.pair_devices`: each
    visible card, or the CPU under ``LARA_PLATFORM=cpu``), a chunk's lanes
    split over them; ``--backend reference`` runs the NumPy scalar mirror.
    With ``LARA_PROFILE=<dir>`` the solve is traced with ``torch.profiler``
    into ``<dir>``.

    Several hosts (``lara_tpu/app.py:96-166``): with the device backend and
    the coordinator variables set (:func:`mesh.distributed_init`), each
    process solves a strided share of the pairs, the results are gathered
    to every process, and process 0 alone writes the library and the
    ``--msa`` file.  The returned ``library`` holds every pair, and
    ``results`` this host's."""
    time_start = time.monotonic()
    timing.reset()
    multihost = False
    if params.backend == "device":
        try:
            multihost = mesh.distributed_init()
        except (RuntimeError, ValueError) as exc:
            log(1, f"   * torch.distributed unavailable ({exc}); single host")
    try:
        if params.backend == "device":
            devices = mesh.pair_devices(
                devices if devices is not None
                else None if device is None else [device])
        return _run(params, devices, multihost, time_start)
    finally:
        mesh.distributed_shutdown()


def _run(params: Parameters, devices, multihost: bool,
         time_start: float) -> Run:
    log(1, "1) Parse parameters...")
    with timing.phase("read input"):
        store = load_input(params)
    outlib = OutputLibrary(store, params.out_format)
    pairs = enumerate_pairs(store)
    if multihost:
        n_all = len(pairs)
        pairs = mesh.process_pair_shard(pairs)
        log(1, f"   * host shard: {len(pairs)}/{n_all} pairs")
    log(1, f"3) Solve {len(pairs)} structural alignments...")

    if params.backend == "reference":
        from lara_tpu_torch.solver import reference_driver

        solved = (reference_driver.solve_pair(store[ia], store[ib], params,
                                              (ia, ib))
                  for (ia, ib) in pairs)
    else:
        from lara_tpu_torch.solver import device_driver

        solved = device_driver.solve_all(store, pairs, params, devices)
    results = []
    with timing.maybe_trace(), timing.phase("solve"):
        for result in solved:
            if not multihost:
                outlib.add_alignment(result.seq_indices, result.columns,
                                     result.score)
            results.append(result)
        if multihost:
            with timing.phase("gather results (hosts)"):
                for (ia, ib, score, cols) in mesh.gather_results(
                        [(r.seq_indices[0], r.seq_indices[1], r.score,
                          r.columns) for r in results]):
                    outlib.add_alignment((ia, ib), cols, score)
    writer = not multihost or torch.distributed.get_rank() == 0

    log(1, "4) Write results...")
    if params.prewarm:
        log(0, "   * --prewarm: kernels built for these input shapes; no "
               "output written")
    elif not writer:
        log(1, "   * non-zero host: process 0 writes the library")
    else:
        with timing.phase("write results"):
            outlib.print(params.out_file if params.out_file else None)

    if params.msa_file and not params.prewarm and writer:
        from lara_tpu_torch import msa as msa_mod

        log(1, "5) Assemble multiple alignment...")
        with timing.phase("assemble MSA"):
            alignment = msa_mod.align(msa_mod.from_output_library(outlib))
            with open(params.msa_file, "w") as handle:
                msa_mod.write_fasta(alignment, handle)

    timing.report()
    log(1, f"lara-tpu-torch has run for {time.monotonic() - time_start:.1f} "
           "seconds.")
    return Run(library=outlib, results=results)

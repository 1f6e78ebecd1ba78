"""Whole-program flow of the port: read inputs -> solve all pairs -> write
the library (``/root/reference/src/lara.cpp:44-61``).

Counterpart of :func:`lara_tpu.app.run` on one device.  Pair enumeration
mirrors ``solve`` (``subgradient_solver.hpp:112-120``): every unordered pair
of input records, with the longer sequence first (ties keep the original
index order, per the ``>=`` comparison).
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Tuple

import torch

from lara_tpu_torch._device import resolve_device
from lara_tpu_torch.io.records import InputStorage
from lara_tpu_torch.io.writers import OutputLibrary
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
    library: OutputLibrary
    results: List[PairResult]  # in solve order


def run(params: Parameters, device: torch.device = None) -> Run:
    """Solve every pair of the input.  ``--backend device`` (the default)
    runs on ``device``, or on the one ``LARA_PLATFORM`` selects;
    ``--backend reference`` runs the NumPy scalar mirror.  With
    ``LARA_PROFILE=<dir>`` the solve is traced with ``torch.profiler``
    into ``<dir>``."""
    time_start = time.monotonic()
    timing.reset()
    if params.backend == "device" and device is None:
        device = resolve_device()
    log(1, "1) Parse parameters...")
    with timing.phase("read input"):
        store = load_input(params)
    outlib = OutputLibrary(store, params.out_format)
    pairs = enumerate_pairs(store)
    log(1, f"3) Solve {len(pairs)} structural alignments...")

    if params.backend == "reference":
        from lara_tpu_torch.solver import reference_driver

        solved = (reference_driver.solve_pair(store[ia], store[ib], params,
                                              (ia, ib))
                  for (ia, ib) in pairs)
    else:
        from lara_tpu_torch.solver import device_driver

        solved = device_driver.solve_all(store, pairs, params, device)
    results = []
    with timing.maybe_trace(), timing.phase("solve"):
        for result in solved:
            outlib.add_alignment(result.seq_indices, result.columns,
                                 result.score)
            results.append(result)

    log(1, "4) Write results...")
    if params.prewarm:
        log(0, "   * --prewarm: kernels built for these input shapes; no "
               "output written")
    else:
        with timing.phase("write results"):
            outlib.print(params.out_file if params.out_file else None)

    if params.msa_file and not params.prewarm:
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

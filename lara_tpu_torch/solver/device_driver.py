"""Host orchestration of the batched solver on one device (serial slice).

Counterpart of the serial part of :mod:`lara_tpu.solver.device_driver`:

* pairs are bucketed by padded (LA, LB) class and each bucket is cut into
  chunks under a cell budget (``LARA_MAX_BATCH`` caps the chunk width),
* per chunk: the edge filter on the device, the host interaction-model
  build (``lara_tpu.solver.interactions``), one upload of the padded
  :class:`~lara_tpu_torch.solver.device_solver.BatchModel`, the solve, one
  packed result download, and the JAX package's host postprocessing.

Exact matching (``-m 0``), lookahead beyond 8 and ``LARA_SOLVER=hybrid``
go to the hybrid backend (:mod:`lara_tpu_torch.solver.hybrid_driver`),
whose host bookkeeping is the native ``lagrange_host`` library; a failed
build of it raises :class:`lara_tpu.native.NativeBuildError`.  Nothing is
handed to the scalar mirror behind the caller's back.

Not ported yet (ROADMAP): lane refill (``LARA_REFILL``, which raises
:class:`NotImplementedError`), the single-bucket split, the threaded
cross-chunk pipeline and multi-device batches.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from lara_tpu.params import Parameters
from lara_tpu.scoring.ribosum import encode_rna5
from lara_tpu.solver import interactions
from lara_tpu.solver.device_driver import (DEFAULT_MAX_BATCH, _build_workers,
                                           _chunk_dcap, _pad_dim,
                                           _postprocess_lane)
from lara_tpu.solver.reference_driver import PairResult
from lara_tpu.types import f2i
from lara_tpu.utils import log, timing
from lara_tpu_torch.ops import gotoh
from lara_tpu_torch.solver import device_solver

#: cap on B * LA * LB cells per chunk (the JAX driver's budget)
CELL_BUDGET = 128 * 1024 * 1024


def buckets_of(store, pairs: Sequence[Tuple[int, int]]
               ) -> List[Tuple[Tuple[int, int], List[Tuple[int, int]]]]:
    """Pairs grouped by padded (LA, LB) class, largest class first."""
    buckets: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for (ia, ib) in pairs:
        key = (_pad_dim(len(store[ia].sequence)),
               _pad_dim(len(store[ib].sequence)))
        buckets.setdefault(key, []).append((ia, ib))
    return sorted(buckets.items(), reverse=True)


def solve_all(store, pairs: Sequence[Tuple[int, int]], params: Parameters,
              device: torch.device) -> Iterator[PairResult]:
    """Solve every pair on ``device``; returns an iterator of one
    :class:`PairResult` per pair, chunk by chunk (bucket by bucket on the
    hybrid backend).  An unported mode or a failed native build raises
    here, before any work, not at the first ``next``."""
    host_matching = params.matching == 0 or params.matching > 8
    if host_matching or os.environ.get("LARA_SOLVER", "") == "hybrid":
        from lara_tpu.native import lagrange
        from lara_tpu_torch.solver import hybrid_driver

        lagrange._load()  # raises NativeBuildError without the toolchain
        if host_matching:
            log(1, "   * host matching mode: hybrid backend (device DP + "
                   "native exact/deep matching)")
        else:
            log(2, "   * hybrid backend: device DP + native host "
                   "bookkeeping")
        return hybrid_driver.solve_all(store, pairs, params, device)
    if os.environ.get("LARA_REFILL") and not os.environ.get("LARA_NO_REFILL"):
        raise NotImplementedError(
            "LARA_REFILL: lane refill is not yet ported to PyTorch (ROADMAP "
            "queue 1, lane refill)")
    max_batch_cap = int(os.environ.get("LARA_MAX_BATCH", DEFAULT_MAX_BATCH))
    chunks = []
    for (la_max, lb_max), bucket_pairs in buckets_of(store, pairs):
        max_batch = max(1, min(max_batch_cap,
                               CELL_BUDGET // (la_max * lb_max)))
        for start in range(0, len(bucket_pairs), max_batch):
            chunks.append((la_max, lb_max,
                           bucket_pairs[start:start + max_batch]))
    return _solve_chunks(store, chunks, params, device)


def _solve_chunks(store, chunks, params: Parameters,
                  device: torch.device) -> Iterator[PairResult]:
    for la_max, lb_max, chunk in chunks:
        models, las = _filter_and_build(store, chunk, params, la_max, lb_max,
                                        device)
        batch, scan_steps = _pack_models(models, la_max, lb_max, device)
        result = _run_solve(batch, params, la_max, lb_max, scan_steps)
        with timing.phase("result download (host)"):
            packed, s = _download_result(result, params)
        for k, pair in enumerate(chunk):
            yield _postprocess_lane(packed, s, k, pair, models[k], params,
                                    int(las[k]))


def _filter_and_build(store, chunk, params: Parameters, la_max: int,
                      lb_max: int, device: torch.device):
    """Edge filter on ``device`` + host model build for one chunk:
    (models, las)."""
    b = len(chunk)
    go, ge = int(params.gap_open_int), int(params.gap_extend_int)
    subopt = int(f2i(params.suboptimal_diff))

    seq_a = np.full((b, la_max), 4, np.int32)
    seq_b = np.full((b, lb_max), 4, np.int32)
    las = np.zeros(b, np.int32)
    lbs = np.zeros(b, np.int32)
    for k, (ia, ib) in enumerate(chunk):
        ea = encode_rna5(store[ia].sequence)
        eb = encode_rna5(store[ib].sequence)
        las[k], lbs[k] = len(ea), len(eb)
        seq_a[k, : len(ea)] = ea
        seq_b[k, : len(eb)] = eb

    log(2, f"     device chunk: {b} pairs padded to {la_max}x{lb_max}")

    with timing.phase("edge filter (device)"):
        def upload(x):
            return torch.from_numpy(x).to(device)

        packed = gotoh.edge_filter_skewed_words(
            upload(seq_a), upload(seq_b), upload(las), upload(lbs),
            upload(np.asarray(params.score_matrix, np.int32)), go, ge,
            subopt, la_max, lb_max).cpu().numpy()
        active_np, opt_np = gotoh.unskew_active_words(packed, la_max, lb_max)

    with timing.phase("interaction build (host)"):
        def build(k_pair):
            k, (ia, ib) = k_pair
            return interactions.build_pair_model(
                store[ia], store[ib], params,
                active_np[k, : las[k], : lbs[k]], int(opt_np[k]),
            )

        workers = min(_build_workers(params), max(1, b))
        if workers > 1:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                models = list(pool.map(build, enumerate(chunk)))
        else:
            models = [build(kp) for kp in enumerate(chunk)]
    return models, las


def _pack_models(models, la_max: int, lb_max: int, device: torch.device):
    """Pad the chunk's models to a power-of-two batch and upload them:
    (BatchModel on ``device``, run-scan depth)."""
    with timing.phase("model packing (host)"):
        b = len(models)
        bp = 1 << max(0, b - 1).bit_length()
        dcap = _chunk_dcap(models)
        ne = la_max * lb_max
        seq_score = np.zeros((bp, la_max, lb_max), np.int32)
        active = np.zeros((bp, la_max, lb_max), bool)
        dual_l = np.zeros((bp, dcap), np.int32)
        dual_m = np.zeros((bp, dcap), np.int32)
        sscore = np.zeros((bp, dcap), np.int32)
        # rev rows must stay involutions (identity on padding)
        rev = np.broadcast_to(np.arange(dcap, dtype=np.int32),
                              (bp, dcap)).copy()
        dvalid = np.zeros((bp, dcap), bool)
        qrank = rev.copy()
        las = np.ones(bp, np.int32)  # padding lanes solve a 1x1 problem
        lbs = np.ones(bp, np.int32)
        max_run = 1
        for k, m in enumerate(models):
            seq_score[k, : m.la, : m.lb] = m.seq_score
            active[k, : m.la, : m.lb] = m.active
            las[k], lbs[k] = m.la, m.lb
            d = len(m.dual_l)
            if d:
                # remap flat edge ids from (la, lb) to padded (la_max, lb_max)
                a_ids, b_ids = np.divmod(m.dual_l, m.lb)
                dual_l[k, :d] = a_ids * lb_max + b_ids
                a_ids, b_ids = np.divmod(m.dual_m, m.lb)
                dual_m[k, :d] = a_ids * lb_max + b_ids
                sscore[k, :d] = m.sscore
                rev[k, :d] = m.rev
                dvalid[k, :d] = True
                qrank[k, :d][m.qperm] = np.arange(d, dtype=np.int32)
                counts = np.unique(m.dual_l, return_counts=True)[1]
                max_run = max(max_run, int(counts.max()))
        # run-scan depth: 2**steps must cover the longest per-edge run
        steps_needed = max(1, (max_run - 1).bit_length())
        scan_steps = min(steps_needed + (steps_needed & 1),
                         max(1, (dcap - 1).bit_length()))

        def upload(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)

        batch = device_solver.BatchModel(
            seq_score=upload(seq_score.reshape(bp, ne)),
            active=upload(active.reshape(bp, ne)),
            dual_l=upload(dual_l), dual_m=upload(dual_m),
            sscore=upload(sscore), rev=upload(rev), dvalid=upload(dvalid),
            qrank=upload(qrank), la=upload(las), lb=upload(lbs))
    return batch, scan_steps


def _run_solve(batch, params: Parameters, la_max: int, lb_max: int,
               scan_steps: int) -> device_solver.BatchResult:
    with timing.phase("subgradient solve (device)"):
        return device_solver.solve_batch(
            batch, int(params.gap_open_int), int(params.gap_extend_int),
            np.float32(params.step_size_factor), la_max, lb_max,
            int(params.num_iterations), int(params.max_nondecr_iterations),
            int(params.matching), scan_steps=scan_steps)


def _download_result(result: device_solver.BatchResult, params: Parameters):
    """One packed int32 transfer in the JAX driver's column layout:
    (packed ndarray, partner column count)."""
    parts = [
        result.best_partner,
        result.best_matched.to(torch.int32),
        torch.stack([result.best_nlines, result.best_lower,
                     result.best_upper, result.iterations], dim=1),
    ]
    if params.library_score_is_linear:
        parts.append(result.dual_at_queue)
    packed = torch.cat(parts, dim=1).cpu().numpy()
    return packed, result.best_partner.shape[1]

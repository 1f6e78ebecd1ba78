"""Host orchestration of the batched solver on one device or several.

Counterpart of :mod:`lara_tpu.solver.device_driver`, with the same knobs:

* pairs are bucketed by padded (LA, LB) class and each bucket is cut into
  chunks under a cell budget (``LARA_MAX_BATCH`` caps the chunk width);
* per chunk: the edge filter on the device, the host interaction-model
  build (:mod:`lara_tpu_torch.solver.interactions`), one upload of the
  padded :class:`~lara_tpu_torch.solver.device_solver.BatchModel`, the
  solve, one packed result download, and the host postprocessing
  (:func:`_postprocess_lane`, as the JAX driver's);
* the upload, on one device, is one pinned int32 buffer in the JAX
  driver's layout (``lara_tpu/solver/device_driver.py:776-806``: active
  bits, dual columns ``packed15`` or ``packed_seq``, sequences, scale,
  lengths), unpacked on the device (:func:`_unpack_model`), where the
  seq-score grid is rebuilt from the sequences; several devices and the
  lane refill's splice upload the ten arrays of :func:`_model_rows`, as
  the JAX driver does;
* lane refill (``LARA_REFILL=1``, cancelled by ``LARA_NO_REFILL``): a
  bucket wider than its chunk runs through one batch of lanes, and between
  dispatches every free lane takes the next waiting pair;
* the single-bucket split (``LARA_SPLIT_SINGLE=1``; unset or ``0``, no
  split, where the JAX package splits long pairs by default): a workload
  of one chunk is cut at its midpoint so that the pipeline can engage;
* the cross-chunk pipeline (more than one task, ``LARA_PIPELINE=1``, and
  ``LARA_NO_PIPELINE`` unset; the JAX package runs it by default): the
  main thread prepares chunk k+1 (edge filter, build, pack, upload), a
  solver thread runs chunk k's dispatches on its own CUDA stream, and a
  download thread brings chunk k-1's result down and post-processes it;
  depth 2, results in task order;
* one device byte budget (:data:`DEVICE_BUDGET`, against the port's own
  estimate :func:`_chunk_est_bytes`) gates the pipeline, bounds the bytes
  left undrained in it, and halves a chunk too large to solve at once;
* several devices (``lara_tpu/solver/device_driver.py:720-721,837-846``):
  a chunk of more than one pair pads to at least one lane per device and
  its lanes are split over the devices
  (:func:`lara_tpu_torch.parallel.mesh.solve_batch_sharded`); the edge
  filter, the model upload, lane refill and the hybrid backend run on the
  first device, as the JAX package runs them on its default device.

The scheduling changes when work runs, never the results: every lane's
arithmetic is independent of the others, and every carry write is masked
by the lane's activity.

Exact matching (``-m 0``), lookahead beyond 8 and ``LARA_SOLVER=hybrid``
go to the hybrid backend (:mod:`lara_tpu_torch.solver.hybrid_driver`),
whose host bookkeeping is the native ``lagrange_host`` library; a failed
build of it raises :class:`lara_tpu_torch.native.NativeBuildError`.  Nothing is
handed to the scalar mirror behind the caller's back.
"""

from __future__ import annotations

import contextlib
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from lara_tpu_torch.ops import gotoh, gotoh_cuda
from lara_tpu_torch.parallel import mesh
from lara_tpu_torch.params import Parameters
from lara_tpu_torch.scoring.ribosum import encode_rna5
from lara_tpu_torch.solver import device_solver, dispatch_graph, interactions
from lara_tpu_torch.solver.reference_driver import PairResult
from lara_tpu_torch.types import INFINITY, f2i
from lara_tpu_torch.utils import log, timing

#: pairs per device batch (lanes beyond the pair count are padded)
DEFAULT_MAX_BATCH = 512

#: cap on B * LA * LB cells per chunk (the JAX driver's budget)
CELL_BUDGET = 128 * 1024 * 1024

#: device bytes, by :func:`_chunk_est_bytes`, that drive three gates, sized
#: for one H100 with 80 GB: a chunk above it is solved outside the
#: pipeline, the chunks waiting in the pipeline are drained down to it (one
#: may stay whatever its size), and a chunk above twice it is solved in
#: halves (lane refill falls back to plain chunks there).  Peak residency
#: stays near two budgets (40 GB), which leaves the caching allocator and
#: the edge filter of the chunk being prepared their room.
DEVICE_BUDGET = 20_000_000_000

#: the refill run of the last ``LARA_REFILL`` bucket solved in this process
last_refill = None


class RefillStats(NamedTuple):
    la_max: int
    lb_max: int
    pairs: int
    lanes: int
    dispatches: int
    occupancy: float  # mean share of lanes holding an active pair


class _Task(NamedTuple):
    kind: str          # "chunk" or "refill"
    la_max: int
    lb_max: int
    pairs: list
    window: int = 0    # refill: pairs per batch of lanes


class _Prepared(NamedTuple):
    """A chunk packed and uploaded, ready to solve: the pipeline boundary
    between host work and the device solve."""

    chunk: list
    models: list
    batch: device_solver.BatchModel
    la_max: int
    lb_max: int
    scan_steps: int
    est_bytes: int
    ready: object  # CUDA event recorded after the upload, None on the CPU
    devices: list  # the batch is on devices[0] and solved over all of them


def buckets_of(store, pairs: Sequence[Tuple[int, int]]
               ) -> List[Tuple[Tuple[int, int], List[Tuple[int, int]]]]:
    """Pairs grouped by padded (LA, LB) class, largest class first."""
    buckets: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for (ia, ib) in pairs:
        key = (_pad_dim(len(store[ia].sequence)),
               _pad_dim(len(store[ib].sequence)))
        buckets.setdefault(key, []).append((ia, ib))
    return sorted(buckets.items(), reverse=True)


def _round_up(value: int, quantum: int) -> int:
    return ((value + quantum - 1) // quantum) * quantum


def _pad_dim(length: int) -> int:
    """Bucket quantisation (``lara_tpu/solver/device_driver.py:69``): coarse
    enough to batch well, fine enough to not waste O(L^2) work."""
    if length <= 32:
        return 32
    if length <= 64:
        return 64
    if length <= 96:
        return 96
    return _round_up(length, 64)


def _build_workers(params: Parameters) -> int:
    """Host worker threads for the model build: ``-j`` (0 = autodetect),
    mirroring the reference's thread-count resolution
    (``parameters.hpp:124-129``)."""
    threads = int(params.threads)
    if threads <= 0:
        threads = os.cpu_count() or 1
    return max(1, threads)


def _chunk_dcap(models) -> int:
    """Quantised dual capacity of a chunk (``lara_tpu/solver/
    device_driver.py:650``): 512, or the largest dual count rounded up to
    a multiple of 1024."""
    dcap = max(1, max(len(m.dual_l) for m in models))
    return ((dcap + 1023) // 1024) * 1024 if dcap > 512 else 512


def solve_all(store, pairs: Sequence[Tuple[int, int]], params: Parameters,
              devices: Sequence[torch.device]) -> Iterator[PairResult]:
    """Solve every pair on ``devices`` (one or more, see
    :func:`lara_tpu_torch.parallel.mesh.pair_devices`); returns an iterator
    of one :class:`PairResult` per pair, in task order.  A bad
    ``LARA_CHUNK`` or a failed native build raises here, before any work,
    not at the first ``next``."""
    devices = list(devices)
    host_matching = params.matching == 0 or params.matching > 8
    if host_matching or os.environ.get("LARA_SOLVER", "") == "hybrid":
        from lara_tpu_torch.native import lagrange
        from lara_tpu_torch.solver import hybrid_driver

        lagrange._load()  # raises NativeBuildError without the toolchain
        if host_matching:
            log(1, "   * host matching mode: hybrid backend (device DP + "
                   "native exact/deep matching)")
        else:
            log(2, "   * hybrid backend: device DP + native host "
                   "bookkeeping")
        return hybrid_driver.solve_all(store, pairs, params, devices[0])
    device_solver.dispatch_size()  # raises on a bad LARA_CHUNK
    return _released(_run_tasks(store, _plan_tasks(store, pairs,
                                                   len(devices)),
                                params, devices))


def _released(results: Iterator[PairResult]) -> Iterator[PairResult]:
    """``results``, then the dispatch graphs of the solve go with their
    memory pools: no later chunk of it reuses them."""
    try:
        yield from results
    finally:
        dispatch_graph.release()


def _padded_batch(b: int, n_dev: int = 1) -> int:
    """Lanes of a chunk of ``b`` pairs: the next power of two, floored at
    the device count where a batch of more than one pair is split over
    several devices (``lara_tpu/solver/device_driver.py:721``)."""
    floor = n_dev if n_dev > 1 and b > 1 else 1
    return 1 << (max(b, floor) - 1).bit_length()


def _plan_tasks(store, pairs, n_dev: int = 1) -> List[_Task]:
    """Buckets cut into chunks, or into one refill task each under
    ``LARA_REFILL``; a lone long-pair chunk split in two."""
    max_batch_cap = int(os.environ.get("LARA_MAX_BATCH", DEFAULT_MAX_BATCH))
    refill = bool(os.environ.get("LARA_REFILL")) \
        and not os.environ.get("LARA_NO_REFILL")
    tasks = []
    for (la_max, lb_max), bucket_pairs in buckets_of(store, pairs):
        max_batch = max(1, min(max_batch_cap,
                               CELL_BUDGET // (la_max * lb_max)))
        if refill and len(bucket_pairs) > max_batch > 1:
            tasks.append(_Task("refill", la_max, lb_max, bucket_pairs,
                               max_batch))
            continue
        for start in range(0, len(bucket_pairs), max_batch):
            tasks.append(_Task("chunk", la_max, lb_max,
                               bucket_pairs[start:start + max_batch]))
    return _split_single(tasks, n_dev)


def _split_single(tasks: List[_Task], n_dev: int = 1) -> List[_Task]:
    """Under ``LARA_SPLIT_SINGLE=1``, a single chunk split at its midpoint,
    so that the pipeline (``LARA_PIPELINE=1``) can hide half 2's
    preparation and half 1's download behind device work
    (``lara_tpu/solver/device_driver.py:141-163``).
    Unset means no split, unlike the JAX package, which splits long pairs
    (``LA * LB >= 512**2``) by default: on an H100 the 16S halves run one
    after the other at K1's batch-insensitive cost, and the split made the
    wall 1.8-2.4x longer (PERF.md).  Only where both halves pad to the same
    batch (28 -> 14 + 14, 16 lanes each; 9 -> 5 + 4 would pad to 8 + 4),
    and together to no more lanes than the unsplit chunk: over ``n_dev``
    devices each half is floored at the device count (6 pairs over 8
    devices: 8 lanes unsplit, 8 + 8 split), a fault the JAX package's
    split has (``ADVICE.md:3``)."""
    if len(tasks) != 1 or tasks[0].kind != "chunk" \
            or os.environ.get("LARA_SPLIT_SINGLE") != "1" \
            or os.environ.get("LARA_NO_PIPELINE"):
        return tasks
    task = tasks[0]
    chunk = task.pairs
    mid = (len(chunk) + 1) // 2
    half = _padded_batch(mid, n_dev)
    if len(chunk) >= 4 and half == _padded_batch(len(chunk) - mid, n_dev) \
            and 2 * half <= _padded_batch(len(chunk), n_dev):
        return [task._replace(pairs=chunk[:mid]),
                task._replace(pairs=chunk[mid:])]
    return tasks


def _pipeline_on() -> bool:
    """The cross-chunk pipeline runs under ``LARA_PIPELINE=1`` unless
    ``LARA_NO_PIPELINE`` is set.  It is off by default on one device,
    unlike the JAX package: on an H100 every stage at the bench's shapes is
    host-bound Python, the three threads contend for the interpreter, and
    pipelined walls read 26-30% longer than serial ones (PERF.md)."""
    return os.environ.get("LARA_PIPELINE") == "1" \
        and not os.environ.get("LARA_NO_PIPELINE")


def _run_tasks(store, tasks: List[_Task], params: Parameters,
               devices: List[torch.device]) -> Iterator[PairResult]:
    if len(tasks) > 1 and _pipeline_on():
        yield from _pipeline(store, tasks, params, devices)
        return
    for task in tasks:
        if task.kind == "refill":
            yield from _run_refill(store, task, params, devices)
        else:
            models, _ = _filter_and_build(store, task.pairs, params,
                                          task.la_max, task.lb_max, devices[0])
            yield from _solve_models(task.pairs, models, params, task.la_max,
                                     task.lb_max, devices)


def _pipeline(store, tasks: List[_Task], params: Parameters,
              devices: List[torch.device]) -> Iterator[PairResult]:
    """The cross-chunk pipeline (the reference's workers never idle,
    ``subgradient_solver.hpp:206-331``; ``lara_tpu/solver/
    device_driver.py:176-225``).  The kernels launch on the calling
    thread's current stream, so the solver thread enters its own stream,
    which first waits for the chunk's upload; the download waits for the
    event recorded at the end of the solve.  A worker's error is raised
    here, when its chunk's results are read."""
    solver_stream = download_stream = None
    if devices[0].type == "cuda":
        solver_stream = torch.cuda.Stream(devices[0])
        download_stream = torch.cuda.Stream(devices[0])
    with ThreadPoolExecutor(max_workers=1) as solver_thread, \
            ThreadPoolExecutor(max_workers=1) as download_thread:
        pending = deque()  # (download future, est bytes), in task order
        for task in tasks:
            if task.kind == "refill":
                while pending:
                    yield from pending.popleft()[0].result()
                yield from _run_refill(store, task, params, devices)
                continue
            # bound the undrained bytes before the next upload; one chunk
            # may stay pending whatever its size, so that a chunk above the
            # budget does not serialise the pipeline
            while len(pending) > 1 \
                    and sum(est for _, est in pending) > DEVICE_BUDGET:
                yield from pending.popleft()[0].result()
            prep = _prepare_chunk(store, task, params, devices)
            if isinstance(prep, _Prepared):
                while len(pending) >= 2:
                    yield from pending.popleft()[0].result()
                solved = solver_thread.submit(_solve_on, solver_stream, prep,
                                              params)
                pending.append((download_thread.submit(
                    _download_on, download_stream, solved, prep, params),
                    prep.est_bytes))
            else:
                # above the budget: solved here, after the pending chunks
                # (its build above still overlapped their device time)
                while pending:
                    yield from pending.popleft()[0].result()
                yield from _solve_models(task.pairs, prep, params,
                                         task.la_max, task.lb_max, devices)
        while pending:
            yield from pending.popleft()[0].result()


def _prepare_chunk(store, task: _Task, params: Parameters,
                   devices: List[torch.device]):
    """Pipeline front half: filter + build + pack + upload.  Returns a
    :class:`_Prepared`, or the models of a chunk whose estimate is above
    :data:`DEVICE_BUDGET` (the caller solves it outside the pipeline)."""
    models, _ = _filter_and_build(store, task.pairs, params, task.la_max,
                                  task.lb_max, devices[0])
    dcap = _chunk_dcap(models)
    if len(models) > 1 and _chunk_est_bytes(
            len(models), task.la_max, task.lb_max, dcap) > DEVICE_BUDGET:
        return models
    return _prepare(task.pairs, models, params, task.la_max, task.lb_max,
                    devices, dcap)


def _prepare(chunk, models, params: Parameters, la_max: int, lb_max: int,
             devices: List[torch.device], dcap: int) -> _Prepared:
    batch, scan_steps = _pack_models(models, params, la_max, lb_max,
                                     devices[0], dcap, len(devices))
    ready = None
    if devices[0].type == "cuda":
        ready = torch.cuda.Event()
        ready.record()
    return _Prepared(chunk=chunk, models=models, batch=batch, la_max=la_max,
                     lb_max=lb_max, scan_steps=scan_steps,
                     est_bytes=_chunk_est_bytes(len(models), la_max, lb_max,
                                                dcap),
                     ready=ready, devices=devices)


def _solve_on(stream, prep: _Prepared, params: Parameters):
    """Pipeline middle stage, on the solver thread: (device result, event
    recorded after the solve's last launch, or None on the CPU)."""
    if stream is None:
        return _run_solve(prep, params), None
    with torch.cuda.stream(stream):
        stream.wait_event(prep.ready)
        # the model was allocated on the uploading thread's stream: its
        # blocks must not be reused before this stream is done with them
        for t in prep.batch:
            t.record_stream(stream)
        result = _run_solve(prep, params)
        done = torch.cuda.Event()
        done.record(stream)
    return result, done


def _download_on(stream, solved, prep: _Prepared, params: Parameters
                 ) -> List[PairResult]:
    """Pipeline back half, on the download thread: wait for the solve's
    end, one packed download on this thread's stream, host postprocess."""
    result, done = solved.result()
    with torch.cuda.stream(stream) if stream is not None \
            else contextlib.nullcontext():
        with timing.phase("result download (host)"):
            if done is not None:
                done.synchronize()
            packed, s = _download_result(result, params)
    return _postprocess(packed, s, prep.chunk, prep.models, params)


def _postprocess(packed, s: int, chunk, models, params: Parameters
                 ) -> List[PairResult]:
    return [_postprocess_lane(packed, s, k, pair, models[k], params,
                              models[k].la)
            for k, pair in enumerate(chunk)]


def _solve_models(chunk, models, params: Parameters, la_max: int,
                  lb_max: int, devices: List[torch.device]
                  ) -> Iterator[PairResult]:
    """Solve one chunk here, in halves while its estimate is above twice
    :data:`DEVICE_BUDGET` (the long-pair memory guard,
    ``lara_tpu/solver/device_driver.py:691-705``)."""
    b = len(chunk)
    dcap = _chunk_dcap(models)
    if b > 1 and _chunk_est_bytes(b, la_max, lb_max, dcap) \
            > 2 * DEVICE_BUDGET:
        mid = b // 2
        yield from _solve_models(chunk[:mid], models[:mid], params, la_max,
                                 lb_max, devices)
        yield from _solve_models(chunk[mid:], models[mid:], params, la_max,
                                 lb_max, devices)
        return
    prep = _prepare(chunk, models, params, la_max, lb_max, devices, dcap)
    result = _run_solve(prep, params)
    with timing.phase("result download (host)"):
        packed, s = _download_result(result, params)
    yield from _postprocess(packed, s, chunk, models, params)


def _run_refill(store, task: _Task, params: Parameters,
                devices: List[torch.device]) -> Iterator[PairResult]:
    """Solve a bucket wider than its batch with chunk-boundary lane refill:
    after every dispatch the finished lanes are harvested from one packed
    download and every free lane, padding lanes included, takes the next
    waiting pair (the reference's work stealing,
    ``subgradient_solver.hpp:286-325``; ``lara_tpu/solver/
    device_driver.py:380-500``).  Exact because ``solve_batch_chunk``
    prepares its loop invariants from the spliced model on every call and
    every carry write is masked per lane."""
    global last_refill
    la_max, lb_max, bucket_pairs, window = (task.la_max, task.lb_max,
                                            task.pairs, task.window)
    # every model up front: the dual capacity and the scan depth must cover
    # any pair of the bucket in any lane
    models = []
    for start in range(0, len(bucket_pairs), window):
        built, _ = _filter_and_build(store, bucket_pairs[start:start + window],
                                     params, la_max, lb_max, devices[0])
        models.extend(built)
    dcap = _chunk_dcap(models)
    if _chunk_est_bytes(window, la_max, lb_max, dcap) > 2 * DEVICE_BUDGET:
        # too wide to refill in device memory: plain sequential chunks
        for start in range(0, len(bucket_pairs), window):
            yield from _solve_models(
                bucket_pairs[start:start + window],
                models[start:start + window], params, la_max, lb_max, devices)
        return

    go, ge = int(params.gap_open_int), int(params.gap_extend_int)
    step0 = np.float32(params.step_size_factor)
    n_iter = int(params.num_iterations)
    scan_steps = _scan_steps(models, dcap)
    model, _ = _pack_models(models[:window], params, la_max, lb_max,
                            devices[0], dcap, len(devices))
    bp = _padded_batch(window, len(devices))
    carry = device_solver._init_carry(bp, dcap, la_max, step0, n_iter,
                                      devices[0])
    # lane k holds (pair, model), or None (padding or harvested)
    lane_pair: List = [None] * bp
    for k in range(window):
        lane_pair[k] = (bucket_pairs[k], models[k])
    next_i = window
    dispatches = occupied = 0
    steps = device_solver.dispatch_size()
    while True:
        with timing.phase("subgradient solve (device)"):
            carry = device_solver.solve_batch_chunk(
                model, carry, go, ge, la_max, lb_max, steps,
                int(params.max_nondecr_iterations), int(params.matching),
                scan_steps)
            with timing.phase("dispatch flag wait (host)"):
                flags = carry.lane_active.cpu().numpy()
        dispatches += 1
        occupied += sum(1 for k in range(bp)
                        if lane_pair[k] is not None and flags[k])
        finished = [k for k in range(bp)
                    if lane_pair[k] is not None and not flags[k]]
        if finished:
            with timing.phase("result download (host)"):
                packed, s = _download_result(
                    device_solver._result_of(carry), params)
            for k in finished:
                pair, mdl = lane_pair[k]
                lane_pair[k] = None
                yield _postprocess_lane(packed, s, k, pair, mdl, params,
                                        mdl.la)
        free = [k for k in range(bp) if lane_pair[k] is None]
        take = min(len(free), len(bucket_pairs) - next_i)
        if take:
            lanes = free[:take]
            new_models = models[next_i:next_i + take]
            with timing.phase("model packing (host)"):
                rows = _upload_model(
                    _model_rows(new_models, la_max, lb_max, dcap), devices[0])
                model, carry = device_solver.splice_lanes(
                    model, carry, lanes, rows, step0, n_iter)
            for j, k in enumerate(lanes):
                lane_pair[k] = (bucket_pairs[next_i + j], new_models[j])
            next_i += take
        if not any(lane_pair):
            break
    last_refill = RefillStats(la_max, lb_max, len(bucket_pairs), bp,
                              dispatches, occupied / max(1, dispatches * bp))
    log(1, f"   * refill bucket {la_max}x{lb_max}: {len(bucket_pairs)} pairs "
           f"through {bp} lanes, mean occupancy "
           f"{last_refill.occupancy:.2f} over {dispatches} dispatches")


def _filter_and_build(store, chunk, params: Parameters, la_max: int,
                      lb_max: int, device: torch.device):
    """Edge filter on ``device`` + host model build for one chunk:
    (models, las).  K4 hands the chunk's active grid over as row-major
    words (bit a * lb_max + b of a lane; word for word the active section
    of :func:`_packed_buffer`), so the host's "unskew" is one contiguous
    unpack, and :func:`interactions.build_chunk` reads the unpacked bits in
    place as a ``[B, LA, LB]`` view."""
    b = len(chunk)
    go, ge = int(params.gap_open_int), int(params.gap_extend_int)
    subopt = int(f2i(params.suboptimal_diff))

    with timing.phase("edge filter inputs (host)"):
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

        packed = gotoh_cuda.edge_filter_active_words(
            upload(seq_a), upload(seq_b), upload(las), upload(lbs),
            upload(np.asarray(params.score_matrix, np.int32)), go, ge,
            subopt, la_max, lb_max).cpu().numpy()
        with timing.phase("edge filter: unskew (host)"):
            active_np, opt_np = gotoh.unpack_active_words(packed, la_max,
                                                          lb_max)

    with timing.phase("interaction build (host)"):
        models = interactions.build_chunk(
            [(store[ia], store[ib]) for ia, ib in chunk], params, active_np,
            opt_np, _build_workers(params))
    return models, las


def _dual_rows(models, lb_max: int, dcap: int, n: int):
    """The dual columns of ``models`` padded to ``n`` rows of ``dcap``:
    (dual_l, dual_m, sscore, rev, qrank, nd), flat edge ids remapped from
    (la, lb) to (la_max, lb_max), every ``rev`` row an involution,
    identity on padding (a solver invariant)."""
    dual_l = np.zeros((n, dcap), np.int32)
    dual_m = np.zeros((n, dcap), np.int32)
    sscore = np.zeros((n, dcap), np.int32)
    rev = np.broadcast_to(np.arange(dcap, dtype=np.int32), (n, dcap)).copy()
    qrank = rev.copy()
    nd = np.zeros(n, np.int32)
    for k, m in enumerate(models):
        d = len(m.dual_l)
        nd[k] = d
        if d:
            a_ids, b_ids = np.divmod(m.dual_l, m.lb)
            dual_l[k, :d] = a_ids * lb_max + b_ids
            a_ids, b_ids = np.divmod(m.dual_m, m.lb)
            dual_m[k, :d] = a_ids * lb_max + b_ids
            sscore[k, :d] = m.sscore
            rev[k, :d] = m.rev
            qrank[k, :d][m.qperm] = np.arange(d, dtype=np.int32)
    return dual_l, dual_m, sscore, rev, qrank, nd


def _active_grid(models, la_max: int, lb_max: int, n: int) -> np.ndarray:
    active = np.zeros((n, la_max, lb_max), bool)
    for k, m in enumerate(models):
        active[k, : m.la, : m.lb] = m.active
    return active


def _lengths(models, n: int):
    """(la, lb) of ``n`` lanes; a padding lane is a 1x1 problem."""
    las = np.ones(n, np.int32)
    lbs = np.ones(n, np.int32)
    for k, m in enumerate(models):
        las[k], lbs[k] = m.la, m.lb
    return las, lbs


def _model_rows(models, la_max: int, lb_max: int, dcap: int,
                n_rows: int = 0) -> device_solver.BatchModel:
    """The padded :class:`BatchModel` rows of ``models`` as numpy arrays,
    ``n_rows`` of them (default one per model); rows beyond the models are
    padding lanes, a 1x1 problem with no dual entries.  Counterpart of
    ``lara_tpu/solver/device_driver.py:340-373``."""
    n = n_rows or len(models)
    seq_score = np.zeros((n, la_max, lb_max), np.int32)
    for k, m in enumerate(models):
        seq_score[k, : m.la, : m.lb] = m.seq_score
    dual_l, dual_m, sscore, rev, qrank, nd = _dual_rows(models, lb_max, dcap,
                                                        n)
    las, lbs = _lengths(models, n)
    ne = la_max * lb_max
    return device_solver.BatchModel(
        seq_score=seq_score.reshape(n, ne),
        active=_active_grid(models, la_max, lb_max, n).reshape(n, ne),
        dual_l=dual_l, dual_m=dual_m, sscore=sscore, rev=rev,
        dvalid=np.arange(dcap, dtype=np.int32)[None, :] < nd[:, None],
        qrank=qrank, la=las, lb=lbs)


#: the two layouts of the packed upload (``lara_tpu/solver/
#: device_driver.py:789``): ``packed15`` shares one word between the l
#: and m ids and one between rev and qrank, where flat edge ids and dual
#: indices fit 15 bits; ``packed_seq`` keeps five full columns
PACKED15, PACKED_SEQ = "packed15", "packed_seq"


def _packed_mode(la_max: int, lb_max: int, dcap: int) -> str:
    return PACKED15 if la_max * lb_max <= 32768 and dcap <= 32768 \
        else PACKED_SEQ


def _packed_width(la_max: int, lb_max: int, dcap: int, mode: str) -> int:
    """int32 words per lane of the packed buffer."""
    nw = -(-la_max * lb_max // 32)
    return nw + (3 if mode == PACKED15 else 5) * dcap + la_max + lb_max + 4


def _packed_buffer(models, la_max: int, lb_max: int, dcap: int, n: int,
                   nk: int, pin: bool = False) -> torch.Tensor:
    """The chunk as one ``[n, width]`` int32 buffer (pinned with ``pin``),
    word for word the JAX driver's one-device upload (``lara_tpu/solver/
    device_driver.py:776-806``): per lane the active bits as little-endian
    32-bit words, the dual columns of :func:`_packed_mode`'s layout, the
    sequences padded with ``nk - 1``, the float32 scale's bits, la, lb and
    the dual count.  Padding lanes are 1x1 problems with scale 0."""
    mode = _packed_mode(la_max, lb_max, dcap)
    nw = -(-la_max * lb_max // 32)
    buf = torch.empty((n, _packed_width(la_max, lb_max, dcap, mode)),
                      dtype=torch.int32, pin_memory=pin)
    out = buf.numpy()
    bits = np.packbits(_active_grid(models, la_max, lb_max, n).reshape(n, -1),
                       axis=1, bitorder="little")
    words = np.zeros((n, 4 * nw), np.uint8)
    words[:, :bits.shape[1]] = bits
    out[:, :nw] = words.view("<u4").view(np.int32)
    dual_l, dual_m, sscore, rev, qrank, nd = _dual_rows(models, lb_max, dcap,
                                                        n)
    if mode == PACKED15:
        cols = [(dual_l << 15) | dual_m, sscore, (rev << 15) | qrank]
    else:
        cols = [dual_l, dual_m, sscore, rev, qrank]
    off = nw
    for col in cols:
        out[:, off:off + dcap] = col
        off += dcap
    seqs = out[:, off:off + la_max + lb_max]
    seqs[:] = nk - 1
    scale = np.zeros(n, np.float32)
    for k, m in enumerate(models):
        seqs[k, : m.la] = m.seq_a
        seqs[k, la_max:la_max + m.lb] = m.seq_b
        scale[k] = np.float32(m.scale)
    off += la_max + lb_max
    out[:, off] = scale.view(np.int32)
    out[:, off + 1], out[:, off + 2] = _lengths(models, n)
    out[:, off + 3] = nd
    return buf


def _unpack_model(buf: torch.Tensor, submat: torch.Tensor, la_max: int,
                  lb_max: int, dcap: int) -> device_solver.BatchModel:
    """The :class:`BatchModel` of a :func:`_packed_buffer` on its device,
    with the fields of the JAX driver's ``_get_unpack_model``
    (``lara_tpu/solver/device_driver.py:576-621``).  The seq-score grid is
    an exact integer gather of ``submat`` ([nk, nk] int32) at the two
    sequences, times the lane's float32 scale, truncated toward zero: the
    host's ``np.trunc(np.float32(scale) * mat.astype(np.float32))`` bit
    for bit.  Cells beyond a lane's (la, lb) hold ``submat[nk - 1, .]``
    terms, as in the JAX package; no result reads them."""
    n = buf.shape[0]
    ne = la_max * lb_max
    nw = -(-ne // 32)
    mode = _packed_mode(la_max, lb_max, dcap)
    dev = buf.device
    octets = buf[:, :nw].contiguous().view(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    active = ((octets[:, :, None] >> shifts) & 1).bool().reshape(
        n, 32 * nw)[:, :ne].contiguous()

    def cols(count, off):
        return [buf[:, off + j * dcap:off + (j + 1) * dcap].contiguous()
                for j in range(count)]

    off = nw
    if mode == PACKED15:
        lm, sscore, rq = cols(3, off)
        off += 3 * dcap
        dual_l, dual_m = lm >> 15, lm & 0x7FFF
        rev, qrank = rq >> 15, rq & 0x7FFF
    else:
        dual_l, dual_m, sscore, rev, qrank = cols(5, off)
        off += 5 * dcap
    sa = buf[:, off:off + la_max].long()
    sb = buf[:, off + la_max:off + la_max + lb_max].long()
    off += la_max + lb_max
    scale = buf[:, off].contiguous().view(torch.float32)
    nd = buf[:, off + 3]
    mat = submat[sa[:, :, None], sb[:, None, :]].to(torch.float32)
    seq_score = (scale[:, None, None] * mat).to(torch.int32)
    return device_solver.BatchModel(
        seq_score=seq_score.reshape(n, ne), active=active, dual_l=dual_l,
        dual_m=dual_m, sscore=sscore, rev=rev,
        dvalid=torch.arange(dcap, dtype=torch.int32, device=dev)[None, :]
        < nd[:, None],
        qrank=qrank, la=buf[:, off + 1].contiguous(),
        lb=buf[:, off + 2].contiguous())


def _scan_steps(models, dcap: int) -> int:
    """Doubling passes of the run scan: 2**steps must cover the longest
    per-edge run of any model, rounded up to even."""
    max_run = 1
    for m in models:
        if len(m.dual_l):
            counts = np.unique(m.dual_l, return_counts=True)[1]
            max_run = max(max_run, int(counts.max()))
    steps_needed = max(1, (max_run - 1).bit_length())
    return min(steps_needed + (steps_needed & 1),
               max(1, (dcap - 1).bit_length()))


def _upload_model(rows: device_solver.BatchModel, device: torch.device
                  ) -> device_solver.BatchModel:
    return device_solver.BatchModel(*(
        torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in rows))


def _pack_models(models, params: Parameters, la_max: int, lb_max: int,
                 device: torch.device, dcap: int = 0, n_dev: int = 1):
    """Pad the chunk's models to :func:`_padded_batch` lanes (to be split
    over ``n_dev`` devices) and upload them: (BatchModel on ``device``,
    run-scan depth).  One device: one pinned buffer, one upload, unpacked
    on the device; several: the ten arrays (``raw_path``,
    ``lara_tpu/solver/device_driver.py:725``).  ``dcap`` defaults to the
    chunk's quantised dual capacity."""
    with timing.phase("model packing (host)"):
        dcap = dcap or _chunk_dcap(models)
        n = _padded_batch(len(models), n_dev)
        if n_dev > 1:
            batch = _upload_model(_model_rows(models, la_max, lb_max, dcap,
                                              n), device)
        else:
            submat = np.asarray(params.score_matrix, np.int32)
            with timing.phase("model packing: host buffer"):
                buf = _packed_buffer(models, la_max, lb_max, dcap, n,
                                     submat.shape[0],
                                     pin=device.type == "cuda")
            batch = _unpack_model(buf.to(device, non_blocking=True),
                                  torch.from_numpy(submat).to(device),
                                  la_max, lb_max, dcap)
            if device.type == "cuda":
                # the upload and the unpack count to this phase, as in
                # lara_tpu/solver/device_driver.py:820 (block_until_ready)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(device))
                done.synchronize()
        return batch, _scan_steps(models, dcap)


def _chunk_est_bytes(n_pairs: int, la_max: int, lb_max: int,
                     dcap: int) -> int:
    """Device bytes of a chunk of ``n_pairs`` at its peak, from the tensors
    the port allocates for each of its padded lanes: per grid cell the
    model's seq-score (int32) and active (bool) and an iteration's placed,
    sum and PSSM grids (int32), 17 bytes; K1's direction codes, one int8
    per cell of the D x W wavefront; per dual entry about 256 bytes (the
    model's five int32 and one bool columns, the carry's two int32
    columns, the prepared queue and run masks, an iteration's scan and
    subgradient temporaries).  The JAX driver's formula counts the TPU's
    skewed layout and does not apply here."""
    num_diag, width = la_max + lb_max + 1, la_max + 1
    return _padded_batch(n_pairs) * (17 * la_max * lb_max
                                     + num_diag * width + 256 * dcap)


def _run_solve(prep: _Prepared, params: Parameters
               ) -> device_solver.BatchResult:
    """The chunk's solve: its lanes split over the devices where there
    are several and more than one pair (``lara_tpu/solver/
    device_driver.py:837-846``)."""
    args = (prep.batch, int(params.gap_open_int), int(params.gap_extend_int),
            np.float32(params.step_size_factor), prep.la_max, prep.lb_max,
            int(params.num_iterations), int(params.max_nondecr_iterations),
            int(params.matching))
    with timing.phase("subgradient solve (device)"):
        if len(prep.devices) > 1 and len(prep.chunk) > 1:
            return mesh.solve_batch_sharded(*args, prep.devices,
                                            scan_steps=prep.scan_steps)
        return device_solver.solve_batch(*args, scan_steps=prep.scan_steps)


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


def _postprocess_lane(packed, s: int, k: int, pair, model,
                      params: Parameters, la_len: int) -> PairResult:
    """One lane of a packed result download -> PairResult
    (``lara_tpu/solver/device_driver.py:885``), timed as the phase
    "result postprocess (host)" on the thread that runs it."""
    with timing.phase("result postprocess (host)"):
        ia, ib = pair
        linear = bool(params.library_score_is_linear)
        pk = packed[k, :s][:la_len]
        a_pos = np.nonzero(pk >= 0)[0]
        best_nlines = int(packed[k, 2 * s])
        assert len(a_pos) == best_nlines, "partner/count mismatch"
        lines = [(int(a), int(pk[a])) for a in a_pos]
        matched = packed[k, s:2 * s].astype(bool)[a_pos]
        dual_q = packed[k, 2 * s + 4:][: len(model.dual_l)] if linear \
            else None
        columns = _structure_columns(model, params, lines, matched, dual_q)
        if ia > ib:
            columns = [(y, x, w) for (x, y, w) in columns]
        best_lower = int(packed[k, 2 * s + 1])
        return PairResult(
            seq_indices=(min(ia, ib), max(ia, ib)),
            columns=columns,
            score=best_lower,
            iterations=int(packed[k, 2 * s + 3]),
            best_upper=int(packed[k, 2 * s + 2]),
            best_lower=best_lower,
        )


def _structure_columns(model, params: Parameters, lines, matched, dual_q):
    """``getStructureLines`` (``lagrange.hpp:437-487``) from device outputs."""
    if not params.library_score_is_linear:
        return [
            (int(a), int(b), (500 if m else 0) + 500)
            for (a, b), m in zip(lines, matched)
        ]

    # linear mode: per-edge top profits at the last queue-visible duals
    ne = model.la * model.lb
    mpp = np.full(ne, -int(INFINITY), np.int64)
    if len(model.dual_l):
        np.maximum.at(mpp, model.dual_l, model.sscore.astype(np.int64) + dual_q)
    tops_all = model.seq_score.reshape(-1).astype(np.int64) + np.maximum(mpp, 0)
    active_flat = model.active.reshape(-1)
    tops_active = tops_all[active_flat]
    min_score = int(tops_active.min())
    max_score = int(tops_active.max())
    if max_score > min_score:
        div = np.float32(
            np.float32(1.0)
            * np.float32(params.library_score_max - params.library_score_min)
            / np.float32(max_score - min_score)
        )
    else:
        div = np.float32(0.0)
    columns = []
    for (a, b), m in zip(lines, matched):
        top_val = int(tops_all[a * model.lb + b])
        val = int(np.int32(np.trunc(np.float32(int(m) * (top_val - min_score)) * div)))
        columns.append((int(a), int(b), params.library_score_min + val))
    return columns

"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py`` (no arguments, one
card, no JAX, nothing of the JAX package).  Phases, each fatal on failure:

1. build the CUDA kernels of ``lara_tpu_torch/csrc`` and the port's native
   host libraries (g++) before anything is timed, and print the card, its
   power limit, the torch, CUDA runtime and driver versions, the build
   times and, from
   ``cuobjdump``, each kernel's registers, local memory and spills;
2. hold every kernel against its plain PyTorch version on the card, exactly
   (integer outputs, zero tolerance), at the main path's shapes, and time
   both with CUDA events beside the kernel's bound (bytes over 3.35 TB/s or
   operations over 67 T/s, from this batch's data):
   K1 + K2 (wavefront DP + traceback) and K1-grid + K2-grid (the same
   kernels over pre-skewed scores and diagonal-major codes, one launch
   each) at B=128 96x96, B=32 320x320 and the 16S chunk's B=32 1536x1536,
   K-res (K1's sweep and K2's walk in one CTA per pair, the codes in
   shared memory) at the first two and at a ragged B=40 333x150, K1 +
   K2 at a ragged non-square B=40 333x700; K1 both in the
   wrapper's clusters of CTAs per pair and at one CTA per pair, and alone
   on a lone 16S pair (B=1 1536x1536) on 4, 8 and 16 CTAs per pair in
   turns, with the time a step; K2 as the
   main path runs it, after a K1 that has just written its codes (the
   pair's time less K1's); K3 (greedy matching) at the main path's B=128
   and B=32 with W=512 columns and B=32 W=1536 S=1536, and at B=128 with
   W=256 and W=1024, lookahead 1, 2, 5, 8, each with the rounds of its
   longest lane (counted in the plain loop) and the time per round; K4
   (the edge filter: its sweep, K1's kernel in a prefix mode over 2B lanes,
   and its pack) at the main path's B=128 96x96, B=32 320x320, B=32
   1536x1536 and B=40 333x700, the sweep's prefixes, the pack and the
   filter's words each against its plain version; KB (the wavefront-layout
   microbenchmark's chain) at the three layouts of
   ``benchmark/profile_wavefront_layout.py``, reps 1, 2 and 5 and near
   INT32_MAX, timed at reps 5 beside its bound and at the source's 3600;
   the loop exit (``csrc/loop_exit.cu``, the JAX ``while_loop``'s
   ``cond`` on the card: its kernel before the first trip, KI-tail's last
   CTA after each) against ``any()`` and the iteration budget at 128 and
   32 lanes, around a KI-tail body as the solver's graph runs it (bodies
   run equal to the counters, KI-tail's ticket 0, no condition set by
   KI-tail outside the loop), the graph with no lane active, an idle
   dispatch and a turn of its loop timed; KI-head,
   KI-lines and KI-tail (``csrc/iteration.cu``, the fused solver's
   iteration body around the DP and K3) on the tRNA, ~300 nt and 16S
   chunks' models with random carries, every output and the PSSM grid's
   start cells against the plain versions, each chunk's grids printed
   (KI-head's steps, halo, tile and CTAs; KI-lines' cluster and CTAs;
   KI-tail's threads), and KI-head and KI-lines timed in turns in other
   layouts (both on one CTA a lane, KI-lines in clusters of 8), each held
   against its plain version too; KI-tail on crafted carries at the three
   chunks' shapes and a ragged one (inactive, halving, count 0 and > 1,
   wrapping bounds; new tensors and in place);
   then the dispatch graph (``lara_tpu_torch.solver.dispatch_graph``: on
   the card every ``solve_batch_chunk`` is one launch of a graph whose
   WHILE node loops over a captured iteration while a lane is active)
   against the eager loop it replaces: a K1 graph captured at
   B=32 320x320 must replay after an eager K1 at B=128 96x96 (the
   launcher opts K1 in to its largest shared memory once), and one dispatch of
   125 iterations and a second one resumed from its carry, graphed and
   eager from the same carry, on the tRNA, ~300 nt and 16S chunks, on the
   tRNA chunk without its structures (every lane done in its first
   iteration), on the tRNA chunk under ``LARA_DP_GRID=1`` and on the
   ~300 nt chunk under ``LARA_DP_RESIDENT=1``: every carry field equal, no
   host sync in the graphed dispatches
   (``torch.cuda.set_sync_debug_mode("error")``), the plan's kernels
   counted once per iteration run; with the capture seconds and the peak
   memory of both ways;
3. drive the port's paths through ``lara_tpu_torch.app.run`` on the bench's
   families (``lara_tpu_torch.workloads``, copies of ``bench.py``'s): tRNA
   (120 pairs of ~72 nt), ~300 nt (28 pairs), 16S (28 pairs of 1530 nt,
   one 1536x1536 bucket) and the tRNA and ~300 nt families as one (276
   pairs in three buckets): the fused main path with default parameters on
   all four (16S is one chunk, the mixed family's buckets run one after
   another), the tRNA family with its structures cleared as it is read
   (one iteration of the 250 dispatched, its solve phase beside the
   capture), the hybrid backend at ``-m 0`` on tRNA, the
   hybrid at ``-m 12`` on ~300 nt under ``LARA_DP_RESIDENT=1``, and the
   fused path under ``LARA_DP_GRID=1`` on tRNA, and the fused path on a
   lone 16S pair; the tRNA, ~300 nt, 16S and lone-pair runs print the
   CTAs per pair that K1 and K4's sweep launched on (``_build.clusters``),
   which must be the one placement the chunk's lanes give (1, 4, 4 and
   spread to the wrapper's choice for K1); and KB's own entry
   point, ``lara_tpu_torch.benchmark.profile_wavefront_layout.main``, which
   prints the us per step of each layout by the slope and must launch KB
   alone.  Every pair must equal the
   port's native C++ baseline under ``workloads.full_depth_ok`` (columns,
   best_lower, best_upper, iterations; on 16S the native pairs run on a
   thread pool, and three of them again alone for the one-thread rate),
   the library bytes must equal the library built from the native results,
   and the launch counts, set to 0 before each run, must show exactly the
   kernels the run is meant to launch, K4's two once per chunk the run
   filtered (a spy on ``device_driver._filter_and_build`` counts them),
   and the fused runs of one chunk K1 + K2 + K3 (under ``LARA_DP_GRID=1``
   K1-grid + K2-grid + K3) exactly once per iteration of the JAX loop
   (the longest lane's), and KI-head, KI-lines and KI-tail with them, the
   loop exit's kernel once per dispatch;
   each run prints its model uploads (layout, bytes, and the bytes the
   ten arrays of ``_model_rows`` would take), each dispatch's iterations
   run, and the hybrid's graph replays.
   16S runs again under
   ``LARA_SPLIT_SINGLE=1 LARA_PIPELINE=1`` (split 14 + 14, pipelined) and
   by default again, the mixed family serial and under
   ``LARA_PIPELINE=1`` in turns; each must write the same bytes.  Over
   shards the count is once per iteration of each shard's dispatches.
   Every fused path's dispatches must be CUDA graphs (a spy on
   ``dispatch_graph.run``), and the counts are replay-aware; tRNA and
   16S run again with graphed and eager dispatches in turns (graphed,
   eager, eager, graphed), each with the same bytes.
   tRNA and 16S run again with
   each chunk's lanes split over two shards of one card (``[cuda:0,
   cuda:0]``, ``lara_tpu_torch.parallel.mesh``; and over every card where
   there are several), in turns with one device, each with the one-device
   run's bytes and pairs; the tRNA CLI runs as one process and as two
   processes of a gloo group on the card (the JAX package's coordinator
   variables), with the same bytes; and the repository's families
   (``benchmark/data/{trna,rrna5s,srp}``) run with ``--predict builtin
   --msa``, every pair against native, SPS and MCC printed by the port's
   ``evaluate``;
4. time 25 warm iterations of the tRNA, ~300 nt and 16S chunks, and of
   the tRNA chunk under ``LARA_DP_GRID=1``, eager and graphed side by
   side: first, before any profiler runs, the unprofiled wall per
   iteration and the device time per iteration of the dispatch's loop
   beside its captured iteration replayed bare (the loop exit's cost),
   and the device operations the captured iteration holds (its nodes,
   from the driver API; at most 12 on the default fused path); then from
   ``torch.profiler`` the device busy share, kernels per iteration and the
   K1/K2/K3 (K1-grid/K2-grid/K3) and KI-head/KI-lines/KI-tail time, and
   the device time and operations of one iteration by section of the body
   (the ``lara.*`` ranges, over eager steps of a graph entry); K3 and the
   body's three kernels are held against their plain versions, and
   timed, on the solver's own arguments of iterations 1-3 and 25 (of the
   eager loop, whose iterations call the wrappers), and the body's
   kernels' times in the loop and alone printed side by side.

It then checks that neither JAX nor any module of the JAX package (nor
``bench``, nor the repository's ``benchmark``) was loaded, prints a
``{"kernels": [...]}`` line, the
``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``.  Without CUDA, or outside a checkout of
the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

KERNELS = {
    "gotoh_dp": ("lara_tpu_torch/csrc/gotoh_dp.cu",
                 "lara_tpu/ops/gotoh_pallas.py:253"),
    "gotoh_tb": ("lara_tpu_torch/csrc/gotoh_dp.cu",
                 "lara_tpu/ops/gotoh_pallas.py:366"),
    "matching_rounds": ("lara_tpu_torch/csrc/matching.cu",
                        "lara_tpu/solver/matching_pallas.py:250"),
    # K1's and K2's kernels over the grid variant's layouts
    "gotoh_grid_dp": ("lara_tpu_torch/csrc/gotoh_dp.cu",
                      "lara_tpu/ops/gotoh_pallas.py:41"),
    "gotoh_grid_tb": ("lara_tpu_torch/csrc/gotoh_dp.cu",
                      "lara_tpu/ops/gotoh_pallas.py:145"),
    # one kernel for both resident TPU kernels (K1-res :468, K2-res :550):
    # K1's sweep and K2's walk with the codes in shared memory
    "gotoh_resident": ("lara_tpu_torch/csrc/gotoh_dp.cu",
                       "lara_tpu/ops/gotoh_pallas.py:468"),
    # K4, the edge filter: not Pallas on the TPU but two XLA scans and a
    # pack (edge_filter_skewed_words); the pack writes row-major words
    "edge_sweep": ("lara_tpu_torch/csrc/gotoh_dp.cu",
                   "lara_tpu/ops/gotoh.py:337"),
    "edge_pack": ("lara_tpu_torch/csrc/edge_filter.cu",
                  "lara_tpu/ops/gotoh.py:337"),
    # KB, the wavefront-layout microbenchmark (make_chain's pallas_call :76)
    "wavefront_chain": ("lara_tpu_torch/csrc/wavefront_chain.cu",
                        "benchmark/profile_wavefront_layout.py:47"),
    # the loop exit of a graphed dispatch: not Pallas on the TPU but the
    # cond of the dispatch's while_loop (:629-633), run once per dispatch
    # (KI-tail evaluates it after each iteration)
    "loop_exit": ("lara_tpu_torch/csrc/loop_exit.cu",
                  "lara_tpu/solver/device_solver.py:629"),
    # the iteration body around the DP and K3: not Pallas on the TPU but
    # the XLA fusions of the while_loop's body, section by section (queue
    # top and PSSM :452-506; slots, lines, subgradients, consistent branch,
    # candidates :514-582; best primal, bounds, dual update :583-628)
    "iteration_head": ("lara_tpu_torch/csrc/iteration.cu",
                       "lara_tpu/solver/device_solver.py:452"),
    "iteration_lines": ("lara_tpu_torch/csrc/iteration.cu",
                        "lara_tpu/solver/device_solver.py:514"),
    "iteration_tail": ("lara_tpu_torch/csrc/iteration.cu",
                       "lara_tpu/solver/device_solver.py:583"),
}
#: the iteration body's kernels, once per iteration of every fused path
BODY = ("iteration_head", "iteration_lines", "iteration_tail")
#: K4's kernels, launched once per chunk on every path
K4 = ("edge_sweep", "edge_pack")
ALSO_REPLACES = {"gotoh_resident": "lara_tpu/ops/gotoh_pallas.py:550"}


#: H100 SXM peaks (NVIDIA's data sheet, SXM part): HBM bytes/s, and
#: the rate of 32-bit operations outside the tensor cores (float32's 67
#: TFLOP/s), taken for the DP's integer adds, maxima and compares
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
#: operations per DP cell: three candidate sums and two maxima for each of
#: M, H and V, and six compares for the direction codes
DP_OPS_PER_CELL = 21


def _bound(nbytes: float, ops: float):
    """(least ms the card could take, "bytes" or "operations")."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ALU_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def _sig(x: float) -> float:
    """``x`` to six significant digits (the loop exit's bound is 1e-8)."""
    return float(f"{x:.6g}")


def _time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` calls (CUDA events,
    after one warm-up call).  The card first sleeps ~20 ms while the host
    queues the calls, so that a kernel shorter than the wrapper's host
    work runs back to back and is not timed at the host's launch rate."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_abs_err(got, want) -> int:
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def _dp_bounds(la, lb, la_max, tb):
    """Bounds of K1 and K2 on this batch's data (numpy la, lb; the plain
    traceback ``tb``).  K1 reads each valid cell's score once and writes its
    code once.  K2 reads one code per step of each walk, la + lb - matches
    steps, and one seq score per match, each a 32-byte sector (the least a
    load of scattered bytes moves), and writes the partner rows."""
    cells = float(((la + 1) * (lb + 1)).sum())
    k1 = _bound(4.0 * float((la * lb).sum()) + cells + 12 * len(la),
                DP_OPS_PER_CELL * cells)
    matches = tb.n_lines.cpu().numpy().astype(np.int64)
    steps = float((la + lb - matches).sum())
    k2_bytes = 32.0 * (steps + float(matches.sum())) \
        + 4.0 * len(la) * (la_max + 7)
    k2 = _bound(k2_bytes, 8.0 * steps)
    # K-res keeps the codes on chip, and its walk reads them from shared
    # memory: the scores once, a seq score per match, the partner rows
    res = _bound(4.0 * float((la * lb).sum()) + 32.0 * float(matches.sum())
                 + 4.0 * len(la) * (la_max + 7), DP_OPS_PER_CELL * cells)
    return {"gotoh_dp": k1, "gotoh_tb": k2, "gotoh_grid_dp": k1,
            "gotoh_grid_tb": k2, "gotoh_resident": res}


def _dp_phase(b, la_max, lb_max, seed, dev, stats, grid=True,
              resident=True):
    """K1 + K2, with ``grid`` K1-grid + K2-grid and with ``resident`` K-res,
    against the plain DP and traceback on one random batch.  The variants
    compute the plain versions' functions, so their plain times are K1's
    and K2's.  K2 and K2-grid are timed as the main path runs them, after
    a fresh K1 or K1-grid (:func:`_forward_then_walk`).
    Where the wrapper runs K1 in clusters of several CTAs per pair, one CTA
    per pair is timed beside it."""
    import torch

    from lara_tpu_torch.ops import gotoh, gotoh_cuda, gotoh_plan
    from lara_tpu_torch.types import PSSM_INIT

    go, ge = -49152, -16384
    rng = np.random.default_rng(seed)
    pssm = rng.integers(-9000, 9000, (b, la_max, lb_max)).astype(np.int32)
    pssm[rng.random(pssm.shape) < 0.3] = PSSM_INIT
    seq = rng.integers(-5000, 5000, (b, la_max, lb_max)).astype(np.int32)
    la = rng.integers(1, la_max + 1, b).astype(np.int32)
    lb = rng.integers(1, lb_max + 1, b).astype(np.int32)
    la[:3], lb[:3] = (1, la_max, la_max), (lb_max, 1, lb_max)
    pssm_t, seq_t, la_t, lb_t = (torch.from_numpy(x).to(dev)
                                 for x in (pssm, seq, la, lb))
    dchunk = gotoh_plan.fused_dchunk(la_max, lb_max)
    skewed = gotoh.skew_scores(pssm_t, int(PSSM_INIT)) if grid else None
    warps = gotoh_plan.resident_warps(la_max, lb_max,
                                      gotoh_cuda.smem_optin(dev))
    if resident and not warps:
        raise AssertionError(f"{la_max}x{lb_max} does not fit K-res")

    dirs_k, finals_k = gotoh_cuda.dp_forward(pssm_t, la_t, lb_t, go, ge)
    dirs_1, finals_1 = gotoh_cuda.dp_forward(pssm_t, la_t, lb_t, go, ge,
                                             cluster=1)
    dirs_p, finals_p = gotoh.dp_forward(pssm_t, la_t, lb_t, go, ge)
    tb_k = gotoh_cuda.dp_traceback(dirs_k, finals_k, la_t, lb_t, go, ge,
                                   seq_t)
    tb_p = gotoh.dp_traceback(dirs_p, finals_p, la_t, lb_t, go, ge, seq_t)
    if grid:
        dirs_g, finals_g = gotoh_cuda.dp_forward_grid(skewed, la_t, lb_t, go,
                                                      ge, dchunk)
        tb_g = gotoh_cuda.dp_traceback_grid(dirs_g, finals_g, la_t, lb_t, go,
                                            ge, seq_t, dchunk)
    if resident:
        tb_r = gotoh_cuda.align_resident(pssm_t, la_t, lb_t, go, ge, seq_t)
    torch.cuda.synchronize()
    # direction codes are defined on the valid cells (i <= la, d-i <= lb)
    d_idx = torch.arange(la_max + lb_max + 1, device=dev)[None, :, None]
    i_idx = torch.arange(la_max + 1, device=dev)[None, None, :]
    valid = (i_idx <= la_t[:, None, None]) & (d_idx - i_idx >= 0) \
        & (d_idx - i_idx <= lb_t[:, None, None])

    def dp_err(dirs, finals):
        return max(_max_abs_err(finals, finals_p),
                   _max_abs_err(torch.where(valid, dirs, 0),
                                torch.where(valid, dirs_p, 0)))

    def tb_err(tb):
        return max(_max_abs_err(g, w) for g, w in zip(tb, tb_p))

    errs = {"gotoh_dp": max(dp_err(dirs_k, finals_k), dp_err(dirs_1,
                                                             finals_1)),
            "gotoh_tb": tb_err(tb_k)}
    if grid:
        errs.update({
            "gotoh_grid_dp": dp_err(
                dirs_g[:la_max + lb_max + 1].permute(1, 0, 2), finals_g),
            "gotoh_grid_tb": tb_err(tb_g)})
    if resident:
        errs["gotoh_resident"] = tb_err(tb_r)
    if any(errs.values()):
        raise AssertionError(f"a DP kernel disagrees with the plain version "
                             f"at B={b} {la_max}x{lb_max}: {errs}")

    plain_dp = _time_ms(lambda: gotoh.dp_forward(pssm_t, la_t, lb_t, go, ge),
                        2)
    plain_tb = _time_ms(lambda: gotoh.dp_traceback(
        dirs_p, finals_p, la_t, lb_t, go, ge, seq_t), 2)

    k1_ms, k2_ms = _forward_then_walk(
        lambda: gotoh_cuda.dp_forward(pssm_t, la_t, lb_t, go, ge),
        lambda dirs, finals: gotoh_cuda.dp_traceback(
            dirs, finals, la_t, lb_t, go, ge, seq_t))
    k2_alone = _time_ms(lambda: gotoh_cuda.dp_traceback(
        dirs_k, finals_k, la_t, lb_t, go, ge, seq_t), 50)
    clusters = gotoh_cuda.cluster_size(b, la_max, lb_max, dev)
    k1_one = k1_ms if clusters == 1 else _time_ms(
        lambda: gotoh_cuda.dp_forward(pssm_t, la_t, lb_t, go, ge, cluster=1),
        50)
    times = {"gotoh_dp": (k1_ms, plain_dp), "gotoh_tb": (k2_ms, plain_tb)}
    if grid:
        grid_ms = _forward_then_walk(
            lambda: gotoh_cuda.dp_forward_grid(skewed, la_t, lb_t, go, ge,
                                               dchunk),
            lambda dirs, finals: gotoh_cuda.dp_traceback_grid(
                dirs, finals, la_t, lb_t, go, ge, seq_t, dchunk))
        times["gotoh_grid_dp"] = (grid_ms[0], plain_dp)
        times["gotoh_grid_tb"] = (grid_ms[1], plain_tb)
    if resident:
        times["gotoh_resident"] = (
            _time_ms(lambda: gotoh_cuda.align_resident(
                pssm_t, la_t, lb_t, go, ge, seq_t), 50), plain_dp + plain_tb)
    bounds = _dp_bounds(la.astype(np.int64), lb.astype(np.int64), la_max,
                        tb_p)
    shape = f"B={b} {la_max}x{lb_max}"
    for name, err in errs.items():
        ms, plain_ms = times[name]
        bound_ms, bound_by = bounds[name]
        label = f"{shape} dchunk={dchunk}" if "grid" in name else shape
        stats[name].append((label, err, ms, plain_ms, bound_ms, bound_by))
        print(f"  {name:16s} {label:24s} max_abs_err {err}  kernel "
              f"{ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} "
              f"ms ({bound_by})")
    print(f"  {'':16s} {shape:24s} K1 {clusters} CTA(s) per pair "
          f"{k1_ms:.4f} ms, 1 CTA per pair {k1_one:.4f} ms; K1 + K2 "
          f"{k1_ms + k2_ms:.4f} ms; K2 alone on warm codes {k2_alone:.4f} ms"
          + (f"; K-res on {warps} warps per pair" if resident else ""))


def _spread_phase(dev, stats, reps=50):
    """K1 alone on a lone 16S pair, B=1 1536x1536, where the wrapper
    spreads the pair's 49 strips over a cluster of up to 16 CTAs: on 4
    (the most a full card gives a pair), 8 and 16 CTAs per pair, and on the
    wrapper's choice, each exact against the plain forward, timed in turns
    (4, 8, 16, 16, 8, 4) beside the bound and the time a step.  A step is
    one of the ~3,490 of the strip model: strip k starts 40 steps (32 lanes
    and one block of 8) after strip k-1 and runs lb + 32 steps."""
    import torch

    from lara_tpu_torch.ops import gotoh, gotoh_cuda
    from lara_tpu_torch.types import PSSM_INIT

    go, ge = -49152, -16384
    n = 1536
    rng = np.random.default_rng(12)
    pssm = rng.integers(-9000, 9000, (1, n, n)).astype(np.int32)
    pssm[rng.random(pssm.shape) < 0.3] = PSSM_INIT
    pssm_t = torch.from_numpy(pssm).to(dev)
    la_t = lb_t = torch.full((1,), n, dtype=torch.int32, device=dev)
    chosen = gotoh_cuda.cluster_size(1, n, n, dev)
    sizes = sorted({4, 8, 16, chosen})
    dirs_p, finals_p = gotoh.dp_forward(pssm_t, la_t, lb_t, go, ge)
    d_idx = torch.arange(2 * n + 1, device=dev)[None, :, None]
    i_idx = torch.arange(n + 1, device=dev)[None, None, :]
    valid = (d_idx >= i_idx) & (d_idx - i_idx <= n)
    err = 0
    for c in sizes:
        dirs_k, finals_k = gotoh_cuda.dp_forward(pssm_t, la_t, lb_t, go, ge,
                                                 cluster=c)
        torch.cuda.synchronize()
        err = max(err, _max_abs_err(finals_k, finals_p),
                  _max_abs_err(torch.where(valid, dirs_k, 0),
                               torch.where(valid, dirs_p, 0)))
    if err:
        raise AssertionError(f"K1 on a lone 16S pair disagrees with the "
                             f"plain version: {err}")
    times = {c: [] for c in sizes}
    for c in sizes + sizes[::-1]:
        times[c].append(_time_ms(lambda: gotoh_cuda.dp_forward(
            pssm_t, la_t, lb_t, go, ge, cluster=c), reps))
    plain_ms = _time_ms(lambda: gotoh.dp_forward(pssm_t, la_t, lb_t, go, ge),
                        2)
    bound_ms, bound_by = _bound(4.0 * n * n + (n + 1) ** 2 + 12,
                                DP_OPS_PER_CELL * (n + 1) ** 2)
    strips = (n + 32) // 32
    steps = 40 * (strips - 1) + n + 32
    for c in sizes:
        ms = float(np.mean(times[c]))
        print(f"  gotoh_dp         B=1 {n}x{n} on {c:2d} CTAs per pair"
              f"{' (the wrapper)' if c == chosen else ''}: "
              f"{', '.join(f'{t:.4f}' for t in times[c])} ms, mean "
              f"{ms:.4f} ms, {1e6 * ms / steps:.1f} ns a step of {steps}; "
              f"bound {bound_ms:.4f} ms ({bound_by})")
    stats["gotoh_dp"].append((f"B=1 {n}x{n} ({chosen} CTAs)", err,
                              float(np.mean(times[chosen])), plain_ms,
                              bound_ms, bound_by))


def _placements(name, k1, sweep):
    """The CTAs per pair of the run just made (``_build.clusters``): K1
    launched on ``k1`` CTAs per pair and K4's sweep on ``sweep``, each
    on that placement alone."""
    from lara_tpu_torch import _build

    got = {}
    for (kernel, ctas), n in sorted(_build.clusters.items()):
        got.setdefault(kernel, {})[ctas] = n
    print(f"    CTAs per pair (launches): {got}")
    for kernel, ctas in (("gotoh_dp", k1), ("edge_sweep", sweep)):
        if set(got.get(kernel, {})) != {ctas}:
            raise AssertionError(f"{name}: {kernel} launched on "
                                 f"{got.get(kernel)} CTAs per pair, "
                                 f"expected {ctas} alone")


def _forward_then_walk(forward, walk):
    """(ms of ``forward``, ms of ``walk`` as the main path runs it): each rep
    of the pair runs ``forward`` and then ``walk`` on the codes and finals
    it has just written, and the walk's time is the pair's less the
    forward's."""
    forward_ms = _time_ms(forward, 50)
    pair_ms = _time_ms(lambda: walk(*forward()), 50)
    return forward_ms, pair_ms - forward_ms


#: KB's integer operations per element and step: the roll's where (two),
#: max and add, the h update's two adds and max, the where on t % cols
#: (two); the carry's where adds two
KB_OPS = 9
def _kb_phase(dev, stats):
    """KB against its plain version at the three layouts of
    ``benchmark/profile_wavefront_layout.py`` and reps 1, 2 and 5 on random
    inputs from a seed, and at the packed layout near INT32_MAX (the adds
    wrap), exactly; then the kernel and the plain version timed at reps 5,
    beside the bound (operations over 67 T/s), and the kernel alone at the
    source's hi (3600 blocks)."""
    import torch

    from lara_tpu_torch.benchmark import profile_wavefront_layout as kb

    rng = np.random.default_rng(11)
    for label, rows, cols, carry in kb.LAYOUTS:
        cases = [(f"reps {reps}", reps, rng.integers(-1000, 1000,
                                                     (rows, cols)))
                 for reps in (1, 2, 5)]
        if carry:
            cases.append(("reps 2 near INT32_MAX", 2,
                          2**31 - 1 - rng.integers(0, 300, (rows, cols))))
        err = 0
        for _what, reps, x in cases:
            x_t = torch.from_numpy(x.astype(np.int32)).to(dev)
            got = kb.chain(x_t, reps, carry)
            want = kb.chain_plain(x_t, reps, carry)
            torch.cuda.synchronize()
            err = max(err, _max_abs_err(got, want))
        if err:
            raise AssertionError(f"KB disagrees with the plain version at "
                                 f"{label}: {err}")
        x_t = torch.from_numpy(cases[0][2].astype(np.int32)).to(dev)
        ms = _time_ms(lambda: kb.chain(x_t, 5, carry), 20)
        plain_ms = _time_ms(lambda: kb.chain_plain(x_t, 5, carry), 2)
        hi_ms = _time_ms(lambda: kb.chain(x_t, 3600, carry), 3)
        steps = 5 * kb.BLOCK
        ops = float(steps) * rows * cols * (KB_OPS + 2 * carry) \
            + rows * cols
        bound_ms, bound_by = _bound(8.0 * rows * cols, ops)
        shape = f"[{rows},{cols}]" + (" carry" if carry else "")
        stats["wavefront_chain"].append(
            (shape, err, ms, plain_ms, bound_ms, bound_by,
             {"reps": 5, "ms_at_hi": round(hi_ms, 6)}))
        print(f"  {'wavefront_chain':16s} {shape:24s} max_abs_err {err} "
              f"(reps 1, 2, 5{', 2 near INT32_MAX' if carry else ''})  "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms at reps 5  "
              f"bound {bound_ms:.6f} ms ({bound_by}); kernel at reps 3600 "
              f"{hi_ms:.4f} ms")


def _loop_exit_phase(dev, stats):
    """The loop exit (``csrc/loop_exit.cu``: its kernel before the first
    trip, KI-tail's last CTA after each) against its plain version,
    PyTorch's ``lane_active.any()``, and the iteration budget, at the tRNA
    chunk's 128 lanes, D and slots and the 16S chunk's 32: the graph of a
    dispatch around a body that counts its runs and runs KI-tail in place
    on ``tail_cases.tail_inputs`` (as the fused solver's graph runs it),
    launched with 3 iterations left and no lane, the last, the first,
    half of them at random and every lane active (KI-tail keeps each lane
    as it is: the body must run 3 times exactly when ``any()`` holds, and
    be counted), with 7 left (the budget running out), and with every lane
    ending on the body's second run (``remaining`` 2, 5 left): bodies run
    equal to ``counters[1]``, KI-tail's ticket 0 after each launch; and
    KI-tail launched eagerly and the capture replayed bare leave the
    counters as they were (no condition set outside the loop).  Timed
    beside ``any()`` (the row's plain version and library call) and the
    bound (the lanes' bytes and the counters', read once): the graph
    replayed with no lane active (the pre-loop kernel and a WHILE node
    that does not run: the row's time), the same dispatch with the host's
    counter writes (the cost of the dispatch after the last lane
    finishes), and one turn of the loop (launches of 200 turns) beside
    the body's capture replayed bare."""
    import torch

    from lara_tpu_torch.solver import dispatch_graph, iteration_cuda
    from lara_tpu_torch.solver import tail_cases

    nd = tail_cases.MAX_NONDECR
    rng = np.random.default_rng(13)
    for lanes, d, slots in ((128, 1024, 96), (32, 3072, 1536)):
        counters = torch.zeros(4, dtype=torch.int32, device=dev)
        runs = torch.zeros((), dtype=torch.int32, device=dev)
        # the body updates the carry c in place, and c.lane_active is the
        # loop's predicate
        c, tb, ln, match = tail_cases.tail_inputs(
            lanes, d, slots, 70 + lanes, dev, remaining=10**6)
        graph = dispatch_graph.CudaGraph(dev)
        graph.capture(lambda: (runs.add_(1), iteration_cuda.tail(
            c, c.dual_at_queue, tb, ln, match, nd, out=c)), c.lane_active,
            counters)

        def launch(left):
            counters[0].fill_(left)
            counters[1:].zero_()
            graph.replay()

        def check(what, left, want):
            got = (int(runs), int(counters[1]), int(counters[0]),
                   int(counters[2:].abs().sum()))
            if got != (want, want, left - want, 0):
                raise AssertionError(
                    f"the loop exit at {lanes} lanes, {what}: (bodies, "
                    f"counters) {got}, expected "
                    f"{(want, want, left - want, 0)}")

        masks = [np.zeros(lanes, bool), np.arange(lanes) == lanes - 1,
                 np.arange(lanes) == 0, rng.random(lanes) < 0.5,
                 np.ones(lanes, bool)]
        cases = [(f"mask {k}", m, 10**6, 3) for k, m in enumerate(masks)]
        cases += [("the budget running out", masks[-1], 10**6, 7),
                  ("every lane ends on the second run", masks[-1], 2, 5)]
        for what, mask, remaining, left in cases:
            c.lane_active.copy_(torch.from_numpy(mask))
            c.remaining.fill_(remaining)
            runs.zero_()
            launch(left)
            want = min(remaining, left) * int(mask.any())
            check(what, left, want)
        # KI-tail eagerly and the capture bare, after a run: no condition
        # set, the counters as they were
        c.lane_active.fill_(True)
        c.remaining.fill_(10**6)
        runs.zero_()
        launch(3)
        graph._graph.instantiate()
        iteration_cuda.tail(c, c.dual_at_queue, tb, ln, match, nd, out=c)
        graph._graph.replay()
        runs.sub_(1)
        check("then KI-tail eager and the capture bare", 3, 3)
        runs.zero_()
        launch(4)
        check("then the loop again", 4, 4)

        turn_ms = _time_ms(lambda: launch(200), 10) / 200
        # the same body replayed bare, 200 replays queued while the card
        # sleeps: what the WHILE node adds to a turn
        bare_ms = _time_ms(lambda: [graph._graph.replay()
                                    for _ in range(200)], 2) / 200
        c.lane_active.zero_()
        launch(1)
        ms = _time_ms(graph.replay, 200)
        idle_ms = _time_ms(lambda: launch(125), 200)
        plain_ms = _time_ms(lambda: c.lane_active.any(), 200)
        graph.close()
        bound_ms, bound_by = _bound(lanes + 8.0, float(lanes))
        shape = f"B={lanes}"
        stats["loop_exit"].append((shape, 0, ms, plain_ms, bound_ms,
                                   bound_by, {
                                       "idle_dispatch_ms": round(idle_ms, 6),
                                       "turn_ms": round(turn_ms, 6),
                                       "bare_body_ms": round(bare_ms, 6)}))
        print(f"  {'loop_exit':16s} {shape:24s} max_abs_err 0 (none, last, "
              f"first, random, all active; the budget; every lane ending "
              f"on the second run; eager and bare untouched; ticket 0; "
              f"KI-tail at D={d} slots={slots})  the dispatch's graph "
              f"with no lane active {ms:.4f} ms, with the counter writes "
              f"{idle_ms:.4f} ms  any() {plain_ms:.4f} ms  bound "
              f"{bound_ms:.8f} ms ({bound_by}); a turn of the loop "
              f"{turn_ms:.4f} ms, the body replayed bare {bare_ms:.4f} ms")


def _structure_free_path(dev, tmp):
    """The bench's tRNA family without its base-pair edges (120 pairs, one
    96x96 chunk, every lane done in its first iteration; the
    structure-free family of ``benchmark/PROFILE.md:208-212``) through
    ``app.run``: a record of the input file that has no structure is
    folded when it is read, so the records are cleared of their edges as
    ``app.load_input`` returns them.  Every pair equal to native, K1, K2
    and K3 launched once (the JAX loop's one trip) in the 250 iterations
    dispatched (the first dispatch and the late one), and the solve phase
    beside the capture's seconds.  Returns the run's launch counts."""
    from lara_tpu_torch.utils import timing
    from lara_tpu_torch.workloads import make_family

    def clear(store):
        for record in store:
            record.bpp_edges, record.fixed_edges = [], []

    label = "trna-72nt-structure-free"
    run = _main_path(label, make_family(n=16), dev, tmp,
                     FUSED_ITERATION + K4, edit=clear)
    ran = _exact_launches(label, run[0], run[3].results, 1)
    if ran != [(1, 250)]:
        raise AssertionError(f"{label}: ran {ran}, expected one iteration "
                             "of 250 dispatched")
    phases = timing.snapshot()
    solve_s = phases["subgradient solve (device)"]
    capture_s = phases["graph capture"]
    print(f"    {label}: solve phase {solve_s:.6f} s, of it the capture "
          f"{capture_s:.6f} s, the rest {solve_s - capture_s:.6f} s")
    return run[0]


def _kb_path():
    """KB's own entry point, ``profile_wavefront_layout.main`` with the
    source's defaults (lo 400, hi 3600, 3 calls per point): the launch
    counts are set to 0 just before it and read just after it, and only KB
    may have launched.  Then the SM clock under a load like KB's, one CTA
    on one SM: ``torch.cuda._sleep`` spins a known count of SM cycles, timed
    with CUDA events (least of 5), and each layout's step in those cycles.
    Returns (launch counts, {label: s per step})."""
    import torch

    from lara_tpu_torch import _build
    from lara_tpu_torch.benchmark import profile_wavefront_layout as kb

    _build.reset_launches()
    per_step = kb.main([])
    launches = dict(_build.launches)
    launched = {k for k, n in launches.items() if n}
    if launched != {"wavefront_chain"}:
        raise AssertionError(f"the KB run launched {sorted(launched)}")
    print(f"    launches: {launches}")
    cycles = 20_000_000
    spin_ms = min(_time_ms(lambda: torch.cuda._sleep(cycles), 1)
                  for _ in range(5))
    mhz = cycles / (spin_ms * 1e3)
    print(f"    SM clock, one CTA spinning {cycles} cycles: {mhz:.1f} MHz; "
          "a step in cycles at that clock: " + ", ".join(
              f"{label} {per * mhz * 1e6:.1f}"
              for label, per in per_step.items()))
    return launches, per_step


def _edge_phase(b, la_max, lb_max, seed, dev, stats):
    """K4 against its plain versions on one random batch of Rna5 residues
    (ragged lanes, one full size, padded with 4 as the driver pads), the
    default parameters' gaps and subopt: the sweep's prefixes on the cells
    inside both halves' rectangles and its finals, the pack on the sweep's
    own output (row-major words), and the wrapper's words against the
    plain filter (two scans).  Each is timed beside its bound; returns K4's
    ms (sweep and pack, as the driver calls them)."""
    import torch

    from lara_tpu_torch.ops import gotoh, gotoh_cuda
    from lara_tpu_torch.params import Parameters
    from lara_tpu_torch.types import f2i

    params = Parameters(in_file="<smoke>")
    go, ge = int(params.gap_open_int), int(params.gap_extend_int)
    subopt = int(f2i(params.suboptimal_diff))
    rng = np.random.default_rng(seed)
    la = rng.integers(1, la_max + 1, b).astype(np.int32)
    lb = rng.integers(1, lb_max + 1, b).astype(np.int32)
    la[:3], lb[:3] = (1, la_max, la_max), (lb_max, 1, lb_max)
    seq_a = np.full((b, la_max), 4, np.int32)
    seq_b = np.full((b, lb_max), 4, np.int32)
    for k in range(b):
        seq_a[k, :la[k]] = rng.integers(0, 4, la[k])
        seq_b[k, :lb[k]] = rng.integers(0, 4, lb[k])
    inputs = tuple(torch.from_numpy(x).to(dev) for x in (
        seq_a, seq_b, la, lb, np.asarray(params.score_matrix, np.int32)))

    prefix_k, finals_k = gotoh_cuda.edge_sweep(*inputs, go, ge)
    words_k = gotoh_cuda.edge_pack(prefix_k, finals_k, *inputs, subopt)
    filter_k = gotoh_cuda.edge_filter_active_words(*inputs, go, ge, subopt,
                                                   la_max, lb_max)
    prefix_p, finals_p = gotoh.edge_sweep(*inputs, go, ge)
    words_p = gotoh.edge_pack(prefix_k, finals_k, *inputs, subopt)
    filter_p = gotoh.edge_filter_active_words(*inputs, go, ge, subopt,
                                              la_max, lb_max)
    torch.cuda.synchronize()
    la2, lb2 = (torch.cat([x, x]) for x in inputs[2:4])
    d_idx = torch.arange(la_max + lb_max + 1, device=dev)[None, :, None]
    i_idx = torch.arange(la_max + 1, device=dev)[None, None, :]
    valid = (i_idx <= la2[:, None, None]) & (d_idx >= i_idx) \
        & (d_idx - i_idx <= lb2[:, None, None])
    errs = {"edge_sweep": max(
                _max_abs_err(finals_k, finals_p),
                _max_abs_err(torch.where(valid, prefix_k, 0),
                             torch.where(valid, prefix_p, 0))),
            "edge_pack": _max_abs_err(words_k, words_p)}
    filter_err = _max_abs_err(filter_k, filter_p)
    if any(errs.values()) or filter_err:
        raise AssertionError(f"K4 disagrees with the plain version at B={b} "
                             f"{la_max}x{lb_max}: {errs}, words "
                             f"{filter_err}")

    times = {
        "edge_sweep": (
            _time_ms(lambda: gotoh_cuda.edge_sweep(*inputs, go, ge), 20),
            _time_ms(lambda: gotoh.edge_sweep(*inputs, go, ge), 1)),
        "edge_pack": (
            _time_ms(lambda: gotoh_cuda.edge_pack(prefix_k, finals_k,
                                                  *inputs, subopt), 20),
            _time_ms(lambda: gotoh.edge_pack(prefix_k, finals_k, *inputs,
                                             subopt), 1))}
    k4_ms = _time_ms(lambda: gotoh_cuda.edge_filter_active_words(
        *inputs, go, ge, subopt, la_max, lb_max), 20)
    plain_ms = _time_ms(lambda: gotoh.edge_filter_active_words(
        *inputs, go, ge, subopt, la_max, lb_max), 1)
    # bounds from this batch: the sweep writes the prefix of every valid
    # cell of both halves (2 x 21 operations per cell); the pack reads two
    # prefixes per edge and writes the words; the whole filter reads the
    # sequences and writes the words
    cells = float(((la.astype(np.int64) + 1) * (lb + 1)).sum())
    edges = float((la.astype(np.int64) * lb).sum())
    in_bytes = 4.0 * (seq_a.size + seq_b.size + 2 * b + 25)
    out_bytes = 4.0 * words_k.numel()
    bounds = {
        "edge_sweep": _bound(in_bytes + 8.0 * cells + 24 * b,
                             2 * DP_OPS_PER_CELL * cells),
        "edge_pack": _bound(8.0 * edges + in_bytes + 24 * b + out_bytes,
                            4.0 * edges)}
    k4_bound, k4_by = _bound(in_bytes + out_bytes, 2 * DP_OPS_PER_CELL * cells)
    shape = f"B={b} {la_max}x{lb_max}"
    for name, err in errs.items():
        ms, plain = times[name]
        bound_ms, bound_by = bounds[name]
        stats[name].append((shape, err, ms, plain, bound_ms, bound_by))
        print(f"  {name:16s} {shape:24s} max_abs_err {err}  kernel "
              f"{ms:.4f} ms  plain {plain:.4f} ms  bound {bound_ms:.4f} "
              f"ms ({bound_by})")
    clusters = gotoh_cuda.cluster_size(2 * b, la_max, lb_max, dev)
    print(f"  {'K4':16s} {shape:24s} words max_abs_err {filter_err}  sweep + "
          f"pack {k4_ms:.4f} ms ({clusters} CTA(s) per lane)  plain filter "
          f"{plain_ms:.4f} ms  bound {k4_bound:.4f} ms ({k4_by})")
    return k4_ms


def _matching_case(b, width, slots, seed):
    """Queue-ordered candidate columns with exact weight ties among dead
    columns (the fuzz of tests/test_matching_pallas.py at bench widths)."""
    rng = np.random.default_rng(seed)
    n_edges = slots * slots
    lq = np.zeros((b, width), np.int32)
    mq = np.zeros((b, width), np.int32)
    wq = np.zeros((b, width), np.int32)
    live = np.zeros((b, width), bool)
    line = np.full((b, slots), n_edges, np.int32)
    for k in range(b):
        n_lines = int(rng.integers(2, slots))
        lines = np.sort(rng.choice(n_edges, n_lines, replace=False))
        line[k, :n_lines] = lines
        inter = set()
        for _ in range(int(rng.integers(0, width // 2))):
            x, y = rng.choice(n_lines, 2, replace=False)
            l, m = sorted((int(lines[x]), int(lines[y])))
            inter.add((l, m, int(rng.integers(0, 6)) * 2))
        order = sorted(inter, key=lambda t: (-t[2], t[0], t[1]))
        cols = np.sort(rng.choice(width, len(order), replace=False))
        for c, (l, m, w) in zip(cols, order):
            lq[k, c], mq[k, c], wq[k, c], live[k, c] = l, m, w, True
    return lq, mq, wq, live, line


@contextlib.contextmanager
def _counted_rounds():
    """A list that gets, for every round of the plain loop
    (``matching_device.rounds_loop`` calls ``_solve_conflicts_enum`` once
    a round), the number of lanes still engaged in it: its length is the
    rounds of the longest lane, as the kernel runs them."""
    from lara_tpu_torch.solver import matching_device

    engaged = []
    solve = matching_device._solve_conflicts_enum

    def spy(sel_l, sel_m, sel_w, sel_cnt, lanes, lh):
        engaged.append(int(lanes.sum()))
        return solve(sel_l, sel_m, sel_w, sel_cnt, lanes, lh)

    matching_device._solve_conflicts_enum = spy
    try:
        yield engaged
    finally:
        matching_device._solve_conflicts_enum = solve


def _hold_matching(label, args, lookahead, stats, time_plain=True):
    """K3 against the plain version on ``args`` (fatal on any difference),
    timed with CUDA events beside its bound, with the rounds of the
    longest lane and the time per round."""
    import torch

    from lara_tpu_torch.solver import matching_cuda, matching_device

    got = matching_cuda.rounds_loop_cuda(*args, lookahead)
    with _counted_rounds() as engaged:
        want = matching_device.rounds_loop(*args, lookahead)
    torch.cuda.synchronize()
    err = max(_max_abs_err(got.score, want.score),
              _max_abs_err(got.used_slot, want.used_slot))
    if err:
        raise AssertionError(f"K3 disagrees with the plain version at "
                             f"{label}: {err}")
    ms = _time_ms(lambda: matching_cuda.rounds_loop_cuda(*args, lookahead), 20)
    plain_ms = _time_ms(
        lambda: matching_device.rounds_loop(*args, lookahead),
        2) if time_plain else None
    # bound: each input read once, each output written once; one subset
    # evaluation of the 2^lh memo per live column
    nbytes = sum(x.numel() * x.element_size() for x in args) \
        + got.score.numel() * 4 + got.used_slot.numel()
    bound_ms, bound_by = _bound(nbytes,
                                float(args[3].sum()) * 2 ** lookahead)
    rounds = len(engaged)
    stats["matching_rounds"].append((label, err, ms, plain_ms, bound_ms,
                                     bound_by, {"rounds": rounds}))
    plain = f"{plain_ms:.4f} ms" if plain_ms is not None else "not timed"
    print(f"  {'matching_rounds':16s} {label:24s} max_abs_err {err}  kernel "
          f"{ms:.4f} ms  plain {plain}  bound {bound_ms:.4f} ms "
          f"({bound_by}); longest lane {rounds} rounds, "
          f"{1e3 * ms / max(rounds, 1):.3f} us per round, mean "
          f"{sum(engaged) / max(len(args[0]), 1):.1f} rounds a lane")


def _matching_phase(b, width, slots, lookahead, seed, dev, stats):
    import torch

    args = [torch.from_numpy(x).to(dev)
            for x in _matching_case(b, width, slots, seed)]
    _hold_matching(f"B={b} W={width} S={slots} lh={lookahead}", args,
                   lookahead, stats)


def _native_check(name, store, pairs, params, run, library, threads):
    """Every pair of ``run`` against the native C++ baseline at full depth,
    and the library bytes against the one built from the native results.
    The native pairs run on ``threads`` host threads (the native library
    releases the GIL).  Returns (seconds, pairs) of one lone host thread:
    all pairs when ``threads`` is 1, else three evenly spaced pairs solved
    again one after another, since threads running together slow each
    other."""
    from concurrent.futures import ThreadPoolExecutor

    from lara_tpu_torch.io.writers import OutputLibrary
    from lara_tpu_torch.native import baseline as native_baseline
    from lara_tpu_torch.workloads import full_depth_ok

    def solve(pair):
        start = time.perf_counter()
        nat = native_baseline.solve_pair(store[pair[0]], store[pair[1]],
                                         params, pair)
        return nat, time.perf_counter() - start

    by_pair = {r.seq_indices: r for r in run.results}
    native_lib = OutputLibrary(store, "lib")
    pair_seconds = 0.0
    with ThreadPoolExecutor(max_workers=threads) as pool:
        for nat, seconds in pool.map(solve, pairs):
            pair_seconds += seconds
            dev_res = by_pair[nat.seq_indices]
            if not full_depth_ok(dev_res, nat.columns, nat.best_lower,
                                  nat.best_upper, nat.iterations):
                raise AssertionError(f"{name}: pair {nat.seq_indices} "
                                     "differs from the native baseline")
            native_lib.add_alignment(nat.seq_indices, nat.columns, nat.score)
    if len(run.results) != len(pairs) or native_lib.to_string() != library:
        raise AssertionError(f"{name}: library differs from the native one")
    if threads == 1:
        return pair_seconds, len(pairs)
    alone = pairs[::-(-len(pairs) // 3)]  # three pairs, evenly spaced
    return sum(solve(pair)[1] for pair in alone), len(alone)


@contextlib.contextmanager
def _filtered_chunks():
    """A list that gets the pairs of every chunk that
    ``device_driver._filter_and_build`` (every path's edge filter) takes."""
    from lara_tpu_torch.solver import device_driver

    chunks = []
    real = device_driver._filter_and_build

    def spy(store, chunk, *args):
        chunks.append(len(chunk))
        return real(store, chunk, *args)

    device_driver._filter_and_build = spy
    try:
        yield chunks
    finally:
        device_driver._filter_and_build = real


class _Dispatch:
    """One graphed dispatch: its key, its replays, and the lanes'
    iterations before and after it (copies on the card, read later)."""

    def __init__(self, key, steps, before, after):
        self.key, self.steps = key, steps
        self._before, self._after = before, after

    def executed(self) -> int:
        """Iterations the loop exit let run: the largest per-lane
        increase (lanes only go inactive within a dispatch)."""
        return int((self._after - self._before).max())


@contextlib.contextmanager
def _graph_dispatches():
    """A list that gets a :class:`_Dispatch` for every dispatch that
    ``dispatch_graph.run`` replays as a CUDA graph."""
    from lara_tpu_torch.solver import dispatch_graph

    dispatches = []
    real = dispatch_graph.run

    def spy(model, carry, key, steps):
        before = carry.iterations.clone()
        out = real(model, carry, key, steps)
        dispatches.append(_Dispatch(key, steps, before,
                                    out.iterations.clone()))
        return out

    dispatch_graph.run = spy
    try:
        yield dispatches
    finally:
        dispatch_graph.run = real


@contextlib.contextmanager
def _uploads():
    """A list that gets (layout, bytes, bytes of the ten arrays) for every
    model upload of the driver: a packed buffer (``packed15`` or
    ``packed_seq``), on any number of devices."""
    from lara_tpu_torch.solver import device_driver

    sent = []
    packed = device_driver._packed_buffer

    def spy_packed(models, la_max, lb_max, dcap, n, *args, **kw):
        buf = packed(models, la_max, lb_max, dcap, n, *args, **kw)
        sent.append((device_driver._packed_mode(la_max, lb_max, dcap),
                     buf.numel() * buf.element_size(),
                     _raw_bytes(la_max, lb_max, n, dcap)))
        return buf

    device_driver._packed_buffer = spy_packed
    try:
        yield sent
    finally:
        device_driver._packed_buffer = packed


def _raw_bytes(la_max, lb_max, lanes, dcap):
    """Bytes of the ten arrays of a chunk (``_model_rows``): the int32
    seq-score and bool active grids, five int32 and one bool dual column,
    la and lb."""
    return lanes * (5 * la_max * lb_max + 21 * dcap + 8)


@contextlib.contextmanager
def _loaded_as(edit):
    """``app.load_input`` returns its records after ``edit`` changed them
    in place (nothing where ``edit`` is None)."""
    from lara_tpu_torch import app

    real = app.load_input

    def load(params):
        store = real(params)
        edit(store)
        return store

    if edit is not None:
        app.load_input = load
    try:
        yield
    finally:
        app.load_input = real


def _main_path(label, records, dev, tmp, expect, matching=5, env=None,
               native_threads=1, same_as=None, devices=None, graphed=True,
               edit=None, **params_kw):
    """One run of the port's CLI path on a family (``records``, or the
    path of an input file), on ``dev`` or split over ``devices``.  The
    launch counts are set to 0 just before the run and read just after it;
    the kernels that launched must be exactly ``expect``, and K4's two
    exactly once per chunk the run filtered.  A fused run (K3 in
    ``expect``) must dispatch through CUDA graphs, and only through them,
    unless ``graphed`` is false (the eager loop patched in).  Every pair is
    checked against the native C++ baseline (on ``native_threads``
    threads), or, with ``same_as`` (an earlier run's (library, results)),
    the library bytes against that library and every pair against that
    run's.  ``edit`` changes the records that the run and the check read
    (:func:`_loaded_as`).  Returns (counts, library, wall seconds, run)."""
    import torch

    from lara_tpu_torch import _build, app
    from lara_tpu_torch.io.writers import write_ebpseq
    from lara_tpu_torch.params import Parameters
    from lara_tpu_torch.solver import device_driver, hybrid_driver
    from lara_tpu_torch.utils import timing

    env = env or {}
    fused = "matching_rounds" in expect
    if fused and graphed:
        # every replay of a graphed dispatch runs the loop exit's kernel
        # once
        expect = tuple(expect) + ("loop_exit",)
    name = f"{label} -m {matching}" + "".join(f" {k}={v}"
                                              for k, v in env.items())
    if devices:
        name += f" over {len(devices)} shards"
    if isinstance(records, str):
        path = records
    else:
        path = os.path.join(tmp, f"{label}.ebpseq")
        with open(path, "w") as handle:
            write_ebpseq(records, handle)
    params = Parameters(in_file=path, out_file=os.path.join(tmp, f"{label}.lib"),
                        matching=matching, **params_kw)
    os.environ.update(env)
    try:
        with _filtered_chunks() as chunks, _graph_dispatches() as graphs, \
                _uploads() as uploads, _loaded_as(edit):
            _build.reset_launches()
            hybrid_driver.turns = hybrid_driver.replays = 0
            start = time.perf_counter()
            run = app.run(params, dev, devices)
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            launches = dict(_build.launches)
    finally:
        for key in env:
            del os.environ[key]
    if bool(graphs) != (fused and graphed):
        raise AssertionError(f"{name}: {len(graphs)} graphed dispatches "
                             f"(fused {fused}, graphed {graphed})")
    phases = timing.snapshot()
    with open(params.out_file) as handle:
        library = handle.read()
    launched = {k for k, n in launches.items() if n}
    if launched != set(expect):
        raise AssertionError(f"{name}: launched {sorted(launched)}, expected "
                             f"{sorted(expect)} ({launches})")
    if not launches["edge_sweep"] == launches["edge_pack"] == len(chunks):
        raise AssertionError(f"{name}: K4 launched {launches['edge_sweep']} "
                             f"sweeps and {launches['edge_pack']} packs for "
                             f"{len(chunks)} filtered chunks {chunks}")

    with _loaded_as(edit):
        store = app.load_input(params)
    pairs = app.enumerate_pairs(store)
    iters = [r.iterations for r in run.results]
    if same_as is not None:
        if library != same_as[0] or _pair_keys(run.results) != _pair_keys(
                same_as[1]) or len(run.results) != len(pairs):
            raise AssertionError(f"{name}: library or pairs differ from the "
                                 "ones of the run before")
        checked = "the same library bytes and pairs as the run before"
    else:
        native_s, native_n = _native_check(name, store, pairs, params, run,
                                           library, native_threads)
        checked = "all equal to the native baseline"
    print(f"  {name}: {len(pairs)} pairs of "
          f"{max(len(r.sequence) for r in store)} nt, {checked}; wall "
          f"{wall:.3f} s, {len(pairs) / wall:.3f} alignments/s, mean "
          f"iterations {np.mean(iters):.1f} (max {max(iters)})")
    print("    phases: " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items()))
    if hybrid_driver.turns:
        turns = hybrid_driver.turns
        buckets = len(device_driver.buckets_of(store, pairs))
        if turns - hybrid_driver.replays != buckets:
            raise AssertionError(
                f"{name}: {hybrid_driver.replays} of {turns} device steps "
                f"replayed a graph, expected all but the first of each of "
                f"{buckets} bucket(s)")
        print(f"    hybrid: {turns} batched iterations, per iteration "
              f"{1e3 * phases['hybrid device step'] / turns:.3f} ms device "
              f"step (uploads, DP, download; graphed: "
              f"{hybrid_driver.replays} replays, the first step of each of "
              f"{buckets} bucket(s) eager) + "
              f"{1e3 * phases['hybrid host step'] / turns:.3f} ms host step")
    if graphs:
        executed = [g.executed() for g in graphs]
        if sum(executed) != launches["matching_rounds"] or \
                len(graphs) != launches["loop_exit"]:
            raise AssertionError(
                f"{name}: the dispatches ran {executed} of "
                f"{[g.steps for g in graphs]} iterations, the counts say "
                f"K3 {launches['matching_rounds']}, loop exit "
                f"{launches['loop_exit']}")
        print("    dispatches, iterations run of those dispatched: "
              + ", ".join(f"{e}/{g.steps}"
                          for e, g in zip(executed, graphs)))
    if uploads:
        print(f"    model uploads: {len(uploads)}, MB (as the ten arrays): "
              + ", ".join(f"{kind} {b / 1e6:.3f} ({r / 1e6:.3f})"
                          for kind, b, r in uploads[:4])
              + (" ..." if len(uploads) > 4 else ""))
    if same_as is None:
        timed = "same pairs" if native_n == len(pairs) else \
            f"{native_n} evenly spaced pairs, run alone after the check on " \
            f"{native_threads} threads"
        print(f"    native C++ baseline, one host thread, {timed}: "
              f"{native_s:.3f} s, {native_n / native_s:.3f} alignments/s")
    print(f"    launches: {launches}; {len(chunks)} chunk(s) filtered "
          f"({', '.join(map(str, chunks))} pairs); {len(graphs)} graphed "
          f"dispatch(es) over {len({g.key for g in graphs})} key(s)")
    return launches, library, wall, run


def _pair_keys(results):
    return sorted((r.seq_indices, r.columns, r.score, r.iterations,
                   r.best_upper, r.best_lower) for r in results)


@contextlib.contextmanager
def _pipelined_chunks():
    """A list that gets (pairs, on a CUDA stream of its own) for every
    chunk the cross-chunk pipeline's solver thread runs."""
    from lara_tpu_torch.solver import device_driver

    solved = []
    solve_on = device_driver._solve_on

    def spy(stream, prep, params):
        solved.append((len(prep.chunk), stream is not None))
        return solve_on(stream, prep, params)

    device_driver._solve_on = spy
    try:
        yield solved
    finally:
        device_driver._solve_on = solve_on


def _long_path(family, dev, tmp, expect, k4_ms):
    """The 16S family, one 1536x1536 bucket of 28 pairs.  By default it is
    one chunk of 32 lanes, neither split nor pipelined; every pair is
    checked against the native baseline on a thread pool.  Then
    ``LARA_SPLIT_SINGLE=1 LARA_PIPELINE=1`` (two halves of 14 pairs, 16
    lanes each, through the pipeline on the solver thread's stream) and the
    default again must write the same library bytes.  The default
    run's "edge filter (device)" phase is printed beside ``k4_ms``, K4's
    time at B=32 1536x1536 in phase 2.  Returns the default run's (launch
    counts, library, wall, run)."""
    from lara_tpu_torch.utils import timing

    walls = {}
    with _pipelined_chunks() as solved:
        default = _main_path(*family, dev, tmp, expect,
                             native_threads=os.cpu_count() or 1)
        _placements("16S default", 4, 2)  # 32 and 64 lanes on 132 SMs
        _exact_launches("16S default", default[0], default[3].results, 1)
        filter_s = timing.snapshot()["edge filter (device)"]
        print(f"    16S edge filter (device) phase {filter_s:.3f} s for one "
              f"chunk; K4's kernels (sweep + pack) at B=32 1536x1536 "
              f"{k4_ms:.4f} ms in phase 2; the rest is the upload, the "
              "download of the words and their unpacking on the host")
        walls["default"] = default[2]
        same = (default[1], default[3].results)
        if solved:
            raise AssertionError(f"16S default ran the pipeline: {solved}")
        walls["split + pipelined"] = _main_path(
            *family, dev, tmp, expect,
            env={"LARA_SPLIT_SINGLE": "1", "LARA_PIPELINE": "1"},
            same_as=same)[2]
        if solved != [(14, True), (14, True)]:
            raise AssertionError(f"16S did not split and pipeline: {solved}")
    walls["default again"] = _main_path(*family, dev, tmp, expect,
                                        same_as=same)[2]
    print("    16S wall: " + ", ".join(f"{k} {v:.3f} s"
                                       for k, v in walls.items())
          + " (pipelined phase times overlap and sum past the wall)")
    return default


def _mixed_path(family, dev, tmp, expect):
    """A family of mixed lengths: three buckets (96x96, 96x320, 320x320),
    solved one after another by default.  Every pair is checked against
    the native baseline on one thread (pair costs differ too much for a
    sample of three), then ``LARA_PIPELINE=1`` and the default run in
    turns (serial, pipelined, serial, pipelined), each with the same
    library bytes, and the pipelined runs must put all three buckets
    through the solver thread's stream.  Returns the first run's launch
    counts."""
    with _pipelined_chunks() as solved:
        run, library, wall, first = _main_path(*family, dev, tmp, expect)
        walls = {"default (serial)": [wall], "LARA_PIPELINE=1": []}
        for key in ("LARA_PIPELINE=1", "default (serial)",
                    "LARA_PIPELINE=1"):
            env = {"LARA_PIPELINE": "1"} if key == "LARA_PIPELINE=1" else {}
            walls[key].append(_main_path(*family, dev, tmp, expect, env=env,
                                         same_as=(library,
                                                  first.results))[2])
    if len(solved) != 6 or not all(on_stream for _, on_stream in solved):
        raise AssertionError("the pipelined runs did not put 3 chunks each "
                             f"through the solver stream: {solved}")
    print("    mixed wall, in turns: " + "; ".join(
        f"{k} " + ", ".join(f"{w:.3f}" for w in v) + " s"
        for k, v in walls.items()))
    return run


#: the fused path's DP and matching kernels, by default and under
#: ``LARA_DP_GRID=1``
FUSED_ITERATION = ("gotoh_dp", "gotoh_tb", "matching_rounds") + BODY
GRID_ITERATION = ("gotoh_grid_dp", "gotoh_grid_tb", "matching_rounds") \
    + BODY


def _dispatched(longest, n_iter=500):
    """(iterations dispatched, dispatches) for a shard whose longest lane
    ran ``longest``: ``solve_batch``'s dispatches, as the JAX package's
    (``lara_tpu/solver/device_solver.py:284-297``), each flag read one
    dispatch late, so the dispatch after the one in which the last lane
    finished is issued too."""
    from lara_tpu_torch.solver import device_solver

    chunk, total, count, pending = device_solver.dispatch_size(), 0, 0, None
    while total < n_iter:
        total += min(chunk, n_iter - total)
        count += 1
        if pending is False:
            break
        pending = longest > total if total < n_iter else None
    return total, count


def _exact_launches(name, launches, results, shards,
                    kernels=FUSED_ITERATION, graphed=True):
    """Gate: a fused run of one chunk over ``shards`` shards launched each
    of ``kernels`` (K1, K2 and K3, or K1-grid, K2-grid and K3) exactly once
    per iteration the JAX ``while_loop`` would run: each shard's longest
    lane's iterations, the loop exit ending each dispatch there; and the
    loop exit's kernel once per dispatch (:func:`_dispatched`; KI-tail
    evaluates the exit after each iteration).  The eager loop on the card
    (``graphed`` false) runs every dispatched iteration.  Lane k holds the
    chunk's pair k (results in task order), the lanes pad to
    ``device_driver._padded_batch`` and then to a multiple of the shards
    (padding lanes converge in one iteration).  Returns each shard's
    (iterations run, iterations dispatched)."""
    from lara_tpu_torch.solver import device_driver

    lanes = device_driver._padded_batch(len(results), shards)
    lanes += (-lanes) % shards
    iters = [r.iterations for r in results] + [1] * (lanes - len(results))
    per = lanes // shards
    longest = [max(iters[k * per:(k + 1) * per]) for k in range(shards)]
    dispatched = [_dispatched(n) for n in longest]
    steps = [total for total, _ in dispatched]
    want = dict.fromkeys(kernels, sum(longest if graphed else steps))
    if graphed:
        want["loop_exit"] = sum(count for _, count in dispatched)
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"{name}: launched {got}, expected {want} "
                             f"({shards} shard(s) of {per} lanes running "
                             f"{longest} of {steps} iterations)")
    return list(zip(longest, steps))


def _sharded_path(label, records, dev, tmp, expect, one):
    """The fused path with each chunk's lanes split over ``[dev, dev]``:
    two shards on one card, each with its own copy of its lanes, its own
    thread, stream and dispatch loop.  ``one`` is the one-device run of
    the family, every pair already equal to the native baseline: the
    sharded run must write its bytes and give its pairs, with K1, K2 and K3
    launched exactly once per iteration of each shard.  Then one device
    and two shards again in turns (two, one, one, two), each with the same
    bytes.  Returns the first sharded run's launch counts."""
    same = (one[1], one[3].results)
    launches, _, wall, run = _main_path(label, records, dev, tmp, expect,
                                        devices=[dev, dev], same_as=same)
    ran = _exact_launches(f"{label} over 2 shards", launches, run.results, 2)
    walls = {"two shards": [wall], "one device": []}
    for key in ("one device", "one device", "two shards"):
        devices = [dev, dev] if key == "two shards" else None
        walls[key].append(_main_path(label, records, dev, tmp, expect,
                                     devices=devices, same_as=same)[2])
    print(f"    {label}: shards ran (iterations, dispatched) {ran}; wall "
          "in turns (two, "
          "one, one, two): " + "; ".join(
              f"{k} " + ", ".join(f"{w:.3f}" for w in v) + " s"
              for k, v in walls.items()))
    return launches


def _two_process_path(path, one, tmp, timeout=300):
    """``python -m lara_tpu_torch`` on the tRNA family as two processes of
    one gloo group on this host (the coordinator variables of the JAX
    package), both on the card, against one process of the same command
    (``LARA_NO_DISTRIBUTED=1``): each host solves half of the pairs,
    process 0 alone writes, and both write the bytes of ``one``, the
    one-device run of this family in this script.  Prints the walls of both commands, from the first
    start to the last exit, and each process's solve phase.  Every process
    is killed, with its group, if it outlives ``timeout`` seconds."""
    import re
    import signal
    import socket

    here = os.path.dirname(os.path.abspath(__file__))
    library, n_pairs = one[1], len(one[3].results)

    def launch(out, **extra):
        env = {k: v for k, v in os.environ.items()
               if k not in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                            "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
                            "LARA_NO_DISTRIBUTED")}
        env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
        env.update(extra)
        return subprocess.Popen(
            [sys.executable, "-m", "lara_tpu_torch", "-i", path, "-v", "1",
             "-w", out], env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True, start_new_session=True)

    def finish(procs, start):
        try:
            errs = [proc.communicate(timeout=timeout)[1] for proc in procs]
        finally:
            for proc in procs:
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
        wall = time.perf_counter() - start
        for proc, err in zip(procs, errs):
            if proc.returncode != 0:
                raise AssertionError(f"a process exited {proc.returncode}: "
                                     f"{err[-2000:]}")
        solve = [float(re.search(r"^  solve +([0-9.]+) s", err,
                                 re.M).group(1)) for err in errs]
        return wall, solve, errs

    outs = {}
    for key in ("one process", "two processes"):
        out = os.path.join(tmp, f"{key.replace(' ', '-')}.lib")
        start = time.perf_counter()
        if key == "one process":
            procs = [launch(out, LARA_NO_DISTRIBUTED="1")]
        else:
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                port = sock.getsockname()[1]
            procs = [launch(out, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                            JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(rank))
                     for rank in range(2)]
        wall, solve, errs = finish(procs, start)
        with open(out) as handle:
            if handle.read() != library:
                raise AssertionError(f"{key}: library differs from the "
                                     "one-process run in this script")
        if key == "two processes" and not (
                all(f"host shard: {n_pairs // 2}/{n_pairs} pairs" in e
                    for e in errs)
                and "non-zero host: process 0 writes" in errs[1]):
            raise AssertionError("the two processes did not share the pairs "
                                 "as asked: " + errs[0][-1000:])
        outs[key] = (wall, solve)
    print("  tRNA, python -m lara_tpu_torch, the same library bytes: " + "; ".join(
        f"{k}: command wall {w:.3f} s, solve phase "
        + ", ".join(f"{t:.3f}" for t in solve) + " s"
        for k, (w, solve) in outs.items()))


#: SPS and MCC of the TPU run in ``benchmark/RESULTS.md:66-68`` (a table
#: printed beside the port's, not a gate)
RESULTS_MD = {"trna": (0.9547, 0.9413), "rrna5s": (0.9837, 0.9895),
              "srp": (0.9900, 0.9938)}


def _quality_path(dev, tmp, expect):
    """The repository's three families (``benchmark/data/*/unaligned.fa``,
    ragged lengths, structures predicted by the built-in folder) through
    the CLI path with ``--predict builtin --msa``: every pair equal to the
    native baseline and the library bytes to the native library, then SPS
    and MCC (built-in consensus) of the port's MSA against the curated
    ``reference.fa`` by the port's ``evaluate``.  Returns the launch counts
    summed over the families."""
    from lara_tpu_torch import evaluate

    here = os.path.dirname(os.path.abspath(__file__))
    total = dict.fromkeys(expect, 0)
    for family in RESULTS_MD:
        data = os.path.join(here, "benchmark", "data", family)
        msa = os.path.join(tmp, f"{family}.msa.fa")
        launches = _main_path(family, os.path.join(data, "unaligned.fa"),
                              dev, tmp, expect, predict="builtin",
                              msa_file=msa)[0]
        for name in expect:
            total[name] += launches[name]
        reference = os.path.join(data, "reference.fa")
        sps = evaluate.sps(reference, msa)
        mcc = evaluate.mcc(reference, msa, "builtin")
        print(f"    {family}: SPS {sps:.4f}, MCC {mcc:.4f} (port, "
              f"evaluate against reference.fa); benchmark/RESULTS.md, TPU "
              f"run: SPS {RESULTS_MD[family][0]:.4f}, MCC "
              f"{RESULTS_MD[family][1]:.4f}")
    return total


def _cloned(x):
    """A copy of ``x`` whose tensors (also inside tuples and lists, but not
    a model's) are clones."""
    import torch

    from lara_tpu_torch.solver.device_solver import BatchModel

    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, BatchModel):  # no iteration writes the model
        return x
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_cloned(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_cloned(v) for v in x)
    return x


@contextlib.contextmanager
def _body_calls(keep):
    """A dict that gets, for each iteration of the eager loop whose index
    is in ``keep``, copies of the arguments of its calls of KI-head,
    KI-lines and KI-tail (``iteration_cuda.head``, ``lines``, ``tail``)."""
    from lara_tpu_torch.solver import iteration_cuda

    calls, seen = {}, []
    real = {name: getattr(iteration_cuda, name)
            for name in ("head", "lines", "tail")}

    def spy(name):
        def call(*args, **kw):
            if name == "head":
                seen.append(1)
            k = len(seen) - 1
            if k in keep:
                calls.setdefault(k, {})[name] = _cloned(args)
            return real[name](*args, **kw)
        return call

    for name in real:
        setattr(iteration_cuda, name, spy(name))
    try:
        yield calls
    finally:
        for name, fn in real.items():
            setattr(iteration_cuda, name, fn)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _body_bounds(model, st, c, hd, ln, tb, match, new, steps):
    """Bounds of KI-head, KI-lines and KI-tail on these inputs: each input
    read once and each output written once (KI-head reads and writes a
    PSSM cell, its seq score and active bit, only at each run start), over
    3.35 TB/s; or their compares, maxima and selects (KI-head's scan: four
    a pass and entry) over 67 T/s."""
    b, d = model.dual_l.shape
    ne = model.seq_score.shape[1]
    starts = int((st.start_dst < ne).sum())
    head = _bound(
        _nbytes(model.sscore, c.dual, c.dual_at_queue, model.dvalid,
                model.dual_l, c.lane_active, *hd) + 9.0 * starts,
        8.0 * steps * b * d)
    lines = _bound(
        _nbytes(tb.partner, model.dual_l, model.dual_m, model.rev,
                model.dvalid, model.sscore, c.dual, hd.run_p, hd.run_idx,
                hd.is_top, st.lq, st.mq, st.nc_base, c.lane_active, *ln),
        20.0 * b * d)
    tail = _bound(
        _nbytes(*(t for f, t in zip(c._fields, c) if f != "dual_at_queue"),
                tb.upper, tb.gap_score, tb.n_lines, tb.seq_part, tb.partner,
                match.score, match.used_slot, ln.sg, ln.count,
                ln.consistent_sum, ln.matched_cons_slot,
                *(t for f, t in zip(new._fields, new)
                  if f != "dual_at_queue")),
        6.0 * b * d)
    return {"iteration_head": head, "iteration_lines": lines,
            "iteration_tail": tail}


def _hold_body(label, model, st, c, tb, match, lb_max, max_nondecr, stats,
               time_plain=True):
    """KI-head, KI-lines and KI-tail against their plain versions on one
    set of inputs, every output and the PSSM grid (fatal on any
    difference; the grids start from :func:`_unwritten_grid`); each kernel
    fed the plain version's upstream outputs.  Timed with CUDA events
    beside their bounds (:func:`_body_bounds`)."""
    import torch

    from lara_tpu_torch.solver import device_solver, iteration_cuda

    grid = _unwritten_grid(model, st)
    st_kernel = st._replace(pssm=grid.clone())
    st_plain = st._replace(pssm=grid.clone())
    hd = iteration_cuda.head(model, st_kernel, c)
    hd_p = device_solver.head_plain(model, st_plain, c)
    ln = iteration_cuda.lines(model, st, c, hd_p, tb.partner, lb_max)
    ln_p = device_solver.lines_plain(model, st, c, hd_p, tb.partner, lb_max)
    new = iteration_cuda.tail(c, hd_p.dual_at_queue, tb, ln_p, match,
                              max_nondecr)
    new_p = device_solver.tail_plain(c, hd_p.dual_at_queue, tb, ln_p, match,
                                     max_nondecr)
    torch.cuda.synchronize()
    errs = {
        "iteration_head": max(
            [_max_abs_err(st_kernel.pssm, st_plain.pssm)]
            + [_max_abs_err(g, w) for g, w in zip(hd, hd_p)]),
        "iteration_lines": max(_max_abs_err(g, w) for g, w in zip(ln, ln_p)),
        "iteration_tail": max(_max_abs_err(g, w)
                              for g, w in zip(new, new_p)),
    }
    if any(errs.values()):
        raise AssertionError(f"the iteration body's kernels disagree with "
                             f"their plain versions at {label}: {errs}")
    runs = {
        "iteration_head": (
            lambda: iteration_cuda.head(model, st, c),
            lambda: device_solver.head_plain(model, st_plain, c)),
        "iteration_lines": (
            lambda: iteration_cuda.lines(model, st, c, hd_p, tb.partner,
                                         lb_max),
            lambda: device_solver.lines_plain(model, st, c, hd_p, tb.partner,
                                              lb_max)),
        "iteration_tail": (
            lambda: iteration_cuda.tail(c, hd_p.dual_at_queue, tb, ln_p,
                                        match, max_nondecr),
            lambda: device_solver.tail_plain(c, hd_p.dual_at_queue, tb, ln_p,
                                             match, max_nondecr)),
    }
    bounds = _body_bounds(model, st, c, hd_p, ln_p, tb, match, new_p,
                          len(st.same_masks))
    for name, (kernel, plain) in runs.items():
        ms = _time_ms(kernel, 50)
        plain_ms = _time_ms(plain, 3) if time_plain else None
        bound_ms, bound_by = bounds[name]
        stats[name].append((label, errs[name], ms, plain_ms, bound_ms,
                            bound_by))
        shown = f"{plain_ms:.4f} ms" if plain_ms is not None else "not timed"
        print(f"  {name:16s} {label:40s} max_abs_err {errs[name]}  kernel "
              f"{ms:.4f} ms  plain {shown}  bound {bound_ms:.5f} ms "
              f"({bound_by})")


def _random_body_inputs(batch, carry, la_max, lb_max, seed, dev):
    """A random carry, alignment and K3 result for a real chunk's model:
    random duals, lanes active or not, a third of them still at the
    initial bounds, partner rows that put random dual edges on lines."""
    import torch

    from lara_tpu_torch.ops import gotoh
    from lara_tpu_torch.solver.matching_device import RoundsResult

    rng = np.random.default_rng(seed)
    b, d = batch.dual_l.shape
    dvalid = batch.dvalid.cpu().numpy()
    dual_l = batch.dual_l.cpu().numpy()

    def ints(lo, hi, shape=(b,)):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(
            np.int32)).to(dev)

    fresh = torch.from_numpy(rng.random(b) < 0.3).to(dev)
    lower = ints(-9000, 0)
    c = carry._replace(
        dual=torch.from_numpy(np.where(dvalid, rng.integers(-60, 60, (b, d)),
                                       0).astype(np.int32)).to(dev),
        step_factor=torch.from_numpy(rng.uniform(0.01, 2.0, b).astype(
            np.float32)).to(dev),
        nondecr=ints(0, 6), remaining=ints(1, 4),
        lane_active=torch.from_numpy(rng.random(b) < 0.8).to(dev),
        best_lower=torch.where(fresh, carry.best_lower, lower),
        best_upper=torch.where(fresh, carry.best_upper,
                               lower + ints(0, 9000)))
    partner = np.full((b, la_max), -1, np.int32)
    for k in range(b):
        on = dual_l[k][dvalid[k] & (rng.random(d) < 0.5)]
        partner[k, on // lb_max] = on % lb_max
    partner = torch.from_numpy(partner).to(dev)
    tb = gotoh.Traceback(upper=ints(-9000, 9000), partner=partner,
                         n_lines=ints(0, la_max), gap_score=ints(-900, 0),
                         seq_part=ints(-9000, 9000),
                         lines=gotoh.no_lines(b, dev))
    match = RoundsResult(score=ints(0, 900), used_slot=torch.from_numpy(
        rng.random((b, la_max)) < 0.5).to(dev))
    return c, tb, match


def _body_grids(label, model, st, slots):
    """Print the grids of KI-head, KI-lines and KI-tail on this chunk, as
    their wrappers choose them (``iteration_cuda.head_grid``,
    ``lines_grid``, ``tail_grid``)."""
    from lara_tpu_torch.solver import iteration_cuda

    b, d = model.dual_l.shape
    sms = iteration_cuda.sm_count(model.dual_l.device)
    steps = len(st.same_masks)
    hg = iteration_cuda.head_grid(b, d, steps, sms)
    lg = iteration_cuda.lines_grid(b, d, slots, st.lq.shape[1], sms)
    tg = iteration_cuda.tail_grid(b, d, slots)
    why = (f" (one CTA per lane: the halo of {hg.halo} is wider than half "
           f"the lane)" if hg.tiles == 1 else "")
    print(f"  grids, {label}: KI-head steps {steps}, halo {hg.halo}, tile "
          f"{hg.tile} ({hg.tiles} a lane, at most {hg.span} entries with "
          f"the halos), {hg.ctas} CTAs{why}; KI-lines clusters of "
          f"{lg.cluster} ({lg.dper} entries, {lg.sper} slots, {lg.qper} "
          f"queue columns a CTA), {lg.ctas} CTAs; KI-tail one CTA a lane "
          f"of {tg.threads} threads (16-byte loads {tg.vec}), {tg.ctas} "
          f"CTAs; {sms} SMs")


def _body_layouts(label, model, st, c, tb, lb_max):
    """KI-head and KI-lines in other layouts on the same inputs, each held
    against its plain version (fatal on any difference; KI-head's PSSM
    grid from :func:`_unwritten_grid`) and timed in turns with the
    wrappers' choice (CUDA events): both on one CTA per lane, and KI-lines
    in a cluster of 8."""
    import torch

    from lara_tpu_torch.solver import device_solver, iteration_cuda

    d = model.dual_l.shape[1]
    grid = _unwritten_grid(model, st)
    st_plain = st._replace(pssm=grid.clone())
    hd_p = device_solver.head_plain(model, st_plain, c)
    ln_p = device_solver.lines_plain(model, st, c, hd_p, tb.partner, lb_max)
    runs = {
        "KI-head, chosen tiles": lambda s: iteration_cuda.head(model, s, c),
        "KI-head, one CTA a lane": lambda s: iteration_cuda.head(model, s, c,
                                                                 tile=d),
        "KI-lines, chosen clusters": lambda s: iteration_cuda.lines(
            model, s, c, hd_p, tb.partner, lb_max),
        "KI-lines, one CTA a lane": lambda s: iteration_cuda.lines(
            model, s, c, hd_p, tb.partner, lb_max, cluster=1),
        "KI-lines, clusters of 8": lambda s: iteration_cuda.lines(
            model, s, c, hd_p, tb.partner, lb_max, cluster=8),
    }
    for name, run in runs.items():
        st_run = st._replace(pssm=grid.clone())
        got = run(st_run)
        torch.cuda.synchronize()
        if name.startswith("KI-head"):
            err = max([_max_abs_err(st_run.pssm, st_plain.pssm)]
                      + [_max_abs_err(g, w) for g, w in zip(got, hd_p)])
        else:
            err = max(_max_abs_err(g, w) for g, w in zip(got, ln_p))
        if err:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"at {label}: max_abs_err {err}")
    times = {name: [] for name in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            times[name].append(_time_ms(lambda: runs[name](st), 50))
    print(f"  layouts, {label} (max_abs_err 0 each; ms in turns): "
          + "; ".join(f"{name} " + ", ".join(f"{t:.4f}" for t in ts)
                      for name, ts in times.items()))


def _unwritten_grid(model, st):
    """A copy of the PSSM grid whose run-start cells hold PSSM_INIT + 1, a
    value KI-head never writes, so that a run start left unwritten shows
    as a difference; every other cell as ``_prepare`` left it."""
    from lara_tpu_torch.types import PSSM_INIT

    b, ne = model.seq_score.shape
    grid = st.pssm.clone()
    lane, entry = ((st.start_dst >= 0) & (st.start_dst < ne)).nonzero(
        as_tuple=True)
    grid.view(b, ne)[lane, st.start_dst[lane, entry]] = int(PSSM_INIT) + 1
    return grid


def _body_phase(label, records, dev, stats, seed):
    """KI-head, KI-lines and KI-tail against their plain versions on a
    bench chunk's model with a random carry (:func:`_random_body_inputs`),
    timed beside their bounds; their grids; and the other layouts of
    KI-head and KI-lines (:func:`_body_layouts`)."""
    from lara_tpu_torch.solver import device_solver

    batch, how, carry0, _ = _chunk_batch(records, dev)
    (_go, _ge, la_max, lb_max), (max_nondecr, _lookahead, scan_steps) = how
    st = device_solver._prepare(batch, la_max, lb_max, scan_steps)
    c, tb, match = _random_body_inputs(batch, carry0(), la_max, lb_max, seed,
                                       dev)
    b, d = batch.dual_l.shape
    chunk = f"{label} B={b} D={d}"
    _body_grids(chunk, batch, st, la_max)
    _hold_body(f"{chunk} random carry", batch, st, c, tb, match,
               lb_max, max_nondecr, stats)
    _body_layouts(f"{chunk} random carry", batch, st, c, tb, lb_max)


def _tail_cases(dev):
    """KI-tail against its plain version on ``tail_cases.tail_inputs`` at
    the tRNA, ~300 nt and 16S chunks' B, D and slots and at a ragged B=40
    D=1021 with 33 slots (no 16-byte loads), each into new tensors and in
    place (``out=c``, as the dispatch graph runs it): every output equal
    (fatal otherwise), on lanes inactive, halving, with count 0 and count
    > 1, and with best_upper - best_lower wrapping, each present in every
    case."""
    import torch

    from lara_tpu_torch.solver import device_solver, iteration_cuda
    from lara_tpu_torch.solver import tail_cases

    nd = tail_cases.MAX_NONDECR
    for k, (b, d, slots) in enumerate(((128, 1024, 96), (32, 1024, 320),
                                       (32, 3072, 1536), (40, 1021, 33))):
        c, tb, ln, match = tail_cases.tail_inputs(b, d, slots, 90 + k, dev)
        want = device_solver.tail_plain(c, c.dual_at_queue, tb, ln, match,
                                        nd)
        seen = tail_cases.lane_kinds(c, ln, want)
        if not all(seen.values()):
            raise AssertionError(f"KI-tail's case B={b} D={d} lacks one of "
                                 f"its kinds of lane: {seen}")
        got = iteration_cuda.tail(c, c.dual_at_queue, tb, ln, match, nd)
        own = device_solver._Carry(*(t.clone() for t in c))
        iteration_cuda.tail(own, own.dual_at_queue, tb, ln, match, nd,
                            out=own)
        torch.cuda.synchronize()
        err = max([_max_abs_err(g, w) for g, w in zip(got, want)]
                  + [_max_abs_err(g, w) for g, w in zip(own, want)])
        if err:
            raise AssertionError(f"KI-tail disagrees with its plain version "
                                 f"at B={b} D={d} slots={slots}: "
                                 f"max_abs_err {err}")
        grid = iteration_cuda.tail_grid(b, d, slots)
        print(f"  iteration_tail   B={b} D={d} slots={slots} max_abs_err 0 "
              f"(new tensors and in place; lanes {seen}); one CTA a lane "
              f"of {grid.threads} threads, 16-byte loads {grid.vec}")


@contextlib.contextmanager
def _k3_calls(keep):
    """A dict that gets copies of the arguments of the solver's K3 calls
    (``device_solver.greedy_matching_queue``) whose index is in ``keep``."""
    import torch

    from lara_tpu_torch.solver import device_solver

    calls, seen = {}, []
    real = device_solver.greedy_matching_queue

    def spy(*args):
        if len(seen) in keep:
            calls[len(seen)] = [a.clone() if torch.is_tensor(a) else a
                                for a in args]
        seen.append(1)
        return real(*args)

    device_solver.greedy_matching_queue = spy
    try:
        yield calls
    finally:
        device_solver.greedy_matching_queue = real


def _chunk_batch(records, dev):
    """One chunk of ``records`` at default parameters, as
    ``device_driver`` packs it: (batch, scan_steps, solver arguments after
    the carry, a function that makes the starting carry)."""
    from lara_tpu_torch.app import enumerate_pairs
    from lara_tpu_torch.params import Parameters
    from lara_tpu_torch.solver import device_driver, device_solver

    params = Parameters(in_file="<bench>")
    pad = device_driver._pad_dim(max(len(r.sequence) for r in records))
    pairs = enumerate_pairs(records)
    models, _ = device_driver._filter_and_build(
        records, pairs, params, pad, pad, dev)
    batch, scan_steps = device_driver._pack_models(models, params, pad, pad,
                                                   dev)
    b, d = batch.dual_l.shape

    def carry0():
        return device_solver._init_carry(
            b, d, pad, np.float32(params.step_size_factor),
            int(params.num_iterations), dev)

    args = (int(params.gap_open_int), int(params.gap_extend_int), pad, pad)
    rest = (int(params.max_nondecr_iterations), int(params.matching),
            scan_steps)
    return batch, (args, rest), carry0, models


@contextlib.contextmanager
def _env(env):
    os.environ.update(env or {})
    try:
        yield
    finally:
        for key in env or {}:
            del os.environ[key]


def _dispatch(batch, carry, how, steps, eager=False):
    """One ``solve_batch_chunk`` of ``steps`` iterations: the CUDA graph,
    or with ``eager`` the eager loop it is held to."""
    from lara_tpu_torch.solver import device_solver

    (go, ge, la_max, lb_max), rest = how
    solve = device_solver._eager_dispatch if eager \
        else device_solver.solve_batch_chunk
    return solve(batch, carry, go, ge, la_max, lb_max, steps, *rest)


def _graph_phase(label, records, dev, expect, env=None, steps=125):
    """One dispatch of ``steps`` iterations and a second one resumed from
    its carry, eager and graphed from the same starting carry: every carry
    field of both dispatches equal (zero tolerance), the two graphed
    dispatches (the first warms up on scratch copies where the process
    has not run the key, captures and launches; each one launch) under
    ``torch.cuda.set_sync_debug_mode("error")``, the kernels ``expect``
    counted exactly once per iteration the loop exit let run (the longest
    lane's, at most ``2 * steps``), the loop exit's kernel once per
    dispatch, and KI-tail's ticket 0 after them.  Prints the capture
    seconds and the peak memory of each way beside ``device_driver``'s
    estimate of the chunk (``_chunk_est_bytes``)."""
    import torch

    from lara_tpu_torch import _build
    from lara_tpu_torch.solver import device_driver, dispatch_graph
    from lara_tpu_torch.utils import timing

    with _env(env):
        batch, how, carry0, models = _chunk_batch(records, dev)
        dispatch_graph.release()
        timing.reset()
        peaks, walls, carries = {}, {}, {}
        for way in ("eager", "graph"):
            first = carry0()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            _build.reset_launches()
            start = time.perf_counter()
            if way == "graph":
                torch.cuda.set_sync_debug_mode("error")
            try:
                one = _dispatch(batch, first, how, steps, way == "eager")
                two = _dispatch(batch, one, how, steps, way == "eager")
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            walls[way] = time.perf_counter() - start
            peaks[way] = torch.cuda.max_memory_allocated(dev) - base
            carries[way] = (one, two)
        capture_s = timing.snapshot()["graph capture"]
        tickets = [int(e.counters[2:].abs().sum())
                   for e in dispatch_graph._entries]
        dispatch_graph.release()  # settles the graphed launch counts
        launches = dict(_build.launches)
    for k, (got, want) in enumerate(zip(carries["graph"], carries["eager"])):
        for field, g, w in zip(got._fields, got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"{label}: dispatch {k + 1}, {field}: "
                                     "the graph differs from the eager loop")
    ran = [int(c.iterations.max()) for c in carries["eager"]]
    want = dict.fromkeys(expect, ran[1]) | {"loop_exit": 2}
    got = {name: n for name, n in launches.items() if n}
    if any(tickets):
        raise AssertionError(f"{label}: KI-tail's tickets {tickets} after "
                             "the dispatches, not 0")
    if got != want:
        raise AssertionError(f"{label}: the graphed dispatches launched "
                             f"{got}, expected {want}")
    b, d = batch.dual_l.shape
    la_max, lb_max = how[0][2:]
    est = device_driver._chunk_est_bytes(len(models), la_max, lb_max, d)
    name = label + "".join(f" {k}={v}" for k, v in (env or {}).items())
    print(f"  {name}: B={b} D={d} {la_max}x{lb_max}, two dispatches of "
          f"{steps}: every carry field equal, no host sync in the graphed "
          f"ones, iterations run {ran[0]} and {ran[1] - ran[0]}, {got}; "
          f"capture {capture_s * 1e3:.3f} ms; peak memory "
          f"eager {peaks['eager'] / 1e9:.4f} GB, graphed "
          f"{peaks['graph'] / 1e9:.4f} GB (difference "
          f"{(peaks['graph'] - peaks['eager']) / 1e9:+.4f} GB; "
          f"_chunk_est_bytes {est / 1e9:.4f} GB); wall eager "
          f"{walls['eager']:.3f} s, graphed {walls['graph']:.3f} s")


def _smem_repair_check(dev):
    """K1 captured in a CUDA graph at B=32 320x320 on one CTA per pair
    (158 KB of shared memory) must replay after an eager K1 at B=128
    96x96 (58 KB) and give the eager codes: the launcher opts the kernel
    in to its largest shared memory once, and no launch lowers it."""
    import torch

    from lara_tpu_torch.ops import gotoh_cuda

    go, ge = -49152, -16384
    rng = np.random.default_rng(12)

    def problem(b, n):
        pssm = torch.from_numpy(rng.integers(-9000, 9000, (b, n, n)).astype(
            np.int32)).to(dev)
        return pssm, torch.full((b,), n, dtype=torch.int32, device=dev)

    big, big_len = problem(32, 320)
    small, small_len = problem(128, 96)
    want = gotoh_cuda.dp_forward(big, big_len, big_len, go, ge, cluster=1)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        got = gotoh_cuda.dp_forward(big, big_len, big_len, go, ge, cluster=1)
        graph.capture_end()
    torch.cuda.current_stream(dev).wait_stream(side)
    gotoh_cuda.dp_forward(small, small_len, small_len, go, ge)
    for t in got:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    d_idx = torch.arange(641, device=dev)[None, :, None]
    i_idx = torch.arange(321, device=dev)[None, None, :]
    valid = (d_idx >= i_idx) & (d_idx - i_idx <= 320)
    if not (torch.equal(torch.where(valid, got[0], 0),
                        torch.where(valid, want[0], 0))
            and torch.equal(got[1], want[1])):
        raise AssertionError("a K1 graph at 320x320 did not replay after a "
                             "96x96 launch")
    print("  K1 graphed at B=32 320x320 (1 CTA per pair) replays after an "
          "eager K1 at B=128 96x96: the codes and finals of the eager call")


@contextlib.contextmanager
def _eager_dispatches():
    """Every ``solve_batch_chunk`` inside runs the eager loop."""
    from lara_tpu_torch.solver import device_solver

    graphed = device_solver.solve_batch_chunk
    device_solver.solve_batch_chunk = device_solver._eager_dispatch
    try:
        yield
    finally:
        device_solver.solve_batch_chunk = graphed


def _turns_path(family, dev, tmp, expect, one):
    """The fused main path graphed and eager in turns (graphed, eager,
    eager, graphed), each with the bytes and pairs of ``one`` (the first
    graphed run of the family in this script) and K1, K2 and K3 exactly
    once per iteration run (graphed: the JAX loop's iterations; eager:
    every dispatched one); prints the walls and solve phases."""
    from lara_tpu_torch.utils import timing

    label = family[0]
    same = (one[1], one[3].results)
    walls = {"graphed": [], "eager": []}
    for way in ("graphed", "eager", "eager", "graphed"):
        with _eager_dispatches() if way == "eager" \
                else contextlib.nullcontext():
            run = _main_path(*family, dev, tmp, expect, same_as=same,
                             graphed=way == "graphed")
        _exact_launches(f"{label} {way}", run[0], run[3].results, 1,
                        graphed=way == "graphed")
        walls[way].append((run[2], timing.snapshot()[
            "subgradient solve (device)"]))
    print(f"    {label}, wall (solve phase) in turns (graphed, eager, eager, "
          "graphed): " + "; ".join(
              f"{k} " + ", ".join(f"{w:.3f} ({s:.3f})" for w, s in v) + " s"
              for k, v in walls.items()))


def _loop_overhead(batch, how, carry0, n_iter):
    """Device ms per iteration of the dispatch graph's loop (one launch of
    ``n_iter`` iterations) and of its captured iteration replayed bare
    (a graph replayed once per iteration), from the same carry, in
    turns, CUDA events; the least of 8 each."""
    import torch

    from lara_tpu_torch.solver import dispatch_graph

    (go, ge, la_max, lb_max), rest = how
    key = dispatch_graph.key_of(batch, go, ge, la_max, lb_max, *rest)
    (entry,) = [e for e in dispatch_graph._entries if e.key == key]
    bare = entry.graph._graph
    bare.instantiate()
    times = {"loop": [], "bare": []}
    for way in ("loop", "bare", "bare", "loop") * 2:
        entry.load(batch, carry0())
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if way == "loop":
            entry.counters[0].fill_(n_iter)
            entry.graph.replay()
        else:
            for _ in range(n_iter):
                bare.replay()
        end.record()
        torch.cuda.synchronize()
        times[way].append(start.elapsed_time(end) / n_iter)
    return min(times["loop"]), min(times["bare"])


def _capture_nodes(graph) -> dict:
    """The nodes of a torch capture (``keep_graph=True``) by type, from the
    driver API: the device operations that one replay of it runs."""
    cuda = ctypes.CDLL("libcuda.so.1")
    size_p = ctypes.POINTER(ctypes.c_size_t)
    cuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p, size_p]
    cuda.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_int)]

    def check(rc, what):
        if rc != 0:
            raise AssertionError(f"{what}: CUDA driver error {rc}")

    handle = graph.raw_cuda_graph()
    n = ctypes.c_size_t(0)
    check(cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)),
          "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)),
          "cuGraphGetNodes")
    # CUgraphNodeType (cuda.h)
    names = {0: "kernel", 1: "memcpy", 2: "memset", 5: "empty"}
    by_type = {}
    for node in nodes[:n.value]:
        kind = ctypes.c_int()
        check(cuda.cuGraphNodeGetType(node, ctypes.byref(kind)),
              "cuGraphNodeGetType")
        name = names.get(kind.value, f"type {kind.value}")
        by_type[name] = by_type.get(name, 0) + 1
    return by_type


def _device_ops(by_type) -> int:
    """The kernels, copies and fills among a capture's nodes
    (:func:`_capture_nodes`)."""
    return sum(by_type.get(k, 0) for k in ("kernel", "memcpy", "memset"))


#: the section of the body that runs each kernel of ``csrc/`` (by the
#: kernel function's name, less ``_kernel``)
OWN_SECTION = {"dp_wave": "dp", "dp_walk": "dp", "matching_rounds": "k3",
               "iteration_head": "head", "iteration_lines": "lines",
               "iteration_tail": "tail"}


def _attribution(batch, how, carry0, n_iter):
    """Device time and device operations of one iteration by section of the
    body (the ``lara.*`` ranges of ``device_solver._section``), from
    ``torch.profiler`` over ``n_iter`` eager runs of a graph entry's
    ``step``, the code its capture records: the iteration and the copies of
    the carry into the static one.  Each operation counts in the innermost
    section around the host call that launched it.  Returns {section:
    (device us per iteration, operations per iteration)}, with the
    operations outside every section under "outside"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lara_tpu_torch.solver import dispatch_graph

    (go, ge, la_max, lb_max), rest = how
    key = dispatch_graph.key_of(batch, go, ge, la_max, lb_max, *rest)
    entry = dispatch_graph._Entry(key, batch, carry0())
    try:
        for _ in range(2):
            entry.step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_iter):
                entry.step()
            torch.cuda.synchronize()
    finally:
        entry.graph.close()
    sections = {}

    def add(name, us, count):
        was_us, was_count = sections.get(name, (0.0, 0))
        sections[name] = (was_us + us, was_count + count)

    def own(name):
        return next((section for kernel, section in OWN_SECTION.items()
                     if f"{kernel}_kernel" in name), None)

    for e in prof.events():
        # the device-side copies of the ranges are no operations, and the
        # kernels of csrc/ (launched through ctypes, outside any operator)
        # are counted by name below
        ops = [k for k in e.kernels
               if not k.name.startswith("lara.") and own(k.name) is None]
        if not ops:
            continue
        s = e
        while s is not None and not s.name.startswith("lara."):
            s = s.cpu_parent
        add(s.name[len("lara."):] if s is not None else "outside",
            sum(k.duration for k in ops), len(ops))
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and own(e.key):
            add(own(e.key), e.self_device_time_total, e.count)
    return {name: (us / n_iter, count / n_iter)
            for name, (us, count) in sections.items()}


def _profile_phase(label, records, dev, stats, n_iter=25, env=None,
                   walls=None):
    """Where one chunk's solve spends its time, under the switches ``env``
    (``LARA_DP_GRID=1``: K1-grid and K2-grid in place of K1 and K2), eager
    and graphed side by side, in two passes.  Without ``walls``, before any
    profiler has run in the process (a profiled run leaves the card's
    tracing on, and it slows the kernels of the WHILE node's body): the
    unprofiled wall of ``n_iter`` warm iterations (graphed: one launch of
    a graph captured before) and the loop exit's cost per iteration
    (:func:`_loop_overhead`); returns the walls.  With ``walls``: from
    ``torch.profiler`` over the same iterations the device time, kernels
    per iteration and K1/K2/K3 time; the busy share divides device time by
    the unprofiled wall of the first pass (the profiler itself slows the
    host).  K3's arguments in iterations 1, 2, 3 and ``n_iter`` of the
    eager solve are kept, and K3 is held against the plain version and
    timed on them: the solver's real queues."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lara_tpu_torch.solver import dispatch_graph

    grid = bool((env or {}).get("LARA_DP_GRID"))
    names = "K1-grid/K2-grid/K3" if grid else "K1/K2/K3"
    with _env(env):
        batch, how, carry0, _ = _chunk_batch(records, dev)
        b, d = batch.dual_l.shape
        pad = how[0][2]

        def solve(eager):
            _dispatch(batch, carry0(), how, n_iter, eager)
            torch.cuda.synchronize()

        label += "".join(f" {k}={v}" for k, v in (env or {}).items())
        if walls is None:
            solve(True)
            solve(False)  # captures the graph
            walls = {}
            for way, eager in (("eager", True), ("graphed", False)):
                start = time.perf_counter()
                solve(eager)
                walls[way] = (time.perf_counter() - start) * 1e3
            loop_ms, bare_ms = _loop_overhead(batch, how, carry0, n_iter)
            (go, ge, la_max, lb_max), rest = how
            key = dispatch_graph.key_of(batch, go, ge, la_max, lb_max, *rest)
            (entry,) = [e for e in dispatch_graph._entries if e.key == key]
            nodes = _capture_nodes(entry.graph._graph)
            dispatch_graph.release()
            if not grid and _device_ops(nodes) > 12:
                raise AssertionError(f"{label}: the captured iteration holds "
                                     f"{nodes}, more than 12 operations")
            print(f"  {label}: B={b} D={d} {pad}x{pad}, {n_iter} warm "
                  "iterations, unprofiled: wall per iteration "
                  + ", ".join(f"{way} {ms / n_iter:.3f} ms"
                              for way, ms in walls.items())
                  + f"; device time per iteration, the dispatch's loop "
                  f"{loop_ms:.4f} ms, its captured iteration replayed bare "
                  f"{bare_ms:.4f} ms (least of 8, in turns): the loop exit "
                  f"adds {(loop_ms - bare_ms) * 1e3:.1f} us; the captured "
                  f"iteration holds {_device_ops(nodes)} device operations "
                  f"(nodes by type {nodes})")
            return walls
        keep = {0, 1, 2, n_iter - 1}
        with _k3_calls(keep) as calls, _body_calls(keep) as body:
            solve(True)
        solve(False)  # captures the graph
        profiles = {}
        for way, eager in (("eager", True), ("graphed", False)):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                solve(eager)
            profiles[way] = prof
        dispatch_graph.release()
        sections = _attribution(batch, how, carry0, n_iter)
    print(f"  {label}: B={b} D={d} {pad}x{pad}, {n_iter} warm iterations, "
          "profiled:")
    seen_eager = None
    in_loop = {}
    for way, prof in profiles.items():
        wall_ms = walls[way]
        device = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        per_iteration = sum(e.count for e in device) / n_iter
        if way == "eager":
            seen_eager = per_iteration
        missed = " (fewer kernels than the eager loop's: the profiler " \
            "did not see every kernel of the WHILE node's body)" \
            if way != "eager" and per_iteration < seen_eager else ""
        busy_ms = sum(e.self_device_time_total for e in device) / 1e3
        # K1 is dp_wave_kernel<false, false>, K1-grid <false, true>; K2 and
        # K2-grid are both dp_walk_kernel
        ours = {name: sum(e.self_device_time_total for e in device
                          if f"{name}_kernel" in e.key) / n_iter
                for name in ("dp_wave", "dp_walk", "matching_rounds") + BODY}
        in_loop[way] = ours
        # copies of the carry into the graph's static one: none, as KI-head
        # and KI-tail write it in place
        copies = [e for e in device if "Memcpy DtoD" in e.key]
        seen = (f"device busy {busy_ms / n_iter:.3f} ms/iteration "
                f"({busy_ms / wall_ms:.1%} of the unprofiled wall), "
                f"{per_iteration:.1f} kernels/iteration, {names}/KI-head/"
                "KI-lines/KI-tail "
                + " / ".join(f"{us:.1f}" for us in ours.values())
                + " us/iteration, device-to-device copies "
                f"{sum(e.count for e in copies) / n_iter:.1f}/iteration "
                f"{sum(e.self_device_time_total for e in copies) / n_iter:.1f}"
                " us/iteration" + missed) if device else \
            "the profiler saw no device time (not measured)"
        print(f"    {way:8s} {seen}")
    total_us = sum(us for us, _ in sections.values())
    total_ops = sum(n for _, n in sections.values())
    print(f"    by section (eager steps of the graph's entry, profiled): "
          f"{total_us:.1f} us and {total_ops:.1f} device operations per "
          "iteration: " + "; ".join(f"{name} {us:.1f} us / {n:.1f}"
                                    for name, (us, n) in sections.items()))
    for k in sorted(calls):
        args = calls[k]
        _hold_matching(f"{label} iteration {k + 1}", args[:5], args[5],
                       stats, time_plain=False)
    # KI-head, KI-lines and KI-tail on the same iterations' own inputs
    lb_max, max_nondecr = how[0][3], how[1][0]
    for k in sorted(body):
        model, st, c, _out = body[k]["head"]
        c_tail, _daq, tb, _ln, match, *_ = body[k]["tail"]
        _hold_body(f"{label} iteration {k + 1}", model, st, c, tb, match,
                   lb_max, max_nondecr, stats, time_plain=False)
    alone = {name: [s[2] * 1e3 for s in stats[name]
                    if s[0].startswith(f"{label} iteration ")]
             for name in BODY}
    print(f"    {label}: the body's kernels in the loop (profiled, eager; "
          "graphed) and alone (CUDA events on iterations "
          f"{', '.join(str(k + 1) for k in sorted(body))}' own inputs), us: "
          + "; ".join(f"{name} {in_loop.get('eager', {}).get(name, 0.0):.1f}"
                      f"; {in_loop.get('graphed', {}).get(name, 0.0):.1f} / "
                      + ", ".join(f"{us:.1f}" for us in alone[name])
                      for name in BODY))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from lara_tpu_torch import _build
    from lara_tpu_torch.ops import gotoh_cuda
    from lara_tpu_torch.workloads import (make_family, make_long_family,
                                          without_structure)

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    driver_api = ctypes.c_int()
    ctypes.CDLL("libcuda.so.1").cuDriverGetVersion(ctypes.byref(driver_api))
    driver = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__}, CUDA runtime {torch.version.cuda} "
          f"(torch's), driver {driver} (CUDA API {driver_api.value // 1000}."
          f"{driver_api.value % 1000 // 10}), {torch.cuda.get_device_name(0)}")
    start = time.perf_counter()
    _build.library()
    print(f"kernel library: {_build.LIBRARY} (nvcc {_build.build_seconds():.1f}"
          f" s, load {time.perf_counter() - start:.1f} s)")
    # the native host libraries build with g++ at first use; build them
    # here, as the kernels above, so that no timed run pays for a build
    from lara_tpu_torch.native import baseline as native_baseline, lagrange
    from lara_tpu_torch.solver import interactions

    start = time.perf_counter()
    native_baseline._load()
    lagrange._load()
    if interactions._native_build() is None:
        raise AssertionError("the native model build did not load")
    print(f"native host libraries (baseline, lagrange_host, model_build): "
          f"{time.perf_counter() - start:.1f} s")

    print("kernels vs plain versions on the card:")
    stats = {name: [] for name in KERNELS}
    _dp_phase(128, 96, 96, 1, dev, stats)
    _dp_phase(32, 320, 320, 2, dev, stats)
    # the 16S chunk: K1 and K1-grid with 180 KB of opt-in shared memory
    # per CTA, K2's and K2-grid's walks of up to 3072 steps (K-res does
    # not fit)
    _dp_phase(32, 1536, 1536, 3, dev, stats, resident=False)
    # a lone 16S pair: K1 spread over a cluster of up to 16 CTAs
    _spread_phase(dev, stats)
    # ragged and non-square: la_max not a multiple of 32, 32 < B < 132
    _dp_phase(40, 333, 700, 4, dev, stats, grid=False, resident=False)
    # the same, narrow enough for K-res (11 warps per pair)
    _dp_phase(40, 333, 150, 9, dev, stats, grid=False)
    # K3 first at the main path's shapes (the tRNA and ~300 nt chunks have
    # D=1024 dual entries, so W=512 queue columns, the 16S chunk D=3072, so
    # W=1536; S=LA line slots), then the fuzz widths at every lookahead
    _matching_phase(128, 512, 96, 5, 20, dev, stats)
    _matching_phase(32, 512, 320, 5, 21, dev, stats)
    _matching_phase(32, 1536, 1536, 5, 22, dev, stats)
    for width in (256, 1024):
        for lookahead in (5, 1, 2, 8):
            _matching_phase(128, width, 96, lookahead, 10 + lookahead, dev,
                            stats)
    # K4 at the chunks of the tRNA, ~300 nt and 16S families and the ragged
    # batch (2B lanes: one CTA per lane at B=128 and 40, two at B=32)
    _edge_phase(128, 96, 96, 5, dev, stats)
    _edge_phase(32, 320, 320, 6, dev, stats)
    k4_16s = _edge_phase(32, 1536, 1536, 7, dev, stats)
    _edge_phase(40, 333, 700, 8, dev, stats)
    # KB at the three layouts of benchmark/profile_wavefront_layout.py
    _kb_phase(dev, stats)
    # the loop exit of a graphed dispatch
    _loop_exit_phase(dev, stats)

    families = [
        ("trna-72nt", make_family(n=16)),
        ("rrna-300nt", make_long_family(n=8, length=300, seed=31,
                                        mutations=12)),
        ("16S-1530nt-batch28", make_long_family(n=8, length=1530, seed=47)),
    ]
    # KI-head, KI-lines and KI-tail on the tRNA, ~300 nt and 16S chunks'
    # models with random carries (their own inputs follow in phase 4)
    for seed, (label, records) in enumerate(families, start=51):
        _body_phase(label, records, dev, stats, seed)
    _tail_cases(dev)
    trna, rrna, long16 = families
    fused = FUSED_ITERATION + K4
    launches = dict.fromkeys(KERNELS, 0)

    def count(run):
        for name, n in run.items():
            launches[name] += n

    print("dispatch graph against the eager loop, two dispatches of 125 "
          "iterations:")
    _smem_repair_check(dev)
    for label, records in families:
        _graph_phase(label, records, dev, FUSED_ITERATION)
    # a chunk whose lanes are all done inside its first dispatch
    _graph_phase("trna-72nt-structure-free",
                 without_structure(make_family(n=16)), dev, FUSED_ITERATION)
    _graph_phase(*trna, dev, GRID_ITERATION, env={"LARA_DP_GRID": "1"})
    _graph_phase(*rrna, dev, ("gotoh_resident", "matching_rounds") + BODY,
                 env={"LARA_DP_RESIDENT": "1"})

    with tempfile.TemporaryDirectory() as tmp:
        print("main path: lara_tpu_torch.app.run, default parameters:")
        one = {}
        # the chunks fill the card: K1 on 1 CTA a pair at tRNA's 128
        # lanes, 4 at ~300 nt's 32; K4's sweep on 1 and 2 (132 SMs)
        for (label, records), ctas in zip((trna, rrna), ((1, 1), (4, 2))):
            one[label] = _main_path(label, records, dev, tmp, fused)
            _placements(label, *ctas)
            _exact_launches(label, one[label][0], one[label][3].results, 1)
            count(one[label][0])
        print("the loop exit on a family whose lanes converge at once:")
        count(_structure_free_path(dev, tmp))
        print("16S, one 1536x1536 bucket:")
        one[long16[0]] = _long_path(long16, dev, tmp, fused, k4_16s)
        count(one[long16[0]][0])
        print("a lone 16S pair (B=1), K1 and K4's sweep spread:")
        pair = ("16S-1530nt-pair", long16[1][:2])
        count(_main_path(*pair, dev, tmp, fused)[0])
        _placements(pair[0], gotoh_cuda.cluster_size(1, 1536, 1536, dev),
                    gotoh_cuda.cluster_size(2, 1536, 1536, dev,
                                            gotoh_cuda.K4_SWEEP))
        print("graphed and eager dispatches in turns:")
        for family in (trna, long16):
            _turns_path(family, dev, tmp, fused, one[family[0]])
        print("mixed lengths, three buckets, serial and pipelined:")
        count(_mixed_path(("mixed-trna+300nt", trna[1] + rrna[1]), dev, tmp,
                          fused))
        print("each chunk's lanes split over [cuda:0, cuda:0] "
              "(lara_tpu_torch.parallel.mesh):")
        for label, records in (trna, long16):
            count(_sharded_path(label, records, dev, tmp, fused, one[label]))
        if torch.cuda.device_count() > 1:
            cards = [torch.device("cuda", k)
                     for k in range(torch.cuda.device_count())]
            count(_main_path(*trna, dev, tmp, fused, devices=cards,
                             same_as=(one[trna[0]][1],
                                      one[trna[0]][3].results))[0])
        else:
            print("  one card: no number over several cards was measured")
        print("two hosts' processes over gloo, on one card:")
        _two_process_path(os.path.join(tmp, f"{trna[0]}.ebpseq"),
                          one[trna[0]], tmp)
        print("the repository's families, --predict builtin --msa:")
        count(_quality_path(dev, tmp, fused))
        print("hybrid backend (host matching):")
        count(_main_path(*trna, dev, tmp, ("gotoh_dp", "gotoh_tb") + K4,
                         matching=0)[0])
        count(_main_path(*rrna, dev, tmp, ("gotoh_resident",) + K4,
                         matching=12, env={"LARA_DP_RESIDENT": "1"})[0])
        print("fused path, grid-variant DP kernels (LARA_DP_GRID=1):")
        grid_run = _main_path(*trna, dev, tmp, GRID_ITERATION + K4,
                              env={"LARA_DP_GRID": "1"})
        _exact_launches(f"{trna[0]} LARA_DP_GRID=1", grid_run[0],
                        grid_run[3].results, 1, kernels=GRID_ITERATION)
        count(grid_run[0])
    print("KB's entry point, python -m "
          "lara_tpu_torch.benchmark.profile_wavefront_layout:")
    kb_run, kb_per_step = _kb_path()
    count(kb_run)
    print(f"  kernel launches, each from the runs meant to launch it: "
          f"{launches}")
    print("where one chunk's solve spends its time, eager and graphed:")
    chunks = [(trna, None), (rrna, None), (long16, None),
              (trna, {"LARA_DP_GRID": "1"})]
    # every unprofiled timing first: no profiler has run in this process
    walls = [_profile_phase(*family, dev, stats, env=env)
             for family, env in chunks]
    for (family, env), wall in zip(chunks, walls):
        _profile_phase(*family, dev, stats, env=env, walls=wall)
    foreign = sorted(m for m in sys.modules
                     if m in ("jax", "lara_tpu", "bench", "benchmark")
                     or m.startswith(("jax.", "lara_tpu.", "benchmark.")))
    if foreign:
        raise AssertionError(f"the port loaded {foreign[:5]}")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        # the first shape is the main path's (the tRNA chunk's)
        shape, _err, ms, plain_ms, bound_ms, bound_by, *extra = \
            stats[name][0]
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(s[1] for s in stats[name]),
            "ms": _sig(ms), "plain_ms": _sig(plain_ms),
            "bound_ms": _sig(bound_ms), "bound_by": bound_by,
            # no PyTorch call computes an affine-gap DP, its traceback, the
            # greedy lookahead matching, the edge filter, KB's chain or a
            # part of the iteration body; the loop exit's is any()
            "library_ms": _sig(plain_ms) if name == "loop_exit" else None,
            "shape": shape}
        for more in extra:  # K3: the rounds of the longest lane; KB: reps
            entry.update(more)
        if name == "wavefront_chain":
            entry["us_per_step"] = {label: round(per * 1e6, 6)
                                    for label, per in kb_per_step.items()}
        if name in ALSO_REPLACES:
            entry["also_replaces"] = ALSO_REPLACES[name]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

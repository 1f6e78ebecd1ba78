"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py`` (no arguments, one
card, no JAX).  Phases, each fatal on failure:

1. build the CUDA kernels of ``lara_tpu_torch/csrc`` and the native host
   libraries (g++) before anything is timed, and print the card, its power
   limit, the torch version and the build times;
2. hold every kernel against its plain PyTorch version on the card, exactly
   (integer outputs, zero tolerance), at the main path's shapes, and time
   both with CUDA events:
   K1 + K2 (wavefront DP + traceback), K1-grid + K2-grid (one launch per
   block of diagonals) and K-res (both in one CTA, codes in shared memory)
   at B=128 96x96 and B=32 320x320, K1 + K2 at the 16S chunk's B=32
   1536x1536 (55 KB of opt-in shared memory), K3 (greedy matching) at the
   main path's B=128 and B=32 with W=512 columns and B=32 W=1536 S=1536,
   and at B=128 with W=256 and W=1024, lookahead 1, 2, 5, 8;
3. drive the port's paths through ``lara_tpu_torch.app.run`` on the bench's
   tRNA family (120 pairs of ~72 nt), a ~300 nt family (28 pairs), the
   bench's 16S family (28 pairs of 1530 nt, one 1536x1536 bucket) and the
   tRNA and ~300 nt families as one (276 pairs in three buckets): the
   fused main path with default parameters on all four (16S is one chunk,
   the mixed family's buckets run one after another), lane refill
   (``LARA_REFILL=1 LARA_MAX_BATCH=64``: 120 tRNA pairs through 64 lanes),
   the hybrid backend at ``-m 0`` on tRNA, the hybrid at ``-m 12`` on
   ~300 nt under ``LARA_DP_RESIDENT=1``, and the fused path under
   ``LARA_DP_GRID=1`` on tRNA.  Every pair must equal the native C++
   baseline under ``bench._full_depth_ok`` (columns, best_lower,
   best_upper, iterations; on 16S the native pairs run on a thread pool,
   and three of them again alone for the one-thread rate), the library bytes must equal the library built from the native
   results, and the launch counts, set to 0 before each run, must show
   exactly the kernels the run is meant to launch.  16S runs again under
   ``LARA_SPLIT_SINGLE=1 LARA_PIPELINE=1`` (split 14 + 14, pipelined) and
   under ``LARA_NO_PIPELINE=1``, the mixed family serial and under
   ``LARA_PIPELINE=1`` in turns; each must write the same bytes;
4. profile 25 warm iterations of the tRNA, ~300 nt and 16S chunks: the
   unprofiled wall per iteration, and from ``torch.profiler`` the device
   busy share, kernels per iteration and the K1/K2/K3 time.

It then prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and
power limit, and as the last line ``{"ok": true, "device": {...}}``.
Without CUDA, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
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
    "gotoh_grid_dp": ("lara_tpu_torch/csrc/gotoh_grid.cu",
                      "lara_tpu/ops/gotoh_pallas.py:41"),
    "gotoh_grid_tb": ("lara_tpu_torch/csrc/gotoh_grid.cu",
                      "lara_tpu/ops/gotoh_pallas.py:145"),
    # one kernel for both resident TPU kernels (K1-res :468, K2-res :550)
    "gotoh_resident": ("lara_tpu_torch/csrc/gotoh_resident.cu",
                       "lara_tpu/ops/gotoh_pallas.py:468"),
}
ALSO_REPLACES = {"gotoh_resident": "lara_tpu/ops/gotoh_pallas.py:550"}


def _time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` calls (CUDA events,
    after one warm-up call)."""
    import torch

    fn()
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


def _dp_phase(b, la_max, lb_max, seed, dev, stats, variants=True):
    """K1 + K2, and with ``variants`` K1-grid + K2-grid and K-res, against
    the plain DP and traceback on one random batch.  The variants compute
    the plain versions' functions, so their plain times are K1's and
    K2's."""
    import torch

    from lara_tpu.types import PSSM_INIT
    from lara_tpu_torch.ops import gotoh, gotoh_cuda, gotoh_plan

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
    skewed = gotoh.skew_scores(pssm_t, int(PSSM_INIT)) if variants else None
    if variants and gotoh_plan.resident_bytes(la_max, lb_max) \
            > gotoh_cuda.smem_optin(dev):
        raise AssertionError(f"{la_max}x{lb_max} does not fit K-res")

    dirs_k, finals_k = gotoh_cuda.dp_forward(pssm_t, la_t, lb_t, go, ge)
    dirs_p, finals_p = gotoh.dp_forward(pssm_t, la_t, lb_t, go, ge)
    tb_k = gotoh_cuda.dp_traceback(dirs_k, finals_k, la_t, lb_t, go, ge,
                                   seq_t)
    tb_p = gotoh.dp_traceback(dirs_p, finals_p, la_t, lb_t, go, ge, seq_t)
    if variants:
        dirs_g, finals_g = gotoh_cuda.dp_forward_grid(skewed, la_t, lb_t, go,
                                                      ge, dchunk)
        tb_g = gotoh_cuda.dp_traceback_grid(dirs_g, finals_g, la_t, lb_t, go,
                                            ge, seq_t, dchunk)
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

    errs = {"gotoh_dp": dp_err(dirs_k, finals_k), "gotoh_tb": tb_err(tb_k)}
    if variants:
        errs.update({
            "gotoh_grid_dp": dp_err(
                dirs_g[:la_max + lb_max + 1].permute(1, 0, 2), finals_g),
            "gotoh_grid_tb": tb_err(tb_g),
            "gotoh_resident": tb_err(tb_r),
        })
    if any(errs.values()):
        raise AssertionError(f"a DP kernel disagrees with the plain version "
                             f"at B={b} {la_max}x{lb_max}: {errs}")

    plain_dp = _time_ms(lambda: gotoh.dp_forward(pssm_t, la_t, lb_t, go, ge),
                        2)
    plain_tb = _time_ms(lambda: gotoh.dp_traceback(
        dirs_p, finals_p, la_t, lb_t, go, ge, seq_t), 2)
    times = {
        "gotoh_dp": (
            _time_ms(lambda: gotoh_cuda.dp_forward(pssm_t, la_t, lb_t, go, ge),
                     50), plain_dp),
        "gotoh_tb": (
            _time_ms(lambda: gotoh_cuda.dp_traceback(
                dirs_k, finals_k, la_t, lb_t, go, ge, seq_t), 50), plain_tb),
    }
    if variants:
        times.update(_variant_times(pssm_t, skewed, la_t, lb_t, go, ge, seq_t,
                                    dchunk, dirs_g, finals_g, plain_dp,
                                    plain_tb))
    shape = f"B={b} {la_max}x{lb_max}"
    for name, err in errs.items():
        ms, plain_ms = times[name]
        label = f"{shape} dchunk={dchunk}" if "grid" in name else shape
        stats[name].append((label, err, ms, plain_ms))
        print(f"  {name:16s} {label:24s} max_abs_err {err}  kernel "
              f"{ms:.4f} ms  plain {plain_ms:.4f} ms")


def _variant_times(pssm_t, skewed, la_t, lb_t, go, ge, seq_t, dchunk, dirs_g,
                   finals_g, plain_dp, plain_tb):
    from lara_tpu_torch.ops import gotoh_cuda

    return {
        "gotoh_grid_dp": (
            _time_ms(lambda: gotoh_cuda.dp_forward_grid(
                skewed, la_t, lb_t, go, ge, dchunk), 20), plain_dp),
        "gotoh_grid_tb": (
            _time_ms(lambda: gotoh_cuda.dp_traceback_grid(
                dirs_g, finals_g, la_t, lb_t, go, ge, seq_t, dchunk), 20),
            plain_tb),
        "gotoh_resident": (
            _time_ms(lambda: gotoh_cuda.align_resident(
                pssm_t, la_t, lb_t, go, ge, seq_t), 50), plain_dp + plain_tb),
    }


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


def _matching_phase(b, width, slots, lookahead, seed, dev, stats):
    import torch

    from lara_tpu_torch.solver import matching_cuda, matching_device

    args = [torch.from_numpy(x).to(dev)
            for x in _matching_case(b, width, slots, seed)]
    got = matching_cuda.rounds_loop_cuda(*args, lookahead)
    want = matching_device.rounds_loop(*args, lookahead)
    torch.cuda.synchronize()
    err = max(_max_abs_err(got.score, want.score),
              _max_abs_err(got.used_slot, want.used_slot))
    if err:
        raise AssertionError(f"K3 disagrees with the plain version at B={b} "
                             f"W={width} lh={lookahead}: {err}")
    ms = _time_ms(lambda: matching_cuda.rounds_loop_cuda(*args, lookahead), 20)
    plain_ms = _time_ms(lambda: matching_device.rounds_loop(*args, lookahead),
                        2)
    shape = f"B={b} W={width} S={slots} lh={lookahead}"
    stats["matching_rounds"].append((shape, err, ms, plain_ms))
    print(f"  {'matching_rounds':16s} {shape:24s} max_abs_err {err}  kernel "
          f"{ms:.4f} ms  plain {plain_ms:.4f} ms")


def _native_check(name, store, pairs, params, run, library, threads):
    """Every pair of ``run`` against the native C++ baseline at full depth,
    and the library bytes against the one built from the native results.
    The native pairs run on ``threads`` host threads (the native library
    releases the GIL).  Returns (seconds, pairs) of one lone host thread:
    all pairs when ``threads`` is 1, else three evenly spaced pairs solved
    again one after another, since threads running together slow each
    other."""
    from concurrent.futures import ThreadPoolExecutor

    from bench import _full_depth_ok
    from lara_tpu.io.writers import OutputLibrary
    from lara_tpu.native import baseline as native_baseline

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
            if not _full_depth_ok(dev_res, nat.columns, nat.best_lower,
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


def _main_path(label, records, dev, tmp, expect, matching=5, env=None,
               native_threads=1, same_as=None):
    """One run of the port's CLI path on a family.  The launch counts are
    set to 0 just before the run and read just after it; the kernels that
    launched must be exactly ``expect``.  Every pair is checked against the
    native C++ baseline (on ``native_threads`` threads), or, with
    ``same_as``, the library bytes against that library.  Returns (counts,
    library, wall seconds)."""
    import torch

    from lara_tpu.app import enumerate_pairs, load_input
    from lara_tpu.io.writers import write_ebpseq
    from lara_tpu.params import Parameters
    from lara_tpu.utils import timing
    from lara_tpu_torch import _build, app
    from lara_tpu_torch.solver import hybrid_driver

    env = env or {}
    name = f"{label} -m {matching}" + "".join(f" {k}={v}"
                                              for k, v in env.items())
    path = os.path.join(tmp, f"{label}.ebpseq")
    with open(path, "w") as handle:
        write_ebpseq(records, handle)
    params = Parameters(in_file=path, out_file=os.path.join(tmp, f"{label}.lib"),
                        matching=matching)
    os.environ.update(env)
    try:
        _build.reset_launches()
        hybrid_driver.turns = 0
        start = time.perf_counter()
        run = app.run(params, dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches = dict(_build.launches)
    finally:
        for key in env:
            del os.environ[key]
    phases = timing.snapshot()
    with open(params.out_file) as handle:
        library = handle.read()
    launched = {k for k, n in launches.items() if n}
    if launched != set(expect):
        raise AssertionError(f"{name}: launched {sorted(launched)}, expected "
                             f"{sorted(expect)} ({launches})")

    store = load_input(params)
    pairs = enumerate_pairs(store)
    iters = [r.iterations for r in run.results]
    if same_as is not None:
        if library != same_as or len(run.results) != len(pairs):
            raise AssertionError(f"{name}: library differs from the one of "
                                 "the run before")
        checked = "the same library bytes as the run before"
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
        print(f"    hybrid: {turns} batched iterations, per iteration "
              f"{1e3 * phases['hybrid device step'] / turns:.3f} ms device "
              f"step (uploads, DP, download) + "
              f"{1e3 * phases['hybrid host step'] / turns:.3f} ms host step")
    if same_as is None:
        timed = "same pairs" if native_n == len(pairs) else \
            f"{native_n} evenly spaced pairs, run alone after the check on " \
            f"{native_threads} threads"
        print(f"    native C++ baseline, one host thread, {timed}: "
              f"{native_s:.3f} s, {native_n / native_s:.3f} alignments/s")
    print(f"    launches: {launches}")
    return launches, library, wall


def _refill_path(family, dev, tmp, expect):
    """The fused path with lane refill: 120 tRNA pairs through 64 lanes
    (``LARA_REFILL=1 LARA_MAX_BATCH=64``, the configuration the JAX driver
    measured, ``lara_tpu/solver/device_driver.py:124-128``)."""
    from lara_tpu_torch.solver import device_driver

    device_driver.last_refill = None
    run, _, _ = _main_path(*family, dev, tmp, expect,
                           env={"LARA_REFILL": "1", "LARA_MAX_BATCH": "64"})
    stats = device_driver.last_refill
    if stats is None or (stats.pairs, stats.lanes) != (120, 64):
        raise AssertionError(f"the refill did not run as configured: {stats}")
    print(f"    refill: {stats.pairs} pairs through {stats.lanes} lanes, "
          f"{stats.dispatches} dispatches, mean occupancy "
          f"{stats.occupancy:.4f}")
    return run


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


def _long_path(family, dev, tmp, expect):
    """The 16S family, one 1536x1536 bucket of 28 pairs.  By default it is
    one chunk of 32 lanes, neither split nor pipelined; every pair is
    checked against the native baseline on a thread pool.  Then
    ``LARA_SPLIT_SINGLE=1 LARA_PIPELINE=1`` (two halves of 14 pairs, 16
    lanes each, through the pipeline on the solver thread's stream) and
    ``LARA_NO_PIPELINE=1`` must write the same library bytes.  Returns the
    default run's launch counts."""
    walls = {}
    with _pipelined_chunks() as solved:
        run, library, walls["default"] = _main_path(
            *family, dev, tmp, expect, native_threads=os.cpu_count() or 1)
        if solved:
            raise AssertionError(f"16S default ran the pipeline: {solved}")
        _, _, walls["split + pipelined"] = _main_path(
            *family, dev, tmp, expect,
            env={"LARA_SPLIT_SINGLE": "1", "LARA_PIPELINE": "1"},
            same_as=library)
        if solved != [(14, True), (14, True)]:
            raise AssertionError(f"16S did not split and pipeline: {solved}")
    _, _, walls["LARA_NO_PIPELINE=1"] = _main_path(
        *family, dev, tmp, expect, env={"LARA_NO_PIPELINE": "1"},
        same_as=library)
    print("    16S wall: " + ", ".join(f"{k} {v:.3f} s"
                                       for k, v in walls.items())
          + " (pipelined phase times overlap and sum past the wall)")
    return run


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
        run, library, wall = _main_path(*family, dev, tmp, expect)
        walls = {"default (serial)": [wall], "LARA_PIPELINE=1": []}
        for key in ("LARA_PIPELINE=1", "default (serial)",
                    "LARA_PIPELINE=1"):
            env = {"LARA_PIPELINE": "1"} if key == "LARA_PIPELINE=1" else {}
            walls[key].append(_main_path(*family, dev, tmp, expect, env=env,
                                         same_as=library)[2])
    if len(solved) != 6 or not all(on_stream for _, on_stream in solved):
        raise AssertionError("the pipelined runs did not put 3 chunks each "
                             f"through the solver stream: {solved}")
    print("    mixed wall, in turns: " + "; ".join(
        f"{k} " + ", ".join(f"{w:.3f}" for w in v) + " s"
        for k, v in walls.items()))
    return run


def _profile_phase(label, records, dev, n_iter=25):
    """Where one chunk's solve spends its time: the unprofiled wall of
    ``n_iter`` warm iterations, and from ``torch.profiler`` over the same
    iterations the device time, kernels per iteration and K1/K2/K3 time.
    The busy share divides device time by the UNPROFILED wall (the profiler
    itself slows the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lara_tpu.app import enumerate_pairs
    from lara_tpu.params import Parameters
    from lara_tpu.solver.device_driver import _pad_dim
    from lara_tpu_torch.solver import device_driver, device_solver

    params = Parameters(in_file="<bench>")
    pad = _pad_dim(max(len(r.sequence) for r in records))
    pairs = enumerate_pairs(records)
    models, _ = device_driver._filter_and_build(
        records, pairs, params, pad, pad, dev)
    batch, scan_steps = device_driver._pack_models(models, pad, pad, dev)
    b, d = batch.dual_l.shape

    def solve():
        carry = device_solver._init_carry(
            b, d, pad, np.float32(params.step_size_factor),
            int(params.num_iterations), dev)
        device_solver.solve_batch_chunk(
            batch, carry, int(params.gap_open_int),
            int(params.gap_extend_int), pad, pad, n_iter,
            int(params.max_nondecr_iterations), int(params.matching),
            scan_steps)
        torch.cuda.synchronize()

    solve()
    start = time.perf_counter()
    solve()
    wall_ms = (time.perf_counter() - start) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solve()
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    ours = {name: sum(e.self_device_time_total for e in device
                      if f"{name}_kernel" in e.key) / n_iter
            for name in ("dp_forward", "dp_traceback", "matching_rounds")}
    print(f"  {label}: B={b} D={d} {pad}x{pad}, {n_iter} warm iterations: "
          f"{wall_ms / n_iter:.3f} ms/iteration unprofiled, device busy "
          f"{busy_ms / n_iter:.3f} ms/iteration ({busy_ms / wall_ms:.1%}), "
          f"{sum(e.count for e in device) / n_iter:.1f} kernels/iteration, "
          "K1/K2/K3 " + " / ".join(f"{us:.1f}" for us in ours.values())
          + " us/iteration")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from bench import make_family, make_long_family
    from lara_tpu_torch import _build

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    start = time.perf_counter()
    _build.library()
    print(f"kernel library: {_build.LIBRARY} (nvcc {_build.build_seconds():.1f}"
          f" s, load {time.perf_counter() - start:.1f} s)")
    # the native host libraries build with g++ at first use; build them
    # here, as the kernels above, so that no timed run pays for a build
    from lara_tpu.native import baseline as native_baseline, lagrange
    from lara_tpu.solver import interactions

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
    # the 16S chunk: K1 with 55 KB of opt-in shared memory, K2's walk of
    # up to 3072 steps (K-res does not fit, the grid kernels are off path)
    _dp_phase(32, 1536, 1536, 3, dev, stats, variants=False)
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

    families = [
        ("trna-72nt", make_family(n=16)),
        ("rrna-300nt", make_long_family(n=8, length=300, seed=31,
                                        mutations=12)),
        ("16S-1530nt-batch28", make_long_family(n=8, length=1530, seed=47)),
    ]
    trna, rrna, long16 = families
    fused = ("gotoh_dp", "gotoh_tb", "matching_rounds")
    launches = dict.fromkeys(KERNELS, 0)
    with tempfile.TemporaryDirectory() as tmp:
        print("main path: lara_tpu_torch.app.run, default parameters:")
        for label, records in (trna, rrna):
            run, _, _ = _main_path(label, records, dev, tmp, fused)
            for name in fused:
                launches[name] += run[name]
        print("lane refill:")
        run = _refill_path(trna, dev, tmp, fused)
        for name in fused:
            launches[name] += run[name]
        print("16S, one 1536x1536 bucket:")
        run = _long_path(long16, dev, tmp, fused)
        for name in fused:
            launches[name] += run[name]
        print("mixed lengths, three buckets, serial and pipelined:")
        run = _mixed_path(("mixed-trna+300nt", trna[1] + rrna[1]), dev, tmp,
                          fused)
        for name in fused:
            launches[name] += run[name]
        print("hybrid backend (host matching):")
        _main_path(*trna, dev, tmp, ("gotoh_dp", "gotoh_tb"), matching=0)
        run, _, _ = _main_path(*rrna, dev, tmp, ("gotoh_resident",),
                               matching=12, env={"LARA_DP_RESIDENT": "1"})
        launches["gotoh_resident"] = run["gotoh_resident"]
        print("fused path, grid-stepped DP kernels:")
        run, _, _ = _main_path(
            *trna, dev, tmp,
            ("gotoh_grid_dp", "gotoh_grid_tb", "matching_rounds"),
            env={"LARA_DP_GRID": "1"})
        launches["gotoh_grid_dp"] = run["gotoh_grid_dp"]
        launches["gotoh_grid_tb"] = run["gotoh_grid_tb"]
    print(f"  kernel launches, each from the runs meant to launch it: "
          f"{launches}")
    print("where one chunk's solve spends its time:")
    for label, records in (trna, rrna):
        _profile_phase(label, records, dev)
    _profile_phase(*long16, dev)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        _shape, _err, ms, plain_ms = stats[name][0]  # the main path's shape
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(e for _, e, _, _ in stats[name]),
            "ms": round(ms, 6), "plain_ms": round(plain_ms, 6)}
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

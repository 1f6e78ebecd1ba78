"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py`` (no arguments, one
card, no JAX, nothing of the JAX package).  Phases, each fatal on failure:

1. build the CUDA kernels of ``lara_tpu_torch/csrc`` and the port's native
   host libraries (g++) before anything is timed, and print the card, its
   power limit, the torch version, the build times and, from
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
   wrapper's clusters of CTAs per pair and at one CTA per pair; K2 as the
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
3. drive the port's paths through ``lara_tpu_torch.app.run`` on the bench's
   families (``lara_tpu_torch.workloads``, copies of ``bench.py``'s): tRNA
   (120 pairs of ~72 nt), ~300 nt (28 pairs), 16S (28 pairs of 1530 nt,
   one 1536x1536 bucket) and the tRNA and ~300 nt families as one (276
   pairs in three buckets): the fused main path with default parameters on
   all four (16S is one chunk, the mixed family's buckets run one after
   another), lane refill (``LARA_REFILL=1 LARA_MAX_BATCH=64``: 120 tRNA
   pairs through 64 lanes), the hybrid backend at ``-m 0`` on tRNA, the
   hybrid at ``-m 12`` on ~300 nt under ``LARA_DP_RESIDENT=1``, and the
   fused path under ``LARA_DP_GRID=1`` on tRNA; and KB's own entry
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
   K1-grid + K2-grid + K3) exactly once per iteration.
   16S runs again under
   ``LARA_SPLIT_SINGLE=1 LARA_PIPELINE=1`` (split 14 + 14, pipelined) and
   under ``LARA_NO_PIPELINE=1``, the mixed family serial and under
   ``LARA_PIPELINE=1`` in turns; each must write the same bytes.  Over
   shards the count is once per iteration of each shard's dispatches.
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
4. profile 25 warm iterations of the tRNA, ~300 nt and 16S chunks, and of
   the tRNA chunk under ``LARA_DP_GRID=1``: the unprofiled wall per
   iteration, and from ``torch.profiler`` the device busy share, kernels
   per iteration and the K1/K2/K3 (K1-grid/K2-grid/K3) time; K3 is held
   against the plain version, and timed, on the solver's own arguments of
   iterations 1-3 and 25.

It then checks that neither JAX nor any module of the JAX package (nor
``bench``, nor the repository's ``benchmark``) was loaded, prints a
``{"kernels": [...]}`` line, the
``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``.  Without CUDA, or outside a checkout of
the repository, it exits non-zero and prints no result.
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
    # pack (edge_filter_skewed_words)
    "edge_sweep": ("lara_tpu_torch/csrc/gotoh_dp.cu",
                   "lara_tpu/ops/gotoh.py:337"),
    "edge_pack": ("lara_tpu_torch/csrc/edge_filter.cu",
                  "lara_tpu/ops/gotoh.py:337"),
    # KB, the wavefront-layout microbenchmark (make_chain's pallas_call :76)
    "wavefront_chain": ("lara_tpu_torch/csrc/wavefront_chain.cu",
                        "benchmark/profile_wavefront_layout.py:47"),
}
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
    own output, and the wrapper's words against the plain filter (two
    scans).  Each is timed beside its bound; returns K4's ms (sweep and
    pack, as the driver calls them)."""
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
    filter_k = gotoh_cuda.edge_filter_skewed_words(*inputs, go, ge, subopt,
                                                   la_max, lb_max)
    prefix_p, finals_p = gotoh.edge_sweep(*inputs, go, ge)
    words_p = gotoh.edge_pack(prefix_k, finals_k, *inputs, subopt)
    filter_p = gotoh.edge_filter_skewed_words(*inputs, go, ge, subopt,
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
    k4_ms = _time_ms(lambda: gotoh_cuda.edge_filter_skewed_words(
        *inputs, go, ge, subopt, la_max, lb_max), 20)
    plain_ms = _time_ms(lambda: gotoh.edge_filter_skewed_words(
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


def _main_path(label, records, dev, tmp, expect, matching=5, env=None,
               native_threads=1, same_as=None, devices=None, **params_kw):
    """One run of the port's CLI path on a family (``records``, or the
    path of an input file), on ``dev`` or split over ``devices``.  The
    launch counts are set to 0 just before the run and read just after it;
    the kernels that launched must be exactly ``expect``, and K4's two
    exactly once per chunk the run filtered.  Every pair is
    checked against the native C++ baseline (on ``native_threads``
    threads), or, with ``same_as`` (an earlier run's (library, results)),
    the library bytes against that library and every pair against that
    run's.  Returns (counts, library, wall seconds, run)."""
    import torch

    from lara_tpu_torch import _build, app
    from lara_tpu_torch.io.writers import write_ebpseq
    from lara_tpu_torch.params import Parameters
    from lara_tpu_torch.solver import hybrid_driver
    from lara_tpu_torch.utils import timing

    env = env or {}
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
        with _filtered_chunks() as chunks:
            _build.reset_launches()
            hybrid_driver.turns = 0
            start = time.perf_counter()
            run = app.run(params, dev, devices)
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
    if not launches["edge_sweep"] == launches["edge_pack"] == len(chunks):
        raise AssertionError(f"{name}: K4 launched {launches['edge_sweep']} "
                             f"sweeps and {launches['edge_pack']} packs for "
                             f"{len(chunks)} filtered chunks {chunks}")

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
    print(f"    launches: {launches}; {len(chunks)} chunk(s) filtered "
          f"({', '.join(map(str, chunks))} pairs)")
    return launches, library, wall, run


def _pair_keys(results):
    return sorted((r.seq_indices, r.columns, r.score, r.iterations,
                   r.best_upper, r.best_lower) for r in results)


def _refill_path(family, dev, tmp, expect):
    """The fused path with lane refill: 120 tRNA pairs through 64 lanes
    (``LARA_REFILL=1 LARA_MAX_BATCH=64``, the configuration the JAX driver
    measured, ``lara_tpu/solver/device_driver.py:124-128``)."""
    from lara_tpu_torch.solver import device_driver

    device_driver.last_refill = None
    run = _main_path(*family, dev, tmp, expect,
                     env={"LARA_REFILL": "1", "LARA_MAX_BATCH": "64"})[0]
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


def _long_path(family, dev, tmp, expect, k4_ms):
    """The 16S family, one 1536x1536 bucket of 28 pairs.  By default it is
    one chunk of 32 lanes, neither split nor pipelined; every pair is
    checked against the native baseline on a thread pool.  Then
    ``LARA_SPLIT_SINGLE=1 LARA_PIPELINE=1`` (two halves of 14 pairs, 16
    lanes each, through the pipeline on the solver thread's stream) and
    ``LARA_NO_PIPELINE=1`` must write the same library bytes.  The default
    run's "edge filter (device)" phase is printed beside ``k4_ms``, K4's
    time at B=32 1536x1536 in phase 2.  Returns the default run's (launch
    counts, library, wall, run)."""
    from lara_tpu_torch.utils import timing

    walls = {}
    with _pipelined_chunks() as solved:
        default = _main_path(*family, dev, tmp, expect,
                             native_threads=os.cpu_count() or 1)
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
    walls["LARA_NO_PIPELINE=1"] = _main_path(
        *family, dev, tmp, expect, env={"LARA_NO_PIPELINE": "1"},
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
FUSED_ITERATION = ("gotoh_dp", "gotoh_tb", "matching_rounds")
GRID_ITERATION = ("gotoh_grid_dp", "gotoh_grid_tb", "matching_rounds")


def _exact_launches(name, launches, results, shards,
                    kernels=FUSED_ITERATION):
    """Gate: a fused run of one chunk over ``shards`` shards launched each
    of ``kernels`` (K1, K2 and K3, or K1-grid, K2-grid and K3) exactly once
    per iteration of each shard's dispatches.  Lane k
    holds the chunk's pair k (results in task order), the lanes pad to
    ``device_driver._padded_batch`` and then to a multiple of the shards
    (padding lanes converge in one iteration), and each shard runs
    ``ceil(its longest lane / LARA_CHUNK) * LARA_CHUNK`` iterations, at most
    500.  Returns each shard's iterations."""
    from lara_tpu_torch.solver import device_driver, device_solver

    lanes = device_driver._padded_batch(len(results), shards)
    lanes += (-lanes) % shards
    iters = [r.iterations for r in results] + [1] * (lanes - len(results))
    per, chunk = lanes // shards, device_solver.dispatch_size()
    ran = [min(500, -(-max(iters[k * per:(k + 1) * per]) // chunk) * chunk)
           for k in range(shards)]
    want = {k: sum(ran) for k in kernels}
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"{name}: launched {got}, expected {want} "
                             f"({shards} shard(s) of {per} lanes running "
                             f"{ran} iterations)")
    return ran


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
    print(f"    {label}: shards ran {ran} iterations; wall in turns (two, "
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


def _profile_phase(label, records, dev, stats, n_iter=25, env=None):
    """Where one chunk's solve spends its time, under the switches ``env``
    (``LARA_DP_GRID=1``: K1-grid and K2-grid in place of K1 and K2): the
    unprofiled wall of ``n_iter`` warm iterations, and from
    ``torch.profiler`` over the same iterations the device time, kernels
    per iteration and K1/K2/K3 time.
    The busy share divides device time by the UNPROFILED wall (the profiler
    itself slows the host).  K3's arguments in iterations 1, 2, 3 and
    ``n_iter`` of the first solve are kept, and K3 is held against the
    plain version and timed on them: the solver's real queues."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lara_tpu_torch.app import enumerate_pairs
    from lara_tpu_torch.params import Parameters
    from lara_tpu_torch.solver import device_driver, device_solver

    params = Parameters(in_file="<bench>")
    pad = device_driver._pad_dim(max(len(r.sequence) for r in records))
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

    env = env or {}
    os.environ.update(env)
    try:
        with _k3_calls({0, 1, 2, n_iter - 1}) as calls:
            solve()
        start = time.perf_counter()
        solve()
        wall_ms = (time.perf_counter() - start) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            solve()
    finally:
        for key in env:
            del os.environ[key]
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    # K1 is dp_wave_kernel<false, false>, K1-grid <false, true>; K2 and
    # K2-grid are both dp_walk_kernel
    ours = {name: sum(e.self_device_time_total for e in device
                      if f"{name}_kernel" in e.key) / n_iter
            for name in ("dp_wave", "dp_walk", "matching_rounds")}
    names = "K1-grid/K2-grid/K3" if env.get("LARA_DP_GRID") else "K1/K2/K3"
    label += "".join(f" {k}={v}" for k, v in env.items())
    print(f"  {label}: B={b} D={d} {pad}x{pad}, {n_iter} warm iterations: "
          f"{wall_ms / n_iter:.3f} ms/iteration unprofiled, device busy "
          f"{busy_ms / n_iter:.3f} ms/iteration ({busy_ms / wall_ms:.1%}), "
          f"{sum(e.count for e in device) / n_iter:.1f} kernels/iteration, "
          f"{names} " + " / ".join(f"{us:.1f}" for us in ours.values())
          + " us/iteration")
    for k in sorted(calls):
        args = calls[k]
        _hold_matching(f"{label} iteration {k + 1}", args[:5], args[5],
                       stats, time_plain=False)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from lara_tpu_torch import _build
    from lara_tpu_torch.workloads import make_family, make_long_family

    dev = torch.device("cuda", 0)
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

    families = [
        ("trna-72nt", make_family(n=16)),
        ("rrna-300nt", make_long_family(n=8, length=300, seed=31,
                                        mutations=12)),
        ("16S-1530nt-batch28", make_long_family(n=8, length=1530, seed=47)),
    ]
    trna, rrna, long16 = families
    fused = FUSED_ITERATION + K4
    launches = dict.fromkeys(KERNELS, 0)

    def count(run):
        for name, n in run.items():
            launches[name] += n

    with tempfile.TemporaryDirectory() as tmp:
        print("main path: lara_tpu_torch.app.run, default parameters:")
        one = {}
        for label, records in (trna, rrna):
            one[label] = _main_path(label, records, dev, tmp, fused)
            _exact_launches(label, one[label][0], one[label][3].results, 1)
            count(one[label][0])
        print("lane refill:")
        count(_refill_path(trna, dev, tmp, fused))
        print("16S, one 1536x1536 bucket:")
        one[long16[0]] = _long_path(long16, dev, tmp, fused, k4_16s)
        count(one[long16[0]][0])
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
    print("where one chunk's solve spends its time:")
    for label, records in (trna, rrna):
        _profile_phase(label, records, dev, stats)
    _profile_phase(*long16, dev, stats)
    _profile_phase(*trna, dev, stats, env={"LARA_DP_GRID": "1"})
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
            "ms": round(ms, 6), "plain_ms": round(plain_ms, 6),
            "bound_ms": round(bound_ms, 6), "bound_by": bound_by,
            # no PyTorch call computes an affine-gap DP, its traceback, the
            # greedy lookahead matching, the edge filter or KB's chain
            "library_ms": None, "shape": shape}
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

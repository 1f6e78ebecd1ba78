"""The PyTorch port's CUDA kernels vs. their plain PyTorch versions, on a card.

K1 + K2, K1-grid + K2-grid (K1's and K2's kernels over the grid
variant's layouts), K-res and K4's sweep and pack (the edge filter;
``lara_tpu_torch.ops.gotoh_cuda``), K3
(``lara_tpu_torch.solver.matching_cuda``) and KB, the wavefront-layout
microbenchmark (``lara_tpu_torch.benchmark.profile_wavefront_layout``),
against the plain versions
on the same CUDA tensors, with zero tolerance (every output is an
integer), K1 + K2 and K1-grid + K2-grid at the 16S bucket's 1536 x 1536
included, K3 at ragged
widths, arbitrary ids, lookahead 1-8, a queue wider than its ring and its
shared-memory set, and on the solver's own 16S queues; the driver's
paths (fused, hybrid, the cross-chunk pipeline on its CUDA streams) on
the card against the CPU; the dispatch
graph (a CUDA graph of one solver iteration, replayed) against the
eager loop, and a K1 graph replayed after a launch that needs less
shared memory.  This
file imports no JAX and nothing of ``lara_tpu``, so it runs on a machine
that has a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` configures JAX).  Without a card
every test skips.
"""

import numpy as np
import pytest
import torch

from lara_tpu_torch import _build
from lara_tpu_torch.ops import gotoh, gotoh_cuda, gotoh_plan
from lara_tpu_torch.solver import matching_cuda, matching_device
from lara_tpu_torch.types import PSSM_INIT

pytestmark = pytest.mark.cuda

GO, GE = -49152, -16384
#: the iteration body's kernels (csrc/iteration.cu), once per iteration of
#: every fused path
ITERATION = {"iteration_head", "iteration_lines", "iteration_tail"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda", 0)


def _int_equal(got, want, name):
    assert got.shape == want.shape, name
    assert torch.equal(got.to(torch.int64), want.to(torch.int64)), name


def iteration_case(b, la_max, lb_max, d, seed, hub=0):
    """A random ragged batch for the iteration body (numpy): (BatchModel
    rows, carry rows, partner [B, LA]).  Each lane's dual table is
    edge-major, as the solver's: the entries (l, m) and (m, l) of random
    interactions between random edges inside the lane's la x lb, sorted by
    (l, m), one contiguous run per edge, ``rev`` pairing each entry with its
    reverse, padding (l = m = 0, identity ``rev``) after the valid entries.
    Interaction scores come from a few values, so profits tie; with ``hub``
    one edge interacts with ``hub`` others (a run that long).  The carry
    has random duals, lanes active or not, some lanes still at the initial
    bounds or at equal bounds, and counts near their ends; the partner rows
    put many of the dual table's edges on lines."""
    from lara_tpu_torch.types import INFINITY

    rng = np.random.default_rng(seed)
    ne = la_max * lb_max
    la = rng.integers(1, la_max + 1, b).astype(np.int32)
    lb = rng.integers(1, lb_max + 1, b).astype(np.int32)
    la[0], lb[0] = la_max, lb_max
    seq_score = rng.integers(-5000, 5000, (b, ne)).astype(np.int32)
    active = rng.random((b, ne)) < 0.7
    dual_l = np.zeros((b, d), np.int32)
    dual_m = np.zeros((b, d), np.int32)
    sscore = np.zeros((b, d), np.int32)
    rev = np.broadcast_to(np.arange(d, dtype=np.int32), (b, d)).copy()
    dvalid = np.zeros((b, d), bool)
    qrank = np.stack([rng.permutation(d) for _ in range(b)]).astype(np.int32)
    partner = np.full((b, la_max), -1, np.int32)
    for k in range(b):
        cells = la[k] * lb[k]
        edges = rng.choice(cells, min(cells, max(2, d // 3)), replace=False)
        edges = (edges // lb[k]) * lb_max + edges % lb[k]
        pairs = {}
        if hub and len(edges) > 1:
            for y in edges[1:hub + 1]:
                pairs[(min(edges[0], y), max(edges[0], y))] = None
        target = min(int(rng.integers(d // 4, d // 2 + 1)),
                     len(edges) * (len(edges) - 1) // 2)
        for _ in range(20 * d):
            if len(pairs) >= target:
                break
            x, y = rng.choice(edges, 2, replace=False)
            pairs[(min(x, y), max(x, y))] = None
        pairs = list(pairs)[: d // 2]
        scores = rng.choice([-20, 0, 7, 7, 13, 40], len(pairs))
        entries = sorted([(x, y, s) for (x, y), s in zip(pairs, scores)]
                         + [(y, x, s) for (x, y), s in zip(pairs, scores)])
        n = len(entries)
        where = {(x, y): i for i, (x, y, _) in enumerate(entries)}
        for i, (x, y, s) in enumerate(entries):
            dual_l[k, i], dual_m[k, i], sscore[k, i] = x, y, s
            rev[k, i] = where[(y, x)]
        dvalid[k, :n] = True
        on_lines = rng.choice(edges, len(edges) // 2, replace=False)
        for e in on_lines:
            partner[k, e // lb_max] = e % lb_max
        partner[k, la[k]:] = -1
    dual = np.where(dvalid, rng.integers(-60, 60, (b, d)), 0).astype(np.int32)
    dual[dvalid & (rng.random((b, d)) < 0.1)] = 0
    inf = int(INFINITY)
    best_lower = rng.integers(-9000, 0, b).astype(np.int32)
    best_upper = (best_lower + rng.integers(0, 9000, b)).astype(np.int32)
    fresh = rng.random(b) < 0.3
    best_lower[fresh], best_upper[fresh] = -inf, inf
    equal = rng.random(b) < 0.15
    best_upper[equal] = best_lower[equal]
    carry = dict(
        dual=dual,
        dual_at_queue=rng.integers(-60, 60, (b, d)).astype(np.int32),
        step_factor=rng.uniform(0.01, 2.0, b).astype(np.float32),
        nondecr=rng.integers(0, 6, b).astype(np.int32),
        remaining=rng.integers(1, 4, b).astype(np.int32),
        lane_active=rng.random(b) < 0.8,
        best_lower=best_lower, best_upper=best_upper,
        best_score=rng.integers(-9000, 9000, b).astype(np.int32),
        best_partner=rng.integers(-1, lb_max, (b, la_max)).astype(np.int32),
        best_nlines=rng.integers(0, la_max, b).astype(np.int32),
        best_matched=rng.random((b, la_max)) < 0.5,
        iterations=rng.integers(0, 400, b).astype(np.int32))
    carry["lane_active"][0] = True
    model = dict(seq_score=seq_score, active=active, dual_l=dual_l,
                 dual_m=dual_m, sscore=sscore, rev=rev, dvalid=dvalid,
                 qrank=qrank, la=la, lb=lb)
    return model, carry, partner


def iteration_tensors(case, dev):
    """:func:`iteration_case` as (BatchModel, _Carry, partner) on ``dev``."""
    from lara_tpu_torch.solver import device_solver

    model, carry, partner = case
    return (device_solver.BatchModel(**{k: torch.from_numpy(v).to(dev)
                                        for k, v in model.items()}),
            device_solver._Carry(**{k: torch.from_numpy(v).to(dev)
                                    for k, v in carry.items()}),
            torch.from_numpy(partner).to(dev))


# (batch, la_max, lb_max, seed): tiny, ragged (la_max not a multiple of
# 32), the tRNA bucket, la_max > lb_max and la_max < lb_max far apart, more
# strips than one CTA's 16 warps (1100, 1400 rows), B above the H100's 132
# SMs
DP_CASES = [(4, 12, 10, 3), (9, 33, 47, 5), (16, 96, 96, 7), (2, 1100, 40, 9),
            (1, 1400, 16, 13), (3, 45, 700, 21), (140, 20, 30, 23)]


def _dp_problem(case, dev):
    b, la_max, lb_max, seed = case
    rng = np.random.default_rng(seed)
    pssm = rng.integers(-9000, 9000, (b, la_max, lb_max)).astype(np.int32)
    pssm[rng.random(pssm.shape) < 0.3] = PSSM_INIT
    seq = rng.integers(-5000, 5000, (b, la_max, lb_max)).astype(np.int32)
    la = rng.integers(1, la_max + 1, b).astype(np.int32)
    lb = rng.integers(1, lb_max + 1, b).astype(np.int32)
    la[0], lb[0] = la_max, lb_max
    if b > 1:
        la[1], lb[-1] = 1, 1
    return tuple(torch.from_numpy(x).to(dev) for x in (pssm, seq, la, lb))


def _valid_cells(la_t, lb_t, la_max, lb_max, dev):
    """[B, D, W] mask of the cells (i <= la, 0 <= d - i <= lb) on which the
    direction codes are defined."""
    d_idx = torch.arange(la_max + lb_max + 1, device=dev)[None, :, None]
    i_idx = torch.arange(la_max + 1, device=dev)[None, None, :]
    return (i_idx <= la_t[:, None, None]) & (d_idx >= i_idx) \
        & (d_idx - i_idx <= lb_t[:, None, None])


@pytest.mark.parametrize("case", DP_CASES)
def test_dp_kernels_match_plain(case, cuda):
    b, la_max, lb_max, _seed = case
    pssm_t, seq_t, la_t, lb_t = _dp_problem(case, cuda)

    before = dict(_build.launches)
    dirs_k, finals_k = gotoh_cuda.dp_forward(pssm_t, la_t, lb_t, GO, GE)
    tb_k = gotoh_cuda.dp_traceback(dirs_k, finals_k, la_t, lb_t, GO, GE, seq_t)
    # K1's codes and finals, with K1's kernel now a template that K4's
    # sweep shares (that instance never launches here)
    moved = {name: _build.launches[name] - before[name] for name in before}
    assert moved == dict.fromkeys(before, 0) | {"gotoh_dp": 1, "gotoh_tb": 1}
    dirs_p, finals_p = gotoh.dp_forward(pssm_t, la_t, lb_t, GO, GE)
    tb_p = gotoh.dp_traceback(dirs_p, finals_p, la_t, lb_t, GO, GE, seq_t)
    torch.cuda.synchronize()

    _int_equal(finals_k, finals_p, "finals")
    valid = _valid_cells(la_t, lb_t, la_max, lb_max, cuda)
    _int_equal(torch.where(valid, dirs_k, 0), torch.where(valid, dirs_p, 0),
               "dirs")
    for field, got, want in zip(gotoh.Traceback._fields, tb_k, tb_p):
        _int_equal(got, want, field)


@pytest.mark.parametrize("cluster", [1, 2, 4])
@pytest.mark.parametrize("case", [(2, 1100, 40, 9), (5, 300, 77, 11),
                                  (3, 45, 700, 21), (6, 64, 64, 25)])
def test_dp_kernel_cluster_sizes_match_plain(case, cluster, cuda):
    """K1 with 1, 2 and 4 CTAs per pair (at one CTA, 1100 rows are 35
    strips on 16 warps, so warps take several strips; at 2 and 4 the rings
    between strips cross CTAs through distributed shared memory)."""
    _b, la_max, lb_max, _seed = case
    pssm_t, _seq_t, la_t, lb_t = _dp_problem(case, cuda)
    dirs_k, finals_k = gotoh_cuda.dp_forward(pssm_t, la_t, lb_t, GO, GE,
                                             cluster=cluster)
    dirs_p, finals_p = gotoh.dp_forward(pssm_t, la_t, lb_t, GO, GE)
    torch.cuda.synchronize()
    _int_equal(finals_k, finals_p, "finals")
    valid = _valid_cells(la_t, lb_t, la_max, lb_max, cuda)
    _int_equal(torch.where(valid, dirs_k, 0), torch.where(valid, dirs_p, 0),
               "dirs")


def test_dp_kernel_refuses_a_stalling_schedule(cuda):
    """600 rows are 19 strips, more than one CTA's 16 warps, and rows of
    1800 cells would stall the strip schedule there (``ring_safe``): an
    explicit cluster of 1 raises before any launch, and the wrapper's own
    choice (4 CTAs, one strip per warp) runs and is exact."""
    case = (2, 600, 1800, 31)
    _b, la_max, lb_max, _seed = case
    pssm_t, _seq_t, la_t, lb_t = _dp_problem(case, cuda)
    assert not gotoh_cuda.ring_safe(la_max, lb_max, 1)
    before = _build.launches["gotoh_dp"]
    with pytest.raises(_build.KernelLaunchError):
        gotoh_cuda.dp_forward(pssm_t, la_t, lb_t, GO, GE, cluster=1)
    assert _build.launches["gotoh_dp"] == before
    assert gotoh_cuda.cluster_size(2, la_max, lb_max, cuda) == 4
    dirs_k, finals_k = gotoh_cuda.dp_forward(pssm_t, la_t, lb_t, GO, GE)
    dirs_p, finals_p = gotoh.dp_forward(pssm_t, la_t, lb_t, GO, GE)
    torch.cuda.synchronize()
    _int_equal(finals_k, finals_p, "finals")
    valid = _valid_cells(la_t, lb_t, la_max, lb_max, cuda)
    _int_equal(torch.where(valid, dirs_k, 0), torch.where(valid, dirs_p, 0),
               "dirs")


@pytest.mark.parametrize("go,ge", [(GO, GE), (5, 3), (0, 0)])
def test_dp_kernels_all_neg_inf_scores(go, ge, cuda):
    """Every score NEG_INF: the M sums wrap in int32 on every cell, and the
    codes, finals and traceback still equal the plain version's."""
    case = (6, 70, 50, 27)
    _b, la_max, lb_max, _seed = case
    pssm_t, seq_t, la_t, lb_t = _dp_problem(case, cuda)
    pssm_t.fill_(PSSM_INIT)
    dirs_k, finals_k = gotoh_cuda.dp_forward(pssm_t, la_t, lb_t, go, ge)
    tb_k = gotoh_cuda.dp_traceback(dirs_k, finals_k, la_t, lb_t, go, ge, seq_t)
    dirs_p, finals_p = gotoh.dp_forward(pssm_t, la_t, lb_t, go, ge)
    tb_p = gotoh.dp_traceback(dirs_p, finals_p, la_t, lb_t, go, ge, seq_t)
    torch.cuda.synchronize()
    _int_equal(finals_k, finals_p, "finals")
    valid = _valid_cells(la_t, lb_t, la_max, lb_max, cuda)
    _int_equal(torch.where(valid, dirs_k, 0), torch.where(valid, dirs_p, 0),
               "dirs")
    for field, got, want in zip(gotoh.Traceback._fields, tb_k, tb_p):
        _int_equal(got, want, field)


def _hold_grid(case, dchunk, dev, cluster=0):
    """K1-grid (through ``gotoh_scan``, or ``dp_forward_grid`` with an
    explicit ``cluster``) and K2-grid against the plain scan and traceback:
    one launch of each per call, whatever ``dchunk``, which only pads the
    codes to a multiple of its rows."""
    b, la_max, lb_max, _seed = case
    pssm_t, seq_t, la_t, lb_t = _dp_problem(case, dev)
    skewed = gotoh.skew_scores(pssm_t, int(PSSM_INIT))
    num_rows = -(-(la_max + lb_max + 1) // dchunk) * dchunk

    before = dict(_build.launches)
    if cluster:
        dirs_k, finals_k = gotoh_cuda.dp_forward_grid(
            skewed, la_t, lb_t, GO, GE, dchunk, cluster=cluster)
    else:
        res_k = gotoh_cuda.gotoh_scan(skewed, la_t, lb_t, GO, GE, dchunk)
        dirs_k = res_k.aux
        finals_k = torch.stack([res_k.final_m, res_k.final_h, res_k.final_v])
    tb_k = gotoh_cuda.dp_traceback_grid(dirs_k, finals_k, la_t, lb_t, GO, GE,
                                        seq_t, dchunk)
    moved = {name: _build.launches[name] - before[name] for name in before}
    assert moved == dict.fromkeys(before, 0) | {"gotoh_grid_dp": 1,
                                                "gotoh_grid_tb": 1}
    dirs_p, finals_p = gotoh.dp_forward(pssm_t, la_t, lb_t, GO, GE)
    tb_p = gotoh.dp_traceback(dirs_p, finals_p, la_t, lb_t, GO, GE, seq_t)
    torch.cuda.synchronize()

    _int_equal(finals_k, finals_p, "finals")
    assert dirs_k.shape == (num_rows, b, la_max + 1)
    valid = _valid_cells(la_t, lb_t, la_max, lb_max, dev)
    dirs_k = dirs_k[:la_max + lb_max + 1].permute(1, 0, 2)
    _int_equal(torch.where(valid, dirs_k, 0), torch.where(valid, dirs_p, 0),
               "dirs")
    for field, got, want in zip(gotoh.Traceback._fields, tb_k, tb_p):
        _int_equal(got, want, field)


@pytest.mark.parametrize("dchunk", [8, 32])
@pytest.mark.parametrize("case", DP_CASES)
def test_grid_kernels_match_plain(case, dchunk, cuda):
    """K1-grid and K2-grid against the plain versions; one launch of each
    per call, whatever ``dchunk``."""
    _hold_grid(case, dchunk, cuda)


def test_grid_kernels_at_16s_bucket(cuda):
    """K1-grid + K2-grid at the 16S bucket, B=32 1536 x 1536 and the fused
    path's dchunk 32: 49 strips on four CTAs per pair, and walks of up to
    3072 steps over [3104, 32, 1537] codes."""
    _hold_grid((32, 1536, 1536, 19), 32, cuda)


@pytest.mark.parametrize("cluster", [1, 2, 4])
@pytest.mark.parametrize("case", [(2, 1100, 40, 9), (5, 300, 77, 11),
                                  (3, 45, 700, 21), (6, 64, 64, 25)])
def test_grid_kernel_cluster_sizes_match_plain(case, cluster, cuda):
    """K1-grid with 1, 2 and 4 CTAs per pair (at one CTA, 1100 rows are 35
    strips on 16 warps; at 2 and 4 the rings between strips cross CTAs
    through distributed shared memory)."""
    _hold_grid(case, 8, cuda, cluster=cluster)


def test_grid_kernel_refuses_a_stalling_schedule(cuda):
    """K1-grid takes K1's shape limits: where ``dp_forward`` raises (the
    stalling shape of ``test_dp_kernel_refuses_a_stalling_schedule`` on one
    CTA per pair), ``dp_forward_grid`` raises before any launch, with no
    fallback; two CTAs per pair, the fewest that run it, and the wrapper's
    own cluster (4) are exact."""
    case = (2, 600, 1800, 31)
    pssm_t, _seq_t, la_t, lb_t = _dp_problem(case, cuda)
    skewed = gotoh.skew_scores(pssm_t, int(PSSM_INIT))
    before = dict(_build.launches)
    with pytest.raises(_build.KernelLaunchError):
        gotoh_cuda.dp_forward(pssm_t, la_t, lb_t, GO, GE, cluster=1)
    with pytest.raises(_build.KernelLaunchError):
        gotoh_cuda.dp_forward_grid(skewed, la_t, lb_t, GO, GE, 8, cluster=1)
    assert _build.launches == before
    assert not gotoh_cuda.ring_safe(600, 1800, 1)
    assert gotoh_cuda.ring_safe(600, 1800, 2)
    _hold_grid(case, 8, cuda, cluster=2)
    _hold_grid(case, 8, cuda)


@pytest.mark.parametrize("case", DP_CASES + [(2, 600, 600, 27)])
def test_resident_plan_and_kernel_match_plain(case, cuda, monkeypatch):
    """Under LARA_DP_RESIDENT=1 the plan takes K-res where the pair fits
    the card's opt-in shared memory and K1 + K2 where it does not (the
    600 x 600 case: its codes alone take 382,236 bytes); either way the
    result, lines included, equals the plain version's."""
    b, la_max, lb_max, _seed = case
    pssm_t, seq_t, la_t, lb_t = _dp_problem(case, cuda)
    monkeypatch.setenv("LARA_DP_RESIDENT", "1")
    fits = gotoh_plan.resident_warps(la_max, lb_max,
                                     gotoh_cuda.smem_optin(cuda)) > 0
    assert fits == ((la_max, lb_max) != (600, 600))
    plan = gotoh_cuda.plan_for(la_max, lb_max, cuda)
    assert plan.variant == (gotoh_plan.RESIDENT if fits
                            else gotoh_plan.STREAM)

    before = dict(_build.launches)
    tb_k = gotoh_cuda.align_pssm_batch(pssm_t, la_t, lb_t, GO, GE, la_max,
                                       lb_max, seq_t, emit_lines=True)
    moved = {name: _build.launches[name] - before[name]
             for name in before}
    want_moved = {"gotoh_resident": 1} if fits else {"gotoh_dp": 1,
                                                     "gotoh_tb": 1}
    assert {k: v for k, v in moved.items() if v} == want_moved
    dirs_p, finals_p = gotoh.dp_forward(pssm_t, la_t, lb_t, GO, GE)
    tb_p = gotoh.dp_traceback(dirs_p, finals_p, la_t, lb_t, GO, GE, seq_t)
    tb_p = tb_p._replace(lines=gotoh.compact_lines(
        tb_p.partner, tb_p.n_lines, min(la_max, lb_max)))
    torch.cuda.synchronize()
    for field, got, want in zip(gotoh.Traceback._fields, tb_k, tb_p):
        _int_equal(got, want, field)
    if fits:
        direct = gotoh_cuda.align_resident(pssm_t, la_t, lb_t, GO, GE, seq_t)
        for field, got, want in zip(gotoh.Traceback._fields[:5], direct,
                                    tb_p):
            _int_equal(got, want, field)
    else:
        with pytest.raises(ValueError, match="does not fit"):
            gotoh_cuda.align_resident(pssm_t, la_t, lb_t, GO, GE, seq_t)


@pytest.mark.parametrize("matching", [5, 0])
@pytest.mark.parametrize("switch,kernels", [
    (None, {"gotoh_dp", "gotoh_tb"}),
    ("LARA_DP_GRID", {"gotoh_grid_dp", "gotoh_grid_tb"}),
    ("LARA_DP_RESIDENT", {"gotoh_resident"}),
])
def test_paths_on_card_match_cpu(switch, kernels, matching, cuda,
                                 monkeypatch, tmp_path):
    """The fused path (-m 5) and the hybrid (-m 0) under each DP variant
    give on the card what they give on the CPU, and launch the variant's
    kernels (K3 on the fused path only) and K4 once for the one chunk.
    The three records' structures conflict, so the pairs iterate."""
    from lara_tpu_torch.app import enumerate_pairs
    from lara_tpu_torch.io.records import InputStorage
    from lara_tpu_torch.params import Parameters
    from lara_tpu_torch.solver import device_driver

    for key in ("LARA_DP_GRID", "LARA_DP_RESIDENT", "LARA_SOLVER"):
        monkeypatch.delenv(key, raising=False)
    if switch:
        monkeypatch.setenv(switch, "1")
    path = tmp_path / "conflict.dbn"
    path.write_text(
        ">x\nGGGAAAGGGAAACCCAAACCC\n(((...(((...)))...)))\n"
        ">y\nGGGAAAGGGAAACCCAAACCC\n(((...)))...(((...)))\n"
        ">z\nGGGAAAGGGAAACCCAAACC\n((....((....))....))\n")
    records = InputStorage(in_file=str(path))
    pairs = enumerate_pairs(records)
    params = Parameters(in_file=str(path), num_iterations=60,
                        matching=matching)

    def solve(dev):
        return sorted((r.seq_indices, r.columns, r.score, r.best_upper,
                       r.best_lower, r.iterations)
                      for r in device_driver.solve_all(records, pairs,
                                                       params, [dev]))

    _build.reset_launches()
    on_card = solve(cuda)
    launched = {k for k, n in _build.launches.items() if n}
    kernels = kernels | {"edge_sweep", "edge_pack"}
    if matching:
        # the fused path: its dispatches replay graphs behind the loop exit
        kernels = kernels | {"matching_rounds", "loop_exit"} | ITERATION
    assert launched == kernels
    assert _build.launches["edge_sweep"] == _build.launches["edge_pack"] == 1
    assert max(r[-1] for r in on_card) > 1
    assert on_card == solve(torch.device("cpu"))


def _matching_case(b, width, slots, seed):
    """Queue-ordered columns with exact weight ties among dead columns."""
    rng = np.random.default_rng(seed)
    n_edges = 4096
    cols = {name: np.zeros((b, width), np.int32) for name in ("l", "m", "w")}
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
        at = np.sort(rng.choice(width, len(order), replace=False))
        for c, (l, m, w) in zip(at, order):
            cols["l"][k, c], cols["m"][k, c], cols["w"][k, c] = l, m, w
            live[k, c] = True
    return cols["l"], cols["m"], cols["w"], live, line


@pytest.mark.parametrize("width", [64, 300])
@pytest.mark.parametrize("lookahead", [1, 2, 5, 8])
def test_matching_kernel_matches_plain(width, lookahead, cuda):
    args = [torch.from_numpy(x).to(cuda)
            for x in _matching_case(12, width, 24, width + lookahead)]
    before = _build.launches["matching_rounds"]
    got = matching_device.greedy_matching_queue(*args, lookahead)
    assert _build.launches["matching_rounds"] == before + 1
    want = matching_device.rounds_loop(*args, lookahead)
    _int_equal(got.score, want.score, "score")
    _int_equal(got.used_slot, want.used_slot, "used_slot")


def _any_ids_case(b, width, slots, seed):
    """Columns with arbitrary ids (INT32_MIN, the kernel's empty mark, and
    negative ids among them) and ties on every weight; lane 0 has no live
    column and lane 1 none that conflict (where the batch has them)."""
    rng = np.random.default_rng(seed)
    ids = np.array([-2 ** 31, -7, 0, 5, 2 ** 31 - 1, 1 << 20, 3, 4, 9],
                   np.int32)
    lq = ids[rng.integers(0, len(ids), (b, width))]
    mq = ids[rng.integers(0, len(ids), (b, width))]
    wq = (rng.integers(-3, 4, (b, width)) * 2).astype(np.int32)
    live = rng.random((b, width)) < 0.6
    line = ids[rng.integers(0, len(ids), (b, slots))]
    if b > 1:
        live[0] = False
        lq[1] = np.arange(width, dtype=np.int32) * 2
        mq[1] = lq[1] + 1
        live[1] = True
    return lq, mq, wq, live, line


def _hold_k3(args, lookahead):
    """K3 against the plain version; one launch per call."""
    before = _build.launches["matching_rounds"]
    got = matching_device.greedy_matching_queue(*args, lookahead)
    assert _build.launches["matching_rounds"] == before + 1
    want = matching_device.rounds_loop(*args, lookahead)
    _int_equal(got.score, want.score, "score")
    _int_equal(got.used_slot, want.used_slot, "used_slot")
    return want


# W=1 and widths that are not a multiple of 32; W=2049 streams through the
# ring of 2048 columns
@pytest.mark.parametrize("b,width,slots", [(1, 1, 4), (1, 45, 16), (3, 33, 7),
                                           (9, 100, 30), (4, 2049, 64)])
@pytest.mark.parametrize("lookahead", range(1, 9))
def test_matching_kernel_shapes(b, width, slots, lookahead, cuda):
    args = [torch.from_numpy(x).to(cuda)
            for x in _any_ids_case(b, width, slots, width * 8 + lookahead)]
    _hold_k3(args, lookahead)


def test_matching_kernel_empty_batch_launches_nothing(cuda):
    args = [torch.from_numpy(x).to(cuda)
            for x in _any_ids_case(0, 64, 8, 1)]
    before = _build.launches["matching_rounds"]
    got = matching_cuda.rounds_loop_cuda(*args, 5)
    assert _build.launches["matching_rounds"] == before
    assert got.score.shape == (0,) and got.used_slot.shape == (0, 8)


def test_matching_kernel_dead_and_conflict_free_lanes(cuda):
    """Lanes with no live column score 0 and use no slot; when no two
    columns share an endpoint, every live column is kept."""
    b, width = 6, 300
    lq = np.arange(b * width, dtype=np.int32).reshape(b, width) * 2
    mq = lq + 1
    wq = np.full((b, width), 4, np.int32)
    live = np.ones((b, width), bool)
    live[::2] = False
    line = np.concatenate([lq[:, :50], mq[:, -50:]], axis=1)
    args = [torch.from_numpy(x).to(cuda) for x in (lq, mq, wq, live, line)]
    for lookahead in (1, 5, 8):
        want = _hold_k3(args, lookahead)
        assert want.score.tolist() == [0, 4 * width] * 3
        assert want.used_slot[1::2].all() and not want.used_slot[::2].any()


@pytest.mark.parametrize("lookahead", [3, 5])
def test_matching_kernel_tie_rule(lookahead, cuda):
    """Eliminating slot 1 costs exactly slot 0's weight, so the memo does
    not explore L (tests/test_torch_matching.py::test_k3_model_tie_rule)."""
    case = ([[0, 0, 20]], [[10, 20, 30]], [[4, 4, -2]], [[True] * 3],
            [[0, 10, 20, 30, 99]])
    args = [torch.tensor(x, dtype=torch.bool if k == 3 else torch.int32,
                         device=cuda) for k, x in enumerate(case)]
    assert int(_hold_k3(args, lookahead).score[0]) == 2


def test_matching_kernel_wide_queue(cuda):
    """W=40000: the ring streams the row 1024 columns at a time and the
    set of kept endpoints lives in the wrapper's global scratch."""
    kp = matching_cuda.plan(40000)
    assert kp.ring == 2048 and not kp.table_in_smem
    args = [torch.from_numpy(x).to(cuda)
            for x in _matching_case(3, 40000, 64, 40)]
    for lookahead in (2, 5):
        _hold_k3(args, lookahead)


def test_matching_kernel_on_solver_inputs(cuda):
    """K3 on the solver's own queues: the first four calls of a 16S-shape
    chunk (three pairs of 1530 nt, 1536 line slots)."""
    from lara_tpu_torch.app import enumerate_pairs
    from lara_tpu_torch.params import Parameters
    from lara_tpu_torch.solver import device_driver, device_solver
    from lara_tpu_torch.workloads import make_long_family

    records = make_long_family(n=3, length=1530, seed=47)
    params = Parameters(in_file="<test>")
    pad = device_driver._pad_dim(max(len(r.sequence) for r in records))
    models, _ = device_driver._filter_and_build(
        records, enumerate_pairs(records), params, pad, pad, cuda)
    batch, scan_steps = device_driver._pack_models(models, params, pad, pad,
                                                   cuda)
    b, d = batch.dual_l.shape
    carry = device_solver._init_carry(
        b, d, pad, np.float32(params.step_size_factor),
        int(params.num_iterations), cuda)
    calls = []
    real = device_solver.greedy_matching_queue

    def spy(*args):
        calls.append([a.clone() if torch.is_tensor(a) else a for a in args])
        return real(*args)

    device_solver.greedy_matching_queue = spy
    try:
        # the eager loop: a graph's replays call no wrapper
        device_solver._eager_dispatch(
            batch, carry, int(params.gap_open_int),
            int(params.gap_extend_int), pad, pad, 4,
            int(params.max_nondecr_iterations), int(params.matching),
            scan_steps)
    finally:
        device_solver.greedy_matching_queue = real
    assert len(calls) == 4 and calls[0][0].shape == (b, d // 2)
    assert any(bool(c[3].any()) for c in calls)
    for args in calls:
        _hold_k3(args[:5], args[5])


def test_wrappers_reject_bad_inputs(cuda):
    pssm = torch.zeros((2, 8, 8), dtype=torch.int32, device=cuda)
    la64 = torch.ones(2, dtype=torch.int64, device=cuda)
    la = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="la"):
        gotoh_cuda.dp_forward(pssm, la64, la, GO, GE)
    with pytest.raises(ValueError, match="pssm"):
        gotoh_cuda.dp_forward(pssm.transpose(1, 2), la, la, GO, GE)
    cols = torch.zeros((2, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="live"):
        matching_cuda.rounds_loop_cuda(cols, cols, cols, cols, cols, 5)
    submat = torch.zeros((5, 5), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="seq_a"):
        gotoh_cuda.edge_filter_active_words(
            cols.long(), cols, la, la, submat, GO, GE, 0, 4, 4)
    with pytest.raises(ValueError, match="submat"):
        gotoh_cuda.edge_filter_active_words(
            cols, cols, la, la, submat[:4], GO, GE, 0, 4, 4)
    with pytest.raises(ValueError, match="seq_b"):
        gotoh_cuda.edge_filter_active_words(
            cols, cols, la, la, submat, GO, GE, 0, 4, 5)


def test_dp_kernels_at_16s_bucket(cuda):
    """K1 + K2 at the 16S bucket, B=2 1536 x 1536: K1 runs 49 strips on
    four CTAs per pair (13 warps and about 180 KB of opt-in shared memory
    each), and K2 walks up to 3072 steps per pair through about 100
    windows."""
    case = (2, 1536, 1536, 17)
    _b, la_max, lb_max, _seed = case
    pssm_t, seq_t, la_t, lb_t = _dp_problem(case, cuda)
    before = dict(_build.launches)
    dirs_k, finals_k = gotoh_cuda.dp_forward(pssm_t, la_t, lb_t, GO, GE)
    tb_k = gotoh_cuda.dp_traceback(dirs_k, finals_k, la_t, lb_t, GO, GE, seq_t)
    assert _build.launches["gotoh_dp"] == before["gotoh_dp"] + 1
    assert _build.launches["gotoh_tb"] == before["gotoh_tb"] + 1
    dirs_p, finals_p = gotoh.dp_forward(pssm_t, la_t, lb_t, GO, GE)
    tb_p = gotoh.dp_traceback(dirs_p, finals_p, la_t, lb_t, GO, GE, seq_t)
    torch.cuda.synchronize()
    _int_equal(finals_k, finals_p, "finals")
    valid = _valid_cells(la_t, lb_t, la_max, lb_max, cuda)
    _int_equal(torch.where(valid, dirs_k, 0), torch.where(valid, dirs_p, 0),
               "dirs")
    for field, got, want in zip(gotoh.Traceback._fields, tb_k, tb_p):
        _int_equal(got, want, field)


def _edge_problem(b, la_max, lb_max, seed, dev):
    """Rna5 residues (padded with 4, as the driver pads) in ragged lanes,
    one of them full size, and the default parameters' filter constants."""
    from lara_tpu_torch.params import Parameters
    from lara_tpu_torch.types import f2i

    rng = np.random.default_rng(seed)
    la = rng.integers(1, la_max + 1, b).astype(np.int32)
    lb = rng.integers(1, lb_max + 1, b).astype(np.int32)
    la[0], lb[0] = la_max, lb_max
    if b > 2:
        la[1], lb[2] = 1, 1
    seq_a = np.full((b, la_max), 4, np.int32)
    seq_b = np.full((b, lb_max), 4, np.int32)
    for k in range(b):
        seq_a[k, :la[k]] = rng.integers(0, 4, la[k])
        seq_b[k, :lb[k]] = rng.integers(0, 4, lb[k])
    params = Parameters(in_file="<test>")
    submat = np.asarray(params.score_matrix, np.int32)
    inputs = tuple(torch.from_numpy(x).to(dev)
                   for x in (seq_a, seq_b, la, lb, submat))
    return inputs, (int(params.gap_open_int), int(params.gap_extend_int),
                    int(f2i(params.suboptimal_diff)))


# (batch, la_max, lb_max, seed): the tRNA chunk, a ragged non-square batch
# (la_max not a multiple of 32; lb_max % 32 and la_max * lb_max % 32 not 0,
# so words straddle rows and the last has padding), one 1x1 lane, one 16S
# lane, the ~300 nt and 16S chunks, and rows shorter than a word
EDGE_CASES = [(128, 96, 96, 41), (40, 333, 700, 43), (1, 1, 1, 45),
              (1, 1536, 1536, 47), (32, 320, 320, 42), (32, 1536, 1536, 46),
              (5, 45, 23, 48)]


@pytest.mark.parametrize("case", EDGE_CASES)
def test_edge_filter_kernels_match_plain(case, cuda):
    """K4 against its plain versions, exactly: the sweep's prefixes on the
    cells inside both halves' rectangles and its finals, the pack's
    row-major words on the sweep's own output, and the wrapper's words
    against the plain filter (two scans), at the default subopt and at 0;
    one launch of each."""
    b, la_max, lb_max, seed = case
    inputs, (go, ge, subopt) = _edge_problem(b, la_max, lb_max, seed, cuda)
    before = dict(_build.launches)
    prefix_k, finals_k = gotoh_cuda.edge_sweep(*inputs, go, ge)
    words_k = gotoh_cuda.edge_pack(prefix_k, finals_k, *inputs, subopt)
    moved = {name: _build.launches[name] - before[name] for name in before}
    assert moved == dict.fromkeys(before, 0) | {"edge_sweep": 1,
                                                "edge_pack": 1}
    prefix_p, finals_p = gotoh.edge_sweep(*inputs, go, ge)
    torch.cuda.synchronize()
    _int_equal(finals_k, finals_p, "finals")
    la2, lb2 = (torch.cat([x, x]) for x in inputs[2:4])
    valid = _valid_cells(la2, lb2, la_max, lb_max, cuda)
    _int_equal(torch.where(valid, prefix_k, 0),
               torch.where(valid, prefix_p, 0), "prefix")
    _int_equal(words_k, gotoh.edge_pack(prefix_k, finals_k, *inputs, subopt),
               "pack")
    assert words_k.shape == (b, -(-la_max * lb_max // 32) + 1)
    for cut in (subopt, 0):
        _int_equal(gotoh_cuda.edge_filter_active_words(
            *inputs, go, ge, cut, la_max, lb_max),
            gotoh.edge_filter_active_words(*inputs, go, ge, cut, la_max,
                                           lb_max), f"words at {cut}")


def _write_family(path, lengths, seed):
    """Point-mutated hairpin families, one per length, as dot-bracket
    records whose structures conflict (the pairs iterate)."""
    rng = np.random.default_rng(seed)
    unit = "GGGCGCAAGCCUUAAGGCGCCC"
    stems = ["(((((((......)))))))..", "((....((....))....))..",
             "((((((....))))..((..))"]
    lines = []
    for length in lengths:
        seq0 = (unit * (length // len(unit) + 1))[:length]
        for k, stem in enumerate(stems * 2):
            seq = list(seq0)
            for _ in range(int(rng.integers(1, 4))):
                seq[int(rng.integers(0, length))] = "ACGU"[rng.integers(0, 4)]
            st = list((stem * (length // len(stem) + 1))[:length])
            stack = []
            for i, c in enumerate(st):
                if c == "(":
                    stack.append(i)
                elif c == ")":
                    stack.pop()
            for i in stack:  # the cut left these unpaired
                st[i] = "."
            st = "".join(st)
            lines.append(f">f{length}_{k}\n{''.join(seq)}\n{st}")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _solve_library(path, dev, **kw):
    from lara_tpu_torch.app import enumerate_pairs
    from lara_tpu_torch.io.records import InputStorage
    from lara_tpu_torch.io.writers import OutputLibrary
    from lara_tpu_torch.params import Parameters
    from lara_tpu_torch.solver import device_driver

    records = InputStorage(in_file=path)
    params = Parameters(in_file=path, **kw)
    lib = OutputLibrary(records, params.out_format)
    for res in device_driver.solve_all(records, enumerate_pairs(records),
                                       params, [dev]):
        lib.add_alignment(res.seq_indices, res.columns, res.score)
    return lib.to_string()


def test_pipeline_on_card_matches_cpu_serial(cuda, monkeypatch, tmp_path):
    """Three length classes (six buckets) through the cross-chunk pipeline
    (LARA_PIPELINE=1) on the card, its solver and download threads on
    their own streams, against the serial CPU run."""
    from lara_tpu_torch.solver import device_driver

    for key in ("LARA_DP_GRID", "LARA_DP_RESIDENT", "LARA_SOLVER",
                "LARA_MAX_BATCH", "LARA_PIPELINE"):
        monkeypatch.delenv(key, raising=False)
    path = _write_family(tmp_path / "mixed.dbn", [22, 60, 90], seed=4)
    serial = _solve_library(path, torch.device("cpu"), num_iterations=60)
    monkeypatch.setenv("LARA_PIPELINE", "1")
    solved = []
    solve_on = device_driver._solve_on

    def spy(stream, prep, params):
        solved.append(stream is not None)
        return solve_on(stream, prep, params)

    monkeypatch.setattr(device_driver, "_solve_on", spy)
    assert _solve_library(path, cuda, num_iterations=60) == serial
    assert len(solved) == 6 and all(solved)


def test_require_refuses_another_current_card(cuda, monkeypatch):
    """A kernel launched for a tensor on one card from a thread whose
    current card is another raises, naming both."""
    pssm = torch.zeros((2, 8, 8), dtype=torch.int32, device=cuda)
    la = torch.ones(2, dtype=torch.int32, device=cuda)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    with pytest.raises(ValueError, match="cuda:0.*cuda:1"):
        gotoh_cuda.dp_forward(pssm, la, la, GO, GE)


def test_sharded_solve_on_one_card_matches_one_device(cuda, tmp_path):
    """The lanes of a batch split over ``[cuda:0, cuda:0]`` (two shards,
    each on its own thread and stream) give every field of the one-device
    solve, with K1, K2 and K3 launched once per iteration that each
    shard's loop exit let run (its longest lane's); the CLI path over two
    shards writes the CPU's bytes."""
    from lara_tpu_torch import app
    from lara_tpu_torch.app import enumerate_pairs
    from lara_tpu_torch.io.records import InputStorage
    from lara_tpu_torch.params import Parameters
    from lara_tpu_torch.parallel import mesh
    from lara_tpu_torch.solver import device_driver, device_solver

    path = _write_family(tmp_path / "family.dbn", [22], seed=5)
    records = InputStorage(in_file=path)
    params = Parameters(in_file=path, num_iterations=60)
    pairs = enumerate_pairs(records)
    models, _ = device_driver._filter_and_build(records, pairs, params, 32,
                                                32, cuda)
    batch, scan_steps = device_driver._pack_models(models, params, 32, 32,
                                                   cuda)
    args = (batch, int(params.gap_open_int), int(params.gap_extend_int),
            np.float32(params.step_size_factor), 32, 32, 60,
            int(params.max_nondecr_iterations), 5)
    one = device_solver.solve_batch(*args, scan_steps=scan_steps)
    _build.reset_launches()
    two = mesh.solve_batch_sharded(*args, [cuda, cuda], scan_steps=scan_steps)
    torch.cuda.synchronize()
    for name, got, want in zip(device_solver.BatchResult._fields, two, one):
        assert got.device == cuda, name
        _int_equal(got, want, name)
    half = batch.la.shape[0] // 2
    iters = one.iterations.cpu().numpy()
    want = sum(int(iters[k:k + half].max()) for k in (0, half))
    _build.settle()
    for name in ("gotoh_dp", "matching_rounds") + tuple(sorted(ITERATION)):
        assert _build.launches[name] == want, name
    cpu_lib = _solve_library(path, torch.device("cpu"), num_iterations=60)
    out = tmp_path / "two.lib"
    app.run(Parameters(in_file=path, num_iterations=60, out_file=str(out)),
            devices=[cuda, cuda])
    assert out.read_text() == cpu_lib


@pytest.mark.parametrize("rows,cols,carry", [(1, 1664, False),
                                             (8, 256, True),
                                             (8, 1664, False),
                                             (32, 256, True)])
@pytest.mark.parametrize("reps", [1, 2, 5])
def test_wavefront_chain_matches_plain(rows, cols, carry, reps, cuda):
    """KB (``csrc/wavefront_chain.cu``) equals its plain version on random
    inputs and near INT32_MAX, where the adds wrap, and launches once."""
    from lara_tpu_torch.benchmark import profile_wavefront_layout as kb

    rng = np.random.default_rng(rows * cols + reps)
    for x in (rng.integers(-1000, 1000, (rows, cols)),
              2**31 - 1 - rng.integers(0, 300, (rows, cols))):
        x_t = torch.from_numpy(x.astype(np.int32)).to(cuda)
        before = _build.launches["wavefront_chain"]
        got = kb.chain(x_t, reps, carry)
        assert _build.launches["wavefront_chain"] == before + 1
        want = kb.chain_plain(x_t, reps, carry)
        torch.cuda.synchronize()
        _int_equal(got, want, "m + h")


@pytest.mark.parametrize("rows,cols", [(1, 48), (33, 64), (9, 1664),
                                       (1, 96)])
def test_wavefront_chain_refuses_what_it_cannot_run(rows, cols, cuda):
    """cols not a multiple of 32, more than 32 rows, more rows than a run
    of 52 allows, and a run it was not built for raise; nothing falls back
    to the plain version."""
    from lara_tpu_torch.benchmark import profile_wavefront_layout as kb

    x = torch.ones((rows, cols), dtype=torch.int32, device=cuda)
    before = _build.launches["wavefront_chain"]
    with pytest.raises(_build.KernelLaunchError):
        kb.chain(x, 1, False)
    assert _build.launches["wavefront_chain"] == before


def test_dispatch_graph_matches_eager_on_card(cuda, tmp_path):
    """``solve_batch_chunk`` on the card (one launch of a graph that loops
    over a captured iteration behind the loop exit) against the eager
    loop: dispatches of 7 and then 5 iterations from the same carry give
    every carry field of the eager ones, with no host sync in the graphed
    dispatches, one capture, K1, K2 and K3 once per iteration the loop
    exit let run, as many as the longest lane ran, the loop exit's kernel
    once per dispatch (KI-tail evaluates the exit after each iteration),
    and KI-tail's ticket 0 after them."""
    from lara_tpu_torch.app import enumerate_pairs
    from lara_tpu_torch.io.records import InputStorage
    from lara_tpu_torch.params import Parameters
    from lara_tpu_torch.solver import (device_driver, device_solver,
                                       dispatch_graph)

    path = _write_family(tmp_path / "family.dbn", [22], seed=6)
    records = InputStorage(in_file=path)
    params = Parameters(in_file=path, num_iterations=60)
    models, _ = device_driver._filter_and_build(
        records, enumerate_pairs(records), params, 32, 32, cuda)
    batch, scan_steps = device_driver._pack_models(models, params, 32, 32,
                                                   cuda)
    b, d = batch.dual_l.shape
    args = (int(params.gap_open_int), int(params.gap_extend_int), 32, 32)
    rest = (int(params.max_nondecr_iterations), 5, scan_steps)

    def two(solve):
        carry = device_solver._init_carry(b, d, 32, np.float32(2.0), 60, cuda)
        first = solve(batch, carry, *args, 7, *rest)
        return first, solve(batch, first, *args, 5, *rest)

    want = two(device_solver._eager_dispatch)
    dispatch_graph.release()
    torch.cuda.synchronize()
    _build.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = two(device_solver.solve_batch_chunk)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        for name, x, y in zip(device_solver._Carry._fields, g, w):
            _int_equal(x, y, name)
    (entry,) = dispatch_graph._entries
    assert not entry.counters[2:].any()
    dispatch_graph.release()
    ran = int(want[1].iterations.max())
    assert 0 < ran <= 12
    assert {k: n for k, n in _build.launches.items() if n} == {
        "gotoh_dp": ran, "gotoh_tb": ran, "matching_rounds": ran,
        **dict.fromkeys(ITERATION, ran),
        "loop_exit": 2}


def test_loop_exit_skips_after_the_last_lane_on_card(cuda):
    """The structure-free tRNA chunk (``make_family(n=4)`` without its
    base-pair edges: 6 pairs, every lane done in its first iteration): a
    graphed dispatch of 125 runs one iteration, the loop exit's kernel
    once (KI-tail ends the loop after the iteration), and gives the eager
    loop's carry; ``solve_batch`` ends after the late dispatch."""
    from lara_tpu_torch.app import enumerate_pairs
    from lara_tpu_torch.params import Parameters
    from lara_tpu_torch.solver import (device_driver, device_solver,
                                       dispatch_graph)
    from lara_tpu_torch.workloads import make_family, without_structure

    records = without_structure(make_family(n=4))
    params = Parameters(in_file="<test>")
    models, _ = device_driver._filter_and_build(
        records, enumerate_pairs(records), params, 96, 96, cuda)
    batch, scan_steps = device_driver._pack_models(models, params, 96, 96,
                                                   cuda)
    b, d = batch.dual_l.shape
    args = (int(params.gap_open_int), int(params.gap_extend_int), 96, 96,
            125, int(params.max_nondecr_iterations), 5, scan_steps)

    def carry0():
        return device_solver._init_carry(
            b, d, 96, np.float32(params.step_size_factor), 500, cuda)

    want = device_solver._eager_dispatch(batch, carry0(), *args)
    dispatch_graph.release()
    _build.reset_launches()
    got = device_solver.solve_batch_chunk(batch, carry0(), *args)
    dispatch_graph.release()
    for name, x, y in zip(device_solver._Carry._fields, got, want):
        _int_equal(x, y, name)
    assert int(got.iterations.max()) == 1
    assert {k: n for k, n in _build.launches.items() if n} == {
        "gotoh_dp": 1, "gotoh_tb": 1, "matching_rounds": 1,
        **dict.fromkeys(ITERATION, 1),
        "loop_exit": 1}
    steps = []
    real = device_solver.solve_batch_chunk

    def spy(model, carry, go, ge, la, lb, max_steps, *rest):
        steps.append(max_steps)
        return real(model, carry, go, ge, la, lb, max_steps, *rest)

    device_solver.solve_batch_chunk = spy
    try:
        res = device_solver.solve_batch(
            batch, args[0], args[1], np.float32(params.step_size_factor),
            96, 96, 500, args[5], 5, scan_steps=scan_steps)
    finally:
        device_solver.solve_batch_chunk = real
    dispatch_graph.release()
    assert steps == [125, 125]
    _int_equal(res.best_upper, want.best_upper, "best_upper")


class _Eager:
    """A graph class that applies nowhere: the hybrid step stays eager."""

    @staticmethod
    def applies(device):
        return False


@pytest.mark.parametrize("switch", [None, "LARA_DP_GRID",
                                    "LARA_DP_RESIDENT"])
def test_hybrid_step_graph_matches_eager_on_card(cuda, monkeypatch, switch):
    """The hybrid's device step captured on the card (after one eager
    turn) and replayed: six turns of sparse updates on four 96x96 lanes,
    with full-plane uploads between some of them, give the eager step's
    downloads and PSSM planes, under each DP plan, with the plan's kernels
    counted once per turn."""
    from lara_tpu_torch.params import Parameters
    from lara_tpu_torch.solver import dispatch_graph, hybrid_driver

    if switch:
        monkeypatch.setenv(switch, "1")
    rng = np.random.default_rng(19)
    lanes, n, cap = 4, 96, hybrid_driver.UPD_CAP
    pssm = rng.integers(-5000, 9000, (lanes, n, n)).astype(np.int32)
    params = Parameters(in_file="<test>")
    turns = []
    for t in range(6):
        counts = rng.integers(0, 60, lanes).astype(np.int32)
        idx = np.zeros((lanes, cap), np.int32)
        val = np.zeros((lanes, cap), np.int32)
        for k in range(lanes):
            idx[k, :counts[k]] = rng.choice(n * n, counts[k], replace=False)
            val[k, :counts[k]] = rng.integers(-3000, 9000, counts[k])
        planes = {int(k): rng.integers(-5000, 9000, (n, n)).astype(np.int32)
                  for k in rng.choice(lanes, t % 2)}
        turns.append((rng.integers(60, n + 1, lanes).astype(np.int32),
                      rng.integers(60, n + 1, lanes).astype(np.int32),
                      idx, val, counts, planes))

    def run(step):
        outs = []
        for las, lbs, idx, val, counts, planes in turns:
            for k, plane in planes.items():
                step.set_plane(k, plane)
            step.upd_idx[:] = idx
            step.upd_val[:] = val
            step.upd_n[:] = counts
            outs.append(step.run(las, lbs))
        return outs

    monkeypatch.setattr(dispatch_graph, "Graph", _Eager)
    eager = hybrid_driver._DeviceStep(pssm.copy(), params, cuda)
    want = run(eager)
    monkeypatch.setattr(dispatch_graph, "Graph", dispatch_graph.CudaGraph)
    step = hybrid_driver._DeviceStep(pssm.copy(), params, cuda)
    _build.reset_launches()
    got = run(step)
    assert step.graph is not None
    launched = {k: v for k, v in _build.launches.items() if v}
    assert launched and set(launched.values()) == {6}, launched
    for t, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"turn {t}")
    _int_equal(step.pssm, eager.pssm, "pssm")
    step.close()


@pytest.mark.parametrize("la_max,lb_max", [(96, 96), (200, 200), (33, 20)])
def test_packed_upload_on_card_matches_cpu(cuda, la_max, lb_max):
    """The packed model (``packed15`` at 96x96, ``packed_seq`` at 200x200,
    a grid off the 32-cell word grid at 33x20) unpacked on the card equals
    its unpack on the CPU, every field, the seq-score grid included."""
    from lara_tpu_torch.solver import device_driver, device_solver

    rng = np.random.default_rng(la_max)

    class Model:
        la, lb = la_max - 3, lb_max - 5
        active = rng.random((la_max - 3, lb_max - 5)) < 0.3
        d = 40
        dual_l = np.sort(rng.choice(la * lb, d)).astype(np.int32)
        dual_m = rng.choice(la * lb, d).astype(np.int32)
        sscore = rng.integers(0, 900, d).astype(np.int32)
        rev = np.arange(d, dtype=np.int32)[::-1].copy()
        qperm = rng.permutation(d).astype(np.int32)
        seq_a = rng.integers(0, 5, la).astype(np.int32)
        seq_b = rng.integers(0, 5, lb).astype(np.int32)
        scale = 1.37

    submat = (np.arange(25, dtype=np.int32).reshape(5, 5) * 37 - 400)
    buf = device_driver._packed_buffer([Model], la_max, lb_max, 512, 2, 5,
                                       pin=True)
    want = device_driver._unpack_model(buf, torch.from_numpy(submat),
                                       la_max, lb_max, 512)
    got = device_driver._unpack_model(buf.to(cuda, non_blocking=True),
                                      torch.from_numpy(submat).to(cuda),
                                      la_max, lb_max, 512)
    for name, g, w in zip(device_solver.BatchModel._fields, got, want):
        assert g.device == cuda and g.is_contiguous(), name
        _int_equal(g.cpu(), w, name)


def test_k1_graph_replays_after_a_smaller_launch(cuda):
    """K1 captured at B=32 320x320 on one CTA per pair (158 KB of shared
    memory) replays after an eager K1 at B=128 96x96 (58 KB) and gives the
    eager codes: the launcher opts the kernel in to its largest shared
    memory once, and no launch lowers it."""
    rng = np.random.default_rng(3)

    def problem(b, n):
        pssm = torch.from_numpy(rng.integers(-9000, 9000, (b, n, n)).astype(
            np.int32)).to(cuda)
        return pssm, torch.full((b,), n, dtype=torch.int32, device=cuda)

    big, big_len = problem(32, 320)
    small, small_len = problem(128, 96)
    want = gotoh_cuda.dp_forward(big, big_len, big_len, GO, GE, cluster=1)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        got = gotoh_cuda.dp_forward(big, big_len, big_len, GO, GE, cluster=1)
        graph.capture_end()
    torch.cuda.current_stream(cuda).wait_stream(side)
    gotoh_cuda.dp_forward(small, small_len, small_len, GO, GE)
    for t in got:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    d_idx = torch.arange(641, device=cuda)[None, :, None]
    i_idx = torch.arange(321, device=cuda)[None, None, :]
    valid = (d_idx >= i_idx) & (d_idx - i_idx <= 320)
    _int_equal(torch.where(valid, got[0], 0), torch.where(valid, want[0], 0),
               "dirs")
    _int_equal(got[1], want[1], "finals")


# (b, la_max, lb_max, d, seed, hub, scan_steps): tiny, ragged with a
# 12-partner run, the tRNA chunk's B=128 D=1024 96x96, a 40-partner run
# under a 2-pass scan, the ~300 nt chunk, and a 16S-sized D=3072 with a
# 60-partner run under 3 passes (KI-head: one CTA per lane at full depth,
# else tiles; KI-lines: one CTA per lane up to D=1024, else a cluster);
# then one lane in 256 tiles of 8 entries (halo 3) under a 30-partner run,
# in a cluster of 4; B=8 D=3072 in 33 tiles a lane (halo 15); B=6 D=3072
# in 24 tiles a lane under 6 passes (halo 63); and one lane of D=8192 at
# full depth, whose keys take the two-buffer scan (four do not fit), in a
# cluster of 8
ITERATION_CASES = [(3, 20, 17, 64, 1, 0, 0), (5, 33, 40, 300, 2, 12, 0),
                   (128, 96, 96, 1024, 3, 0, 0), (4, 96, 96, 1024, 5, 40, 2),
                   (32, 320, 320, 1024, 6, 0, 0),
                   (3, 200, 150, 3072, 7, 60, 3),
                   (1, 64, 64, 2048, 8, 30, 2),
                   (8, 100, 100, 3072, 9, 60, 4),
                   (6, 120, 120, 3072, 11, 60, 6),
                   (1, 60, 60, 8192, 12, 50, 0)]


def _iteration_inputs(case, dev):
    from lara_tpu_torch.solver import device_solver

    b, la_max, lb_max, d, seed, hub, scan_steps = case
    model, carry, partner = iteration_tensors(
        iteration_case(b, la_max, lb_max, d, seed, hub=hub), dev)
    st = device_solver._prepare(model, la_max, lb_max, scan_steps)
    rng = np.random.default_rng(seed + 100)

    def ints(lo, hi, shape=(b,)):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(
            np.int32)).to(dev)

    upper = ints(-9000, 9000)
    upper[::3] = -device_solver.NEG_INF
    tb = gotoh.Traceback(upper=upper, partner=partner,
                         n_lines=ints(0, la_max), gap_score=ints(-900, 0),
                         seq_part=ints(-9000, 9000),
                         lines=gotoh.no_lines(b, dev))
    match = matching_device.RoundsResult(
        score=ints(0, 900), used_slot=torch.from_numpy(
            rng.random((b, la_max)) < 0.5).to(dev))
    return model, carry, st, tb, match


def _tuple_equal(got, want, what):
    for name, g, w in zip(want._fields, got, want):
        _int_equal(g, w, f"{what}.{name}")


@pytest.mark.parametrize("case", ITERATION_CASES)
def test_iteration_kernels_match_plain(case, cuda):
    """KI-head, KI-lines and KI-tail (``csrc/iteration.cu``) against their
    plain versions on the same random ragged batch on the card, every
    output bit for bit, the PSSM grid's start cells included; each kernel
    launched once."""
    from lara_tpu_torch.solver import device_solver, iteration_cuda

    model, c, st, tb, match = _iteration_inputs(case, cuda)
    lb_max = case[2]
    st_plain = st._replace(pssm=st.pssm.clone())
    before = dict(_build.launches)
    head = iteration_cuda.head(model, st, c)
    head_p = device_solver.head_plain(model, st_plain, c)
    _tuple_equal(head, head_p, "head")
    _int_equal(st.pssm, st_plain.pssm, "pssm")
    lines = iteration_cuda.lines(model, st, c, head_p, tb.partner, lb_max)
    lines_p = device_solver.lines_plain(model, st, c, head_p, tb.partner,
                                        lb_max)
    _tuple_equal(lines, lines_p, "lines")
    tail = iteration_cuda.tail(c, head_p.dual_at_queue, tb, lines_p, match, 3)
    tail_p = device_solver.tail_plain(c, head_p.dual_at_queue, tb, lines_p,
                                      match, 3)
    torch.cuda.synchronize()
    _tuple_equal(tail, tail_p, "tail")
    moved = {k: _build.launches[k] - before[k] for k in before}
    assert moved == dict.fromkeys(before, 0) | dict.fromkeys(ITERATION, 1)
    assert bool(lines_p.count.gt(0).any()) and bool(head_p.is_top.any())


@pytest.mark.parametrize("case", [ITERATION_CASES[1], ITERATION_CASES[6],
                                  ITERATION_CASES[8]])
def test_iteration_kernels_update_the_carry_in_place(case, cuda):
    """With the carry's own tensors as outputs, as the dispatch graph runs
    them, KI-head and KI-tail give what they give into new tensors: one
    CTA per lane, and tiles whose halos overlap the next tile's own
    entries."""
    from lara_tpu_torch.solver import device_solver, iteration_cuda

    model, c, st, tb, match = _iteration_inputs(case, cuda)
    head = iteration_cuda.head(model, st, c)
    lines = iteration_cuda.lines(model, st, c, head, tb.partner, case[2])
    want = iteration_cuda.tail(c, head.dual_at_queue, tb, lines, match, 3)
    own = device_solver._Carry(*(t.clone() for t in c))
    head2 = iteration_cuda.head(model, st, own, own.dual_at_queue)
    _tuple_equal(head2, head, "head")
    got = iteration_cuda.tail(own, head2.dual_at_queue, tb, lines, match, 3,
                              out=own)
    torch.cuda.synchronize()
    assert all(g is o for g, o in zip(got, own))
    _tuple_equal(got, want, "carry")


@pytest.mark.parametrize("tile", [1, 7, 15, 31, 100, 3072])
def test_head_tiles_of_any_width_match_plain(tile, cuda):
    """KI-head over tiles fixed narrower than, equal to and wider than the
    halo (15 entries: 4 passes) and over one tile a lane gives the plain
    version's every output and PSSM cell."""
    from lara_tpu_torch.solver import device_solver, iteration_cuda

    model, c, st, _tb, _match = _iteration_inputs(ITERATION_CASES[7], cuda)
    st_plain = st._replace(pssm=st.pssm.clone())
    head = iteration_cuda.head(model, st, c, tile=tile)
    head_p = device_solver.head_plain(model, st_plain, c)
    torch.cuda.synchronize()
    _tuple_equal(head, head_p, "head")
    _int_equal(st.pssm, st_plain.pssm, "pssm")


@pytest.mark.parametrize("cluster", [1, 2, 3, 8])
@pytest.mark.parametrize("case", [ITERATION_CASES[1], ITERATION_CASES[2],
                                  ITERATION_CASES[5]])
def test_lines_clusters_match_plain(case, cluster, cuda):
    """KI-lines in clusters of 1, 2, 3 and 8 CTAs a lane (D, the slots and
    the queue width not multiples of 3 or 8 in the first and last case;
    the tRNA chunk's shape in the second) gives the plain version's every
    output."""
    from lara_tpu_torch.solver import device_solver, iteration_cuda

    model, c, st, tb, _match = _iteration_inputs(case, cuda)
    head = device_solver.head_plain(model, st._replace(pssm=st.pssm.clone()),
                                    c)
    lines = iteration_cuda.lines(model, st, c, head, tb.partner, case[2],
                                 cluster=cluster)
    lines_p = device_solver.lines_plain(model, st, c, head, tb.partner,
                                        case[2])
    torch.cuda.synchronize()
    _tuple_equal(lines, lines_p, "lines")


def test_iteration_tail_keeps_the_reference_order(cuda):
    """KI-tail's dual update on lanes chosen so that the step taken in
    another order, step_factor * ((ub - lb) / count) or (step_factor *
    (ub - lb)) * (1 / count), would move the truncated dual by one: the
    kernel and the plain version on the card give the reference's
    float32 order, a multiply, a divide, a multiply and a subtract.  (An
    FMA of dual - step * sg cannot differ here: sg is -1, 0 or 1, so the
    product is exact.)"""
    from lara_tpu_torch.solver import device_solver, iteration_cuda

    f32 = np.float32
    rng = np.random.default_rng(77)
    n = 500_000
    sf = rng.uniform(0.001, 2.0, n).astype(f32)
    gap = rng.integers(1, 2_000_000, n).astype(np.int32)
    count = 2 * rng.integers(1, 1000, n).astype(np.int32)
    sg = rng.choice(np.array([-1, 1], np.int32), n)
    step = f32(sf * gap.astype(f32)) / count.astype(f32)
    other = np.stack([sf * f32(gap.astype(f32) / count.astype(f32)),
                      f32(sf * gap.astype(f32)) * f32(f32(1) / count)])
    # duals that put dual - step * sg just across an integer
    dual = (np.round(step * sg) + rng.integers(-50, 50, n)).astype(np.int32)

    def moved(s):
        return np.trunc(dual.astype(f32) - s * sg.astype(f32)).astype(
            np.int64)

    want = moved(step)
    pick = np.flatnonzero((moved(other[0]) != want)
                          | (moved(other[1]) != want))[:64]
    assert len(pick) >= 8
    b, d, slots = len(pick), 4, 8
    bl = rng.integers(-5000, 0, b).astype(np.int32)
    carry = device_solver._init_carry(b, d, slots, 1.0, 50, cuda)
    dual_rows = np.zeros((b, d), np.int32)
    dual_rows[:, 1] = dual[pick]
    sg_rows = np.zeros((b, d), np.int32)
    sg_rows[:, 1] = sg[pick]
    carry = carry._replace(
        dual=torch.from_numpy(dual_rows).to(cuda),
        step_factor=torch.from_numpy(sf[pick]).to(cuda),
        best_lower=torch.from_numpy(bl).to(cuda),
        best_upper=torch.from_numpy(bl + gap[pick]).to(cuda),
        best_score=torch.full((b,), 10**6, dtype=torch.int32, device=cuda))

    def lanes(x):
        return torch.from_numpy(np.asarray(x, np.int32)).to(cuda)

    # no bound improves (upper at best_upper, lower below best_lower), so
    # the step is step_factor * gap / count
    tb = gotoh.Traceback(upper=carry.best_upper.clone(),
                         partner=torch.full((b, slots), -1, dtype=torch.int32,
                                            device=cuda),
                         n_lines=lanes(np.zeros(b)),
                         gap_score=lanes(np.zeros(b)),
                         seq_part=carry.best_lower - 10,
                         lines=gotoh.no_lines(b, cuda))
    ln = device_solver._Lines(
        slot_edge=torch.zeros((b, slots), dtype=torch.int32, device=cuda),
        sg=lanes(sg_rows), count=lanes(count[pick]),
        consistent_sum=lanes(np.zeros(b)),
        matched_cons_slot=torch.zeros((b, slots), dtype=torch.bool,
                                      device=cuda),
        cand_q=torch.zeros((b, 2), dtype=torch.bool, device=cuda))
    match = matching_device.RoundsResult(
        score=lanes(np.zeros(b)),
        used_slot=torch.zeros((b, slots), dtype=torch.bool, device=cuda))
    got = iteration_cuda.tail(carry, carry.dual_at_queue, tb, ln, match, 5)
    plain = device_solver.tail_plain(carry, carry.dual_at_queue, tb, ln,
                                     match, 5)
    torch.cuda.synchronize()
    _tuple_equal(got, plain, "carry")
    assert np.array_equal(got.dual[:, 1].cpu().numpy(), want[pick])


# KI-tail alone (b, d, slots): the tRNA, ~300 nt and 16S chunks' shapes, a
# ragged D and odd slots (no 16-byte loads), and lanes longer than four
# entries a thread of a full block (D=8192 and 4100 slots: each thread
# loops)
TAIL_CASES = [(128, 1024, 96), (32, 1024, 320), (32, 3072, 1536),
              (40, 1021, 33), (16, 8192, 4100)]


@pytest.mark.parametrize("in_place", [False, True], ids=["new", "in-place"])
@pytest.mark.parametrize("case", TAIL_CASES)
def test_tail_kernel_matches_plain_on_every_kind_of_lane(case, in_place,
                                                         cuda):
    """KI-tail against ``tail_plain`` on the card, every output bit for
    bit, on lanes inactive, halving, with count 0 and count > 1, and with
    ``best_upper - best_lower`` wrapping (``tail_cases.tail_inputs``, each
    kind present), into new tensors and in place (``out=c``, as the
    dispatch graph runs it); launched once."""
    from lara_tpu_torch.solver import device_solver, iteration_cuda
    from lara_tpu_torch.solver import tail_cases

    b, d, slots = case
    nd = tail_cases.MAX_NONDECR
    c, tb, ln, match = tail_cases.tail_inputs(b, d, slots, 5 + d, cuda)
    want = device_solver.tail_plain(c, c.dual_at_queue, tb, ln, match, nd)
    assert all(tail_cases.lane_kinds(c, ln, want).values())
    out = device_solver._Carry(*(t.clone() for t in c)) if in_place \
        else None
    src = out if in_place else c
    before = _build.launches["iteration_tail"]
    got = iteration_cuda.tail(src, src.dual_at_queue, tb, ln, match, nd,
                              out=out)
    torch.cuda.synchronize()
    assert _build.launches["iteration_tail"] == before + 1
    if in_place:
        assert all(g is o for g, o in zip(got, out))
    _tuple_equal(got, want, "carry")


def _loop_body(b, d, slots, dev, remaining):
    """A loop graph whose body counts its runs and runs KI-tail in place on
    ``tail_cases.tail_inputs`` (``remaining`` iterations left on every
    lane), as the dispatch graph runs the iteration: (graph, counters,
    runs, carry, KI-tail's other inputs)."""
    from lara_tpu_torch.solver import dispatch_graph, iteration_cuda
    from lara_tpu_torch.solver import tail_cases

    c, tb, ln, match = tail_cases.tail_inputs(b, d, slots, 17, dev,
                                              remaining=remaining)
    counters = torch.zeros(4, dtype=torch.int32, device=dev)
    runs = torch.zeros((), dtype=torch.int32, device=dev)
    graph = dispatch_graph.CudaGraph(dev)
    graph.capture(lambda: (runs.add_(1), iteration_cuda.tail(
        c, c.dual_at_queue, tb, ln, match, tail_cases.MAX_NONDECR, out=c)),
        c.lane_active, counters)
    return graph, counters, runs, c, (tb, ln, match)


def _launch(graph, counters, runs, left):
    counters[0].fill_(left)
    counters[1:].zero_()
    runs.zero_()
    graph.replay()
    return (int(runs), int(counters[1]), int(counters[0]),
            int(counters[2:].abs().sum()))


# (lanes active, remaining, iterations left, bodies run)
FOLD_CASES = {"none": ("none", 10**6, 3, 0), "first": ("first", 10**6, 3, 3),
              "last": ("last", 10**6, 3, 3),
              "random": ("random", 10**6, 3, 3), "all": ("all", 10**6, 3, 3),
              "budget": ("all", 10**6, 9, 9),
              "second run": ("all", 2, 5, 2)}


@pytest.mark.parametrize("b,d,slots", [(32, 1024, 96), (40, 1021, 33)])
@pytest.mark.parametrize("case", list(FOLD_CASES))
def test_loop_exit_folded_into_tail(case, b, d, slots, cuda):
    """The WHILE node around a body that ends in KI-tail, with no exit
    kernel in the loop: it runs the body while a lane is active and
    iterations are left, counting each run (none, the first, the last,
    random and every lane active; the budget running out; every lane
    ending on the body's second run), and KI-tail's ticket is 0 after
    the launch."""
    graph, counters, runs, c, _inputs = _loop_body(
        b, d, slots, cuda, FOLD_CASES[case][1])
    which, _remaining, left, want = FOLD_CASES[case]
    mask = {"none": np.zeros(b, bool), "first": np.arange(b) == 0,
            "last": np.arange(b) == b - 1,
            "random": np.random.default_rng(3).random(b) < 0.5,
            "all": np.ones(b, bool)}[which]
    c.lane_active.copy_(torch.from_numpy(mask))
    try:
        assert _launch(graph, counters, runs, left) == (want, want,
                                                        left - want, 0)
    finally:
        graph.close()


def test_tail_outside_the_loop_sets_no_condition(cuda):
    """KI-tail launched eagerly and the capture replayed bare, after a
    loop ran, leave the loop's counters as they were, and the loop then
    runs as before."""
    from lara_tpu_torch.solver import iteration_cuda

    graph, counters, runs, c, (tb, ln, match) = _loop_body(
        32, 1024, 96, cuda, 10**6)
    try:
        c.lane_active.fill_(True)
        assert _launch(graph, counters, runs, 3) == (3, 3, 0, 0)
        graph._graph.instantiate()
        iteration_cuda.tail(c, c.dual_at_queue, tb, ln, match, 5, out=c)
        graph._graph.replay()
        torch.cuda.synchronize()
        assert [int(x) for x in counters] == [0, 3, 0, 0]
        assert int(runs) == 4
        assert _launch(graph, counters, runs, 4) == (4, 4, 0, 0)
    finally:
        graph.close()


def test_loop_graph_needs_one_tail(cuda):
    """A loop graph around a body without KI-tail, or with two, raises (the
    fold finds no one kernel to give the condition) and builds nothing; no
    exit kernel takes KI-tail's place in the loop."""
    from lara_tpu_torch.solver import dispatch_graph, iteration_cuda
    from lara_tpu_torch.solver import tail_cases

    c, tb, ln, match = tail_cases.tail_inputs(4, 64, 8, 3, cuda)
    counters = torch.zeros(4, dtype=torch.int32, device=cuda)
    runs = torch.zeros((), dtype=torch.int32, device=cuda)

    def tail():
        iteration_cuda.tail(c, c.dual_at_queue, tb, ln, match, 5, out=c)

    for body in (lambda: runs.add_(1), lambda: (tail(), tail())):
        graph = dispatch_graph.CudaGraph(cuda)
        with pytest.raises(_build.KernelLaunchError):
            graph.capture(body, c.lane_active, counters)
        assert graph._loop is None
        graph.close()

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
paths (fused, hybrid, lane refill, the cross-chunk pipeline on its CUDA
streams) and ``splice_lanes`` on the card against the CPU.  This
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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda", 0)


def _int_equal(got, want, name):
    assert got.shape == want.shape, name
    assert torch.equal(got.to(torch.int64), want.to(torch.int64)), name


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
        kernels = kernels | {"matching_rounds"}
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
    batch, scan_steps = device_driver._pack_models(models, pad, pad, cuda)
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
        device_solver.solve_batch_chunk(
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
        gotoh_cuda.edge_filter_skewed_words(
            cols.long(), cols, la, la, submat, GO, GE, 0, 4, 4)
    with pytest.raises(ValueError, match="submat"):
        gotoh_cuda.edge_filter_skewed_words(
            cols, cols, la, la, submat[:4], GO, GE, 0, 4, 4)
    with pytest.raises(ValueError, match="seq_b"):
        gotoh_cuda.edge_filter_skewed_words(
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
# (la_max not a multiple of 32), one 1x1 lane, one 16S lane
EDGE_CASES = [(128, 96, 96, 41), (40, 333, 700, 43), (1, 1, 1, 45),
              (1, 1536, 1536, 47)]


@pytest.mark.parametrize("case", EDGE_CASES)
def test_edge_filter_kernels_match_plain(case, cuda):
    """K4 against its plain versions, exactly: the sweep's prefixes on the
    cells inside both halves' rectangles and its finals, the pack on the
    sweep's own output, and the wrapper's words against the plain filter
    (two scans), at the default subopt and at 0; one launch of each."""
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
    for cut in (subopt, 0):
        _int_equal(gotoh_cuda.edge_filter_skewed_words(
            *inputs, go, ge, cut, la_max, lb_max),
            gotoh.edge_filter_skewed_words(*inputs, go, ge, cut, la_max,
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


def test_refill_on_card_matches_cpu(cuda, monkeypatch, tmp_path):
    """Lane refill on the card (15 pairs through 4 lanes, dispatches of 15
    iterations) writes the CPU's bytes and launches K1, K2 and K3, and K4
    once for each window of models the refill filters."""
    from lara_tpu_torch.solver import device_driver

    for key in ("LARA_DP_GRID", "LARA_DP_RESIDENT", "LARA_SOLVER"):
        monkeypatch.delenv(key, raising=False)
    path = _write_family(tmp_path / "family.dbn", [22], seed=3)
    cpu = _solve_library(path, torch.device("cpu"), num_iterations=60)
    monkeypatch.setenv("LARA_REFILL", "1")
    monkeypatch.setenv("LARA_MAX_BATCH", "4")
    monkeypatch.setenv("LARA_CHUNK", "15")
    windows = []
    filter_and_build = device_driver._filter_and_build

    def spy(store, chunk, *args):
        windows.append(len(chunk))
        return filter_and_build(store, chunk, *args)

    monkeypatch.setattr(device_driver, "_filter_and_build", spy)
    _build.reset_launches()
    on_card = _solve_library(path, cuda, num_iterations=60)
    assert {k for k, n in _build.launches.items() if n} == {
        "gotoh_dp", "gotoh_tb", "matching_rounds", "edge_sweep", "edge_pack"}
    assert sum(windows) == 15 and len(windows) > 1
    assert _build.launches["edge_sweep"] == _build.launches["edge_pack"] \
        == len(windows)
    assert device_driver.last_refill.pairs == 15
    assert device_driver.last_refill.dispatches > 1
    assert on_card == cpu


def test_pipeline_on_card_matches_cpu_serial(cuda, monkeypatch, tmp_path):
    """Three length classes (six buckets) through the cross-chunk pipeline
    (LARA_PIPELINE=1) on the card, its solver and download threads on
    their own streams, against the serial CPU run."""
    from lara_tpu_torch.solver import device_driver

    for key in ("LARA_DP_GRID", "LARA_DP_RESIDENT", "LARA_SOLVER",
                "LARA_MAX_BATCH", "LARA_PIPELINE"):
        monkeypatch.delenv(key, raising=False)
    path = _write_family(tmp_path / "mixed.dbn", [22, 60, 90], seed=4)
    monkeypatch.setenv("LARA_NO_PIPELINE", "1")
    serial = _solve_library(path, torch.device("cpu"), num_iterations=60)
    monkeypatch.delenv("LARA_NO_PIPELINE")
    monkeypatch.setenv("LARA_PIPELINE", "1")
    solved = []
    solve_on = device_driver._solve_on

    def spy(stream, prep, params):
        solved.append(stream is not None)
        return solve_on(stream, prep, params)

    monkeypatch.setattr(device_driver, "_solve_on", spy)
    assert _solve_library(path, cuda, num_iterations=60) == serial
    assert len(solved) == 6 and all(solved)


def test_splice_lanes_on_card_matches_cpu(cuda):
    from lara_tpu_torch.solver import device_solver

    rng = np.random.default_rng(8)
    b, ne, d, la_max = 5, 24, 12, 6

    def model(n):
        rev = np.broadcast_to(np.arange(d, dtype=np.int32), (n, d)).copy()
        rev[:, :4] = [1, 0, 3, 2]
        return device_solver.BatchModel(
            seq_score=rng.integers(-9, 9, (n, ne)).astype(np.int32),
            active=rng.random((n, ne)) < 0.5,
            dual_l=rng.integers(0, ne, (n, d)).astype(np.int32),
            dual_m=rng.integers(0, ne, (n, d)).astype(np.int32),
            sscore=rng.integers(0, 9, (n, d)).astype(np.int32), rev=rev,
            dvalid=rng.random((n, d)) < 0.5,
            qrank=rev.copy(), la=np.full(n, 4, np.int32),
            lb=np.full(n, 6, np.int32))

    base, rows = model(b), model(2)
    carry = device_solver._init_carry(b, d, la_max, np.float32(2.0), 50,
                                      torch.device("cpu"))
    carry = carry._replace(dual=torch.from_numpy(
        rng.integers(-9, 9, (b, d)).astype(np.int32)),
        lane_active=torch.from_numpy(rng.random(b) < 0.5))

    def splice(dev):
        out_model, out_carry = device_solver.splice_lanes(
            device_solver.BatchModel(*(torch.from_numpy(a).to(dev)
                                       for a in base)),
            device_solver._Carry(*(t.to(dev) for t in carry)), [4, 1],
            device_solver.BatchModel(*(torch.from_numpy(a).to(dev)
                                       for a in rows)),
            np.float32(1.5), 40)
        return [t.cpu() for t in (*out_model, *out_carry)]

    for got, want in zip(splice(cuda), splice(torch.device("cpu"))):
        assert torch.equal(got, want)


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
    solve, with K1, K2 and K3 launched once per iteration in each shard's
    dispatches; the CLI path over two shards writes the CPU's bytes."""
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
    batch, scan_steps = device_driver._pack_models(models, 32, 32, cuda)
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
    chunk = device_solver.dispatch_size()
    iters = one.iterations.cpu().numpy()
    want = sum(min(60, -(-int(iters[k:k + half].max()) // chunk) * chunk)
               for k in (0, half))
    assert _build.launches["gotoh_dp"] == want
    assert _build.launches["matching_rounds"] == want
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

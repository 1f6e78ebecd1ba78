"""The PyTorch port's CUDA kernels vs. their plain PyTorch versions, on a card.

K1 + K2, K1-grid + K2-grid and K-res (``lara_tpu_torch.ops.gotoh_cuda``)
and K3 (``lara_tpu_torch.solver.matching_cuda``) against the plain versions
on the same CUDA tensors, with zero tolerance (every output is an
integer), K1 + K2 at the 16S bucket's 1536 x 1536 included; the driver's
paths (fused, hybrid, lane refill, the cross-chunk pipeline on its CUDA
streams) and ``splice_lanes`` on the card against the CPU.  This
file imports no JAX, so it runs on a machine that has a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` configures JAX).  Without a card
every test skips.
"""

import numpy as np
import pytest
import torch

from lara_tpu.types import PSSM_INIT
from lara_tpu_torch import _build
from lara_tpu_torch.ops import gotoh, gotoh_cuda, gotoh_plan
from lara_tpu_torch.solver import matching_cuda, matching_device

pytestmark = pytest.mark.cuda

GO, GE = -49152, -16384


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _int_equal(got, want, name):
    assert got.shape == want.shape, name
    assert torch.equal(got.to(torch.int64), want.to(torch.int64)), name


# (batch, la_max, lb_max, seed): tiny, ragged, the tRNA bucket, wider than
# one CTA (1100 offsets > 1024 threads) and beyond 48 KB of shared memory
DP_CASES = [(4, 12, 10, 3), (9, 33, 47, 5), (16, 96, 96, 7), (2, 1100, 40, 9),
            (1, 1400, 16, 13)]


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


@pytest.mark.parametrize("dchunk", [8, 32])
@pytest.mark.parametrize("case", DP_CASES)
def test_grid_kernels_match_plain(case, dchunk, cuda):
    """K1-grid (through ``gotoh_scan``) and K2-grid against the plain scan
    and traceback; one launch of each per block of ``dchunk`` diagonals."""
    b, la_max, lb_max, _seed = case
    pssm_t, seq_t, la_t, lb_t = _dp_problem(case, cuda)
    skewed = gotoh.skew_scores(pssm_t, int(PSSM_INIT))
    blocks = -(-(la_max + lb_max + 1) // dchunk)

    before = dict(_build.launches)
    res_k = gotoh_cuda.gotoh_scan(skewed, la_t, lb_t, GO, GE, dchunk)
    finals_k = torch.stack([res_k.final_m, res_k.final_h, res_k.final_v])
    tb_k = gotoh_cuda.dp_traceback_grid(res_k.aux, finals_k, la_t, lb_t, GO,
                                        GE, seq_t, dchunk)
    assert _build.launches["gotoh_grid_dp"] == \
        before["gotoh_grid_dp"] + blocks
    assert _build.launches["gotoh_grid_tb"] == \
        before["gotoh_grid_tb"] + blocks
    res_p = gotoh.gotoh_scan(skewed, la_t, lb_t, GO, GE, la_max)
    dirs_p, finals_p = gotoh.dp_forward(pssm_t, la_t, lb_t, GO, GE)
    tb_p = gotoh.dp_traceback(dirs_p, finals_p, la_t, lb_t, GO, GE, seq_t)
    torch.cuda.synchronize()

    for got, want, name in zip(res_k[:3], res_p[:3], ("m", "h", "v")):
        _int_equal(got, want, f"final_{name}")
    assert res_k.aux.shape == (blocks * dchunk, b, la_max + 1)
    valid = _valid_cells(la_t, lb_t, la_max, lb_max, cuda).permute(1, 0, 2)
    dirs_k = res_k.aux[:la_max + lb_max + 1]
    _int_equal(torch.where(valid, dirs_k, 0),
               torch.where(valid, res_p.aux.to(torch.int8), 0), "dirs")
    for field, got, want in zip(gotoh.Traceback._fields, tb_k, tb_p):
        _int_equal(got, want, field)


@pytest.mark.parametrize("case", DP_CASES)
def test_resident_plan_and_kernel_match_plain(case, cuda, monkeypatch):
    """Under LARA_DP_RESIDENT=1 the plan takes K-res where the pair fits
    the card's opt-in shared memory and K1 + K2 where it does not (the
    1100 x 40 and 1400 x 16 cases); either way the result, lines included,
    equals the plain version's."""
    b, la_max, lb_max, _seed = case
    pssm_t, seq_t, la_t, lb_t = _dp_problem(case, cuda)
    monkeypatch.setenv("LARA_DP_RESIDENT", "1")
    fits = gotoh_plan.resident_bytes(la_max, lb_max) \
        <= gotoh_cuda.smem_optin(cuda)
    assert fits == (la_max < 1000)
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
    kernels (K3 on the fused path only).  The three records' structures
    conflict, so the pairs iterate."""
    from lara_tpu.app import enumerate_pairs
    from lara_tpu.io.records import InputStorage
    from lara_tpu.params import Parameters
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
                                                       params, dev))

    _build.reset_launches()
    on_card = solve(cuda)
    launched = {k for k, n in _build.launches.items() if n}
    if matching:
        kernels = kernels | {"matching_rounds"}
    assert launched == kernels
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


def test_dp_kernels_at_16s_bucket(cuda):
    """K1 + K2 at the 16S bucket, B=2 1536 x 1536: K1 needs 55 KB of
    opt-in shared memory (nine rows of 1537 int32) and K2 walks up to 3072
    steps per pair."""
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
    from lara_tpu.app import enumerate_pairs
    from lara_tpu.io.records import InputStorage
    from lara_tpu.io.writers import OutputLibrary
    from lara_tpu.params import Parameters
    from lara_tpu_torch.solver import device_driver

    records = InputStorage(in_file=path)
    params = Parameters(in_file=path, **kw)
    lib = OutputLibrary(records, params.out_format)
    for res in device_driver.solve_all(records, enumerate_pairs(records),
                                       params, dev):
        lib.add_alignment(res.seq_indices, res.columns, res.score)
    return lib.to_string()


def test_refill_on_card_matches_cpu(cuda, monkeypatch, tmp_path):
    """Lane refill on the card (15 pairs through 4 lanes, dispatches of 15
    iterations) writes the CPU's bytes and launches K1, K2 and K3."""
    from lara_tpu_torch.solver import device_driver

    for key in ("LARA_DP_GRID", "LARA_DP_RESIDENT", "LARA_SOLVER"):
        monkeypatch.delenv(key, raising=False)
    path = _write_family(tmp_path / "family.dbn", [22], seed=3)
    cpu = _solve_library(path, torch.device("cpu"), num_iterations=60)
    monkeypatch.setenv("LARA_REFILL", "1")
    monkeypatch.setenv("LARA_MAX_BATCH", "4")
    monkeypatch.setenv("LARA_CHUNK", "15")
    _build.reset_launches()
    on_card = _solve_library(path, cuda, num_iterations=60)
    assert {k for k, n in _build.launches.items() if n} == {
        "gotoh_dp", "gotoh_tb", "matching_rounds"}
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

"""The port's DP variants, line compaction, plan and edge filter vs. JAX.

On the CPU every wrapper of ``lara_tpu_torch.ops.gotoh_cuda`` runs its
kernel's plain version, but the plan still routes each call through the
variant's layout (the grid variant skews the scores and walks
``[Dp, B, W]`` codes).  Held here with zero tolerance (every output is an
integer) against the Pallas kernels in interpret mode under the same
``LARA_DP_GRID`` / ``LARA_DP_RESIDENT`` switches, and against the JAX
plan, ``gotoh_scan_pallas`` and ``edge_filter_batch``.
``tests/test_torch_cuda.py`` holds the kernels against the plain versions
on a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lara_tpu.ops import gotoh as jax_gotoh
from lara_tpu.ops.gotoh_pallas import align_pssm_batch_pallas, \
    gotoh_scan_pallas
from lara_tpu.solver.device_solver import _align_dchunk
from lara_tpu.types import f2i
from lara_tpu_torch.ops import gotoh, gotoh_cuda, gotoh_plan
from lara_tpu_torch.params import Parameters

from tests.test_torch_gotoh import CASES, GE, GO, _problem

VARIANTS = {"default": {}, "grid": {"LARA_DP_GRID": "1"},
            "resident": {"LARA_DP_RESIDENT": "1"}}


@pytest.fixture
def variant_env(monkeypatch, request):
    """Set a variant's switches; the Pallas entry point reads them at trace
    time, so its jit cache is cleared on the way in and out."""
    for key in ("LARA_DP_GRID", "LARA_DP_RESIDENT", "LARA_DCHUNK"):
        monkeypatch.delenv(key, raising=False)
    for key, value in VARIANTS[request.param].items():
        monkeypatch.setenv(key, value)
    align_pssm_batch_pallas.clear_cache()
    yield request.param
    align_pssm_batch_pallas.clear_cache()


@pytest.mark.parametrize("variant_env", list(VARIANTS), indirect=True)
@pytest.mark.parametrize("case", CASES)
def test_lines_match_pallas(case, variant_env):
    pssm, la, lb, seq, la_max, lb_max = _problem(case)
    pal = align_pssm_batch_pallas(
        jnp.asarray(pssm), jnp.asarray(la), jnp.asarray(lb), GO, GE, la_max,
        lb_max, block_b=8, interpret=True, emit_lines=True)
    plan = gotoh_cuda.plan_for(la_max, lb_max, torch.device("cpu"))
    assert plan.variant == {"default": gotoh_plan.STREAM,
                            "grid": gotoh_plan.GRID,
                            "resident": gotoh_plan.RESIDENT}[variant_env]
    t = torch.from_numpy
    got = gotoh_cuda.align_pssm_batch(t(pssm), t(la), t(lb), GO, GE, la_max,
                                      lb_max, t(seq), emit_lines=True)
    assert got.lines.shape == (len(la), min(la_max, lb_max), 2)
    for field in ("lines", "upper", "gap_score", "n_lines", "partner"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(pal, field)), field)
    xla = jax_gotoh.align_pssm_batch(jnp.asarray(pssm), jnp.asarray(la),
                                     jnp.asarray(lb), GO, GE, la_max, lb_max)
    np.testing.assert_array_equal(got.lines.numpy(), np.asarray(xla.lines))


@pytest.mark.parametrize("dchunk", [8, 5])
@pytest.mark.parametrize("case", CASES)
def test_gotoh_scan_matches_pallas(case, dchunk):
    """The terminal values equal the XLA scan's.  The TPU kernel captures
    them one-hot in a NEG_INF row and reduces the row with max, so a
    terminal value below NEG_INF (a PSSM_INIT cell at (la, lb)) reads
    NEG_INF there: against it the port's values are compared clamped."""
    pssm, la, lb, _seq, la_max, lb_max = _problem(case)
    skewed = jax_gotoh.skew_scores(jnp.asarray(pssm), jax_gotoh.NEG_INF)
    xla = jax_gotoh.gotoh_scan(skewed, jnp.asarray(la), jnp.asarray(lb), GO,
                               GE, la_max, emit="dirs")
    fm, fh, fv, dirs = gotoh_scan_pallas(skewed, jnp.asarray(la),
                                         jnp.asarray(lb), GO, GE, block_b=8,
                                         dchunk=dchunk, interpret=True)
    got = gotoh_cuda.gotoh_scan(torch.from_numpy(np.array(skewed)),
                                torch.from_numpy(la), torch.from_numpy(lb),
                                GO, GE, dchunk)
    for name, want in zip(("final_m", "final_h", "final_v"), (fm, fh, fv)):
        mine = getattr(got, name).numpy()
        np.testing.assert_array_equal(mine, np.asarray(getattr(xla, name)),
                                      name)
        np.testing.assert_array_equal(np.maximum(mine, jax_gotoh.NEG_INF),
                                      np.asarray(want), name)
    assert got.aux.shape == dirs.shape and got.aux.dtype == torch.int8
    d_got, d_pal = got.aux.numpy(), np.asarray(dirs)
    for k in range(len(la)):
        for d in range(la[k] + lb[k] + 1):
            for i in range(min(d, la[k]) + 1):
                if d - i <= lb[k]:
                    assert d_got[d, k, i] == d_pal[d, k, i], (k, d, i)


@pytest.mark.parametrize("env,want", [
    ({}, gotoh_plan.STREAM),
    ({"LARA_DP_GRID": "1"}, gotoh_plan.GRID),
    ({"LARA_DP_RESIDENT": "1"}, gotoh_plan.RESIDENT),
    ({"LARA_DP_GRID": "1", "LARA_DP_RESIDENT": "1"}, gotoh_plan.GRID),
])
def test_plan_precedence(monkeypatch, env, want):
    for key in ("LARA_DP_GRID", "LARA_DP_RESIDENT"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    plan = gotoh_plan.choose(96, 96, gotoh_plan.H100_SMEM_OPTIN, dchunk=8)
    assert plan == gotoh_plan.Plan(want, 8)


@pytest.mark.parametrize("la_max,lb_max,limit,fits", [
    (96, 96, gotoh_plan.H100_SMEM_OPTIN, True),     # 4 warps, 70,436 bytes
    (320, 320, gotoh_plan.H100_SMEM_OPTIN, True),   # 8 warps, 229,524 bytes
    (384, 384, gotoh_plan.H100_SMEM_OPTIN, True),   # 4 warps, 219,332 bytes
    (448, 448, gotoh_plan.H100_SMEM_OPTIN, False),  # 1 warp: may stall
    (320, 320, 150 * 1024, False),                  # 2 warps: may stall
    (1100, 40, gotoh_plan.H100_SMEM_OPTIN, True),   # 10 warps, 227,740 bytes
])
def test_plan_resident_fit(monkeypatch, la_max, lb_max, limit, fits):
    """K-res fits where K1's strips of the warps that fit beside the codes
    cannot stall: each warp needs K1's rings and a count, the codes
    ``la_max + 1`` rows of an odd number of words past ``(lb_max + 31) // 4``
    from a 16-byte boundary."""
    monkeypatch.delenv("LARA_DP_GRID", raising=False)
    monkeypatch.setenv("LARA_DP_RESIDENT", "1")
    warps = gotoh_plan.resident_warps(la_max, lb_max, limit)
    pitch = gotoh_plan.resident_pitch(lb_max)
    assert pitch % 2 == 1 and 4 * pitch >= lb_max + 32
    for w in range(1, 17):
        head = -(-(w * (32 * 96 + 6 * 88 + 1) + 3) // 4) * 4
        assert gotoh_plan.resident_bytes(la_max, lb_max, w) \
            == 4 * (head + (la_max + 1) * pitch)
    if fits:
        assert gotoh_plan.resident_bytes(la_max, lb_max, warps) <= limit
    plan = gotoh_plan.choose(la_max, lb_max, limit)
    assert plan.variant == (gotoh_plan.RESIDENT if fits
                            else gotoh_plan.STREAM)
    assert (warps > 0) == fits


@pytest.mark.parametrize("override", [None, "16", "3"])
def test_fused_dchunk_matches_jax(monkeypatch, override):
    if override is None:
        monkeypatch.delenv("LARA_DCHUNK", raising=False)
    else:
        monkeypatch.setenv("LARA_DCHUNK", override)
    for shape in [(96, 96), (256, 256), (320, 320), (64, 448), (1536, 1536)]:
        assert gotoh_plan.fused_dchunk(*shape) == _align_dchunk(*shape)
    if override is None:
        assert gotoh_plan.fused_dchunk(256, 256) == 8
        assert gotoh_plan.fused_dchunk(320, 320) == 32


@pytest.mark.parametrize("bad", ["0", "-8"])
def test_fused_dchunk_rejects_non_positive(monkeypatch, bad):
    monkeypatch.setenv("LARA_DCHUNK", bad)
    with pytest.raises(ValueError, match="LARA_DCHUNK"):
        gotoh_plan.fused_dchunk(96, 96)
    with pytest.raises(ValueError, match="LARA_DCHUNK"):
        _align_dchunk(96, 96)


@pytest.mark.parametrize("seed", range(2))
def test_edge_filter_matches_edge_filter_batch(seed):
    """The port's row-major filter, unpacked on the host, against the
    JAX package's dense ``edge_filter_batch`` (the hybrid's model build)."""
    rng = np.random.default_rng(70 + seed)
    params = Parameters(in_file="<test>")
    b, la_max, lb_max = 4, 32, 28
    la = np.array([32, 17, 1, 26], np.int32)
    lb = np.array([28, 28, 9, 1], np.int32)
    seq_a = np.full((b, la_max), 4, np.int32)
    seq_b = np.full((b, lb_max), 4, np.int32)
    for k in range(b):
        seq_a[k, :la[k]] = rng.integers(0, 4, la[k])
        seq_b[k, :lb[k]] = rng.integers(0, 4, lb[k])
    submat = np.asarray(params.score_matrix, np.int32)
    go, ge = int(params.gap_open_int), int(params.gap_extend_int)
    subopt = int(f2i(params.suboptimal_diff))
    want_active, want_opt = jax_gotoh.edge_filter_batch(
        seq_a, seq_b, la, lb, submat, go, ge, subopt, la_max, lb_max)
    t = torch.from_numpy
    packed = gotoh.edge_filter_active_words(
        t(seq_a), t(seq_b), t(la), t(lb), t(submat), go, ge, subopt,
        la_max, lb_max).numpy()
    active, opt = gotoh.unpack_active_words(packed, la_max, lb_max)
    np.testing.assert_array_equal(opt, np.asarray(want_opt))
    for k in range(b):
        np.testing.assert_array_equal(
            active[k, :la[k], :lb[k]],
            np.asarray(want_active)[k, :la[k], :lb[k]], k)
    assert active.any()


def test_compact_lines_orders_and_pads():
    partner = torch.tensor([[-1, 3, -1, 0, 5], [2, -1, -1, -1, -1],
                            [-1, -1, -1, -1, -1]], dtype=torch.int32)
    n_lines = torch.tensor([3, 1, 0], dtype=torch.int32)
    lines = gotoh.compact_lines(partner, n_lines, 4)
    assert lines.dtype == torch.int32
    assert lines.tolist() == [
        [[1, 3], [3, 0], [4, 5], [-1, -1]],
        [[0, 2], [-1, -1], [-1, -1], [-1, -1]],
        [[-1, -1]] * 4]

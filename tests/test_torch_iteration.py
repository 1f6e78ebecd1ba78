"""The fused solver's iteration body as the plain versions of its three
kernels (CPU).

On the card ``device_solver._iteration`` runs KI-head, KI-lines and KI-tail
(``csrc/iteration.cu``) around the DP and K3; on the CPU their plain
versions, ``device_solver.head_plain``, ``lines_plain`` and
``tail_plain``.  These tests hold the plain versions, composed by hand,
against the JAX package's ``solve_batch_chunk``; KI-head's run top against
the JAX package's ``_run_top`` and a window-by-window reference; the
persistent PSSM grid against the ``placed`` construction it replaces, also
after a dispatch graph's entry reloads a new model of its key; and
KI-tail's lane cases against a float32 reference in the reference's
operation order.  Zero tolerance throughout.  ``tests/test_torch_cuda.py``
holds the kernels against these plain versions on a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lara_tpu.solver import device_solver as jax_solver
from lara_tpu_torch import convert
from lara_tpu_torch.ops import gotoh, gotoh_cuda
from lara_tpu_torch.solver import device_solver, dispatch_graph, tail_cases
from lara_tpu_torch.solver.matching_device import RoundsResult, rounds_loop
from lara_tpu_torch.types import INFINITY, PSSM_INIT

from tests.test_torch_cuda import (TAIL_CASES, iteration_case,
                                   iteration_tensors)
from tests.test_torch_dispatch_graph import RecordingGraph
from tests.test_torch_loop_exit import Batch
from tests.test_device_solver import write_family
from tests.test_torch_slice import write_conflicting

from lara_tpu_torch.io.records import InputStorage
from lara_tpu_torch.params import Parameters

CPU = torch.device("cpu")
INF = int(INFINITY)


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for key in ("LARA_CHUNK", "LARA_DP_GRID", "LARA_DP_RESIDENT"):
        monkeypatch.delenv(key, raising=False)
    dispatch_graph.release()
    yield
    dispatch_graph.release()


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    """The converging family (52 iterations) and the conflicting one (to
    its limit of 40), as ``tests/test_torch_loop_exit.py`` packs them."""
    path = write_family(tmp_path_factory.mktemp("family"), n=4, seed=0)
    conflict = write_conflicting(tmp_path_factory.mktemp("conflict"))
    return {
        "converging": Batch(InputStorage(in_file=path),
                            Parameters(in_file=path, num_iterations=100), 32),
        "conflicting": Batch(InputStorage(in_file=conflict),
                             Parameters(in_file=conflict, num_iterations=40),
                             32),
    }


def _composed(bt, carry, steps):
    """``steps`` iterations of KI-head, the DP, KI-lines, K3 and KI-tail's
    plain versions, called one after another."""
    st = device_solver._prepare(bt.tmodel, bt.pad, bt.pad, bt.scan_steps)
    for _ in range(steps):
        head = device_solver.head_plain(bt.tmodel, st, carry)
        tb = gotoh_cuda.align_pssm_batch(st.pssm, bt.tmodel.la, bt.tmodel.lb,
                                         bt.go, bt.ge, bt.pad, bt.pad,
                                         bt.tmodel.seq_score, plan=st.plan)
        lines = device_solver.lines_plain(bt.tmodel, st, carry, head,
                                          tb.partner, bt.pad)
        match = rounds_loop(st.lq, st.mq, st.wq, lines.cand_q,
                            lines.slot_edge, bt.lookahead)
        carry = device_solver.tail_plain(carry, head.dual_at_queue, tb,
                                         lines, match, bt.nondecr)
    return carry


@pytest.mark.parametrize("steps", [1, 7, 20])
@pytest.mark.parametrize("family", ["converging", "conflicting"])
def test_plain_versions_compose_to_the_jax_body(families, family, steps):
    """The three plain versions composed give the carry of ``_iteration``
    (the eager loop) and of the JAX ``solve_batch_chunk``, after 1, 7 and
    20 iterations."""
    bt = families[family]
    got = _composed(bt, bt.carry0(), steps)
    want = bt.jax_chunk(bt.jax_carry0(), steps)
    eager = bt.chunk(bt.carry0(), steps, eager=True)
    fields = device_solver._Carry._fields
    for name, g, w, e in zip(fields, convert.carry_to_numpy(got),
                             convert.carry_to_numpy(want),
                             convert.carry_to_numpy(eager)):
        np.testing.assert_array_equal(g, w, err_msg=name)
        np.testing.assert_array_equal(g, e, err_msg=name)
    assert int(got.iterations.max()) == steps


def _window_top(masked, dual_l, dvalid, steps):
    """The queue top of each valid entry, window by window: the largest
    masked profit over the entries of its run within 2**steps - 1 of it,
    ties to the smallest index (runs are contiguous on the valid
    entries)."""
    b, d = masked.shape
    w = 2 ** steps - 1
    run_p = np.zeros((b, d), np.int64)
    run_idx = np.zeros((b, d), np.int64)
    for k in range(b):
        for i in np.flatnonzero(dvalid[k]):
            best = None
            for j in range(max(0, i - w), min(d, i + w + 1)):
                if not dvalid[k, j] or dual_l[k, j] != dual_l[k, i] or any(
                        dual_l[k, t] != dual_l[k, i]
                        for t in range(min(i, j), max(i, j))):
                    continue
                if best is None or masked[k, j] > masked[k, best]:
                    best = j
            run_p[k, i], run_idx[k, i] = masked[k, best], best
    return run_p, run_idx


# (seed, hub, scan_steps, duals): runs longer than 2**scan_steps (a hub edge
# with 40 partners) at depths 1, 2, 3 and full; tied profits (every dual 0,
# interaction scores from six values); every profit negative
HEAD_CASES = [(11, 40, 1, "random"), (12, 40, 2, "random"),
              (13, 40, 3, "random"), (14, 40, 0, "random"),
              (15, 0, 0, "zero"), (16, 25, 2, "zero"),
              (17, 10, 0, "negative")]


@pytest.mark.parametrize("seed,hub,scan_steps,duals", HEAD_CASES)
def test_plain_head_is_the_run_top(seed, hub, scan_steps, duals):
    """KI-head's plain version: the JAX ``_run_top`` at every entry, the
    window-by-window top at every valid one (also where 2**scan_steps
    does not cover a run), ``is_top`` and ``dual_at_queue``."""
    model, carry, partner = iteration_case(6, 24, 20, 160, seed, hub=hub)
    if duals == "zero":
        carry["dual"][:] = 0
    elif duals == "negative":
        carry["dual"] = (-100 - np.abs(model["sscore"])).astype(np.int32)
    tm, tc, _ = iteration_tensors((model, carry, partner), CPU)
    st = device_solver._prepare(tm, 24, 20, scan_steps)
    head = device_solver.head_plain(tm, st, tc)

    d = tm.dual_l.shape[1]
    steps = len(st.same_masks)
    masked = np.where(model["dvalid"], model["sscore"] + carry["dual"],
                      -INF)
    jax_masks = jax_solver._same_segment_masks(jnp.asarray(model["dual_l"]),
                                               steps)
    want_p, want_idx = jax_solver._run_top(
        jnp.asarray(masked.astype(np.int32)),
        jnp.broadcast_to(jnp.arange(d, dtype=jnp.int32), masked.shape),
        jax_masks, np.int32(-INF), np.int32(d))
    np.testing.assert_array_equal(head.run_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(head.run_idx.numpy(), np.asarray(want_idx))
    win_p, win_idx = _window_top(masked, model["dual_l"], model["dvalid"],
                                 steps)
    valid = model["dvalid"]
    np.testing.assert_array_equal(head.run_p.numpy()[valid], win_p[valid])
    np.testing.assert_array_equal(head.run_idx.numpy()[valid],
                                  win_idx[valid])
    np.testing.assert_array_equal(
        head.is_top.numpy(), valid & (masked == head.run_p.numpy()))
    np.testing.assert_array_equal(
        head.dual_at_queue.numpy(),
        np.where(carry["lane_active"][:, None], carry["dual"],
                 carry["dual_at_queue"]))
    if duals == "negative":
        assert (head.run_p.numpy()[valid] < 0).all()
    if hub and scan_steps:
        # some run is longer than the window: its top is not the run's
        _, run_idx = _window_top(masked, model["dual_l"], valid, 12)
        assert (run_idx[valid] != win_idx[valid]).any()


def _placed_pssm(model, st, run_p, la_max, lb_max):
    """The PSSM of the parent's body: a zero grid with max(run top, 0) of
    each run at its start cell, added to the scores where active."""
    b, ne = model.seq_score.shape
    placed = torch.zeros((b, ne + 1), dtype=torch.int32)
    placed.scatter_(1, st.start_dst, torch.clamp(run_p, min=0))
    return torch.where(model.active, model.seq_score + placed[:, :ne],
                       int(PSSM_INIT)).reshape(b, la_max, lb_max)


@pytest.mark.parametrize("seed,hub", [(21, 0), (22, 30)])
def test_pssm_grid_is_the_placed_construction(seed, hub):
    """After an iteration's KI-head the persistent grid equals the parent's
    ``placed`` construction; a second iteration with other duals rewrites
    every start cell."""
    model, carry, partner = iteration_case(5, 30, 26, 200, seed, hub=hub)
    tm, tc, _ = iteration_tensors((model, carry, partner), CPU)
    st = device_solver._prepare(tm, 30, 26, 0)
    for shift in (0, 37):
        tc = tc._replace(dual=tc.dual + shift)
        head = device_solver.head_plain(tm, st, tc)
        assert torch.equal(st.pssm, _placed_pssm(tm, st, head.run_p, 30, 26))


def test_pssm_grid_follows_spliced_models(monkeypatch):
    """A dispatch graph's entry keeps the grid as an invariant of its
    model: when the next dispatch of its key brings a new model (two lanes
    holding new pairs) and a fresh carry, as the next chunk of a bucket
    does, its KI-head leaves the ``placed`` construction of the new
    model."""
    monkeypatch.setattr(dispatch_graph, "Graph", RecordingGraph)
    heads = []
    real = device_solver.head_plain

    def spy(model, st, c):
        heads.append((st, real(model, st, c)))
        return heads[-1][1]

    monkeypatch.setattr(device_solver, "head_plain", spy)
    case = iteration_case(4, 30, 26, 200, 31, hub=12)
    new_rows = iteration_case(4, 30, 26, 200, 32, hub=5)[0]
    model = iteration_tensors(case, CPU)[0]
    fresh = device_solver._init_carry(4, 200, 30, np.float32(1.0), 50, CPU)
    go, ge = -49152, -16384
    out = device_solver.solve_batch_chunk(model, fresh, go, ge, 30, 26, 3, 5,
                                          5)
    assert out.iterations.max() > 0
    lanes = torch.tensor([0, 2])
    model2 = device_solver.BatchModel(*(
        arr.index_copy(0, lanes, torch.from_numpy(new_rows[f])[lanes])
        for f, arr in zip(device_solver.BatchModel._fields, model)))
    carry2 = device_solver._init_carry(4, 200, 30, np.float32(1.0), 50, CPU)
    device_solver.solve_batch_chunk(model2, carry2, go, ge, 30, 26, 1, 5, 5)
    (entry,) = dispatch_graph._entries
    st, head = heads[-1]
    assert st.pssm is entry.st.pssm
    assert torch.equal(entry.model.seq_score, model2.seq_score)
    assert torch.equal(entry.st.pssm,
                       _placed_pssm(model2, entry.st, head.run_p, 30, 26))


def _wrap(x):
    return ((np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31).astype(
        np.int32)


def _tail_reference(c, dual_at_queue, tb, ln, match, max_nondecr):
    """KI-tail lane by lane in numpy: int32 adds that wrap, and the dual
    update in float32, a multiply, a divide, a multiply and a subtract,
    each rounded, truncated toward zero."""
    c = {k: np.array(v) for k, v in c._asdict().items()}
    out = {k: v.copy() for k, v in c.items()}
    out["dual_at_queue"] = np.array(dual_at_queue)
    f32 = np.float32
    for k in range(len(c["lane_active"])):
        act = bool(c["lane_active"][k])
        cnt = int(ln.count[k])
        any_sg = cnt > 0
        struct = int(match.score[k]) if any_sg else int(ln.consistent_sum[k])
        lower = int(_wrap(int(tb.seq_part[k]) + struct
                          + int(tb.gap_score[k])))
        better = act and lower > c["best_score"][k]
        if better:
            out["best_score"][k] = lower
            out["best_partner"][k] = tb.partner[k].numpy()
            out["best_nlines"][k] = tb.n_lines[k]
            used = match.used_slot[k] if any_sg else ln.matched_cons_slot[k]
            out["best_matched"][k] = (used & (tb.partner[k] >= 0)).numpy()
        up = int(tb.upper[k])
        imp_u = act and up < c["best_upper"][k]
        imp_l = act and lower > c["best_lower"][k]
        bu = up if imp_u else int(c["best_upper"][k])
        bl = lower if imp_l else int(c["best_lower"][k])
        out["best_upper"][k], out["best_lower"][k] = bu, bl
        nd = 0 if (imp_u or imp_l) else int(c["nondecr"][k])
        halve = act and nd >= max_nondecr
        sf = f32(c["step_factor"][k] / f32(2)) if halve \
            else c["step_factor"][k]
        out["step_factor"][k] = sf
        if act:
            out["nondecr"][k] = 0 if halve else nd + 1
        step = f32(f32(sf * f32(_wrap(bu - bl))) / f32(max(cnt, 1)))
        if act:
            sg = ln.sg[k].numpy()
            with np.errstate(invalid="ignore"):  # out of int32: INT32_MIN
                    new = np.trunc(f32(c["dual"][k].astype(f32)
                                   - f32(step * sg.astype(f32)))).astype(
                                       np.int32)
            out["dual"][k] = np.where(sg != 0, new, c["dual"][k])
            out["remaining"][k] = c["remaining"][k] - 1
            out["iterations"][k] = c["iterations"][k] + 1
            done = bu == bl or out["remaining"][k] == 0
            out["lane_active"][k] = not done
    return out


def _tail_inputs(case, seed):
    """(carry, dual_at_queue, traceback, lines, K3 result) of one random
    lane batch: KI-head and KI-lines' plain versions on ``case``, and a
    random alignment and matching result."""
    tm, tc, partner = iteration_tensors(case, CPU)
    b, la_max = partner.shape
    lb_max = tm.seq_score.shape[1] // la_max
    st = device_solver._prepare(tm, la_max, lb_max, 0)
    head = device_solver.head_plain(tm, st, tc)
    lines = device_solver.lines_plain(tm, st, tc, head, partner, lb_max)
    rng = np.random.default_rng(seed)

    def ints(lo, hi, shape=(b,)):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int32))

    tb = gotoh.Traceback(upper=ints(-9000, 9000), partner=partner,
                         n_lines=ints(0, la_max), gap_score=ints(-900, 0),
                         seq_part=ints(-9000, 9000),
                         lines=gotoh.no_lines(b, CPU))
    match = RoundsResult(score=ints(0, 900), used_slot=torch.from_numpy(
        rng.random((b, la_max)) < 0.5))
    return tc, head.dual_at_queue, tb, lines, match


# the crafted KI-tail carries (``tail_cases.tail_inputs``) of the card
# tests and ``chip_smoke.py``: (b, d, slots, seed)
CRAFTED_TAILS = [(b, d, slots, 5 + d) for b, d, slots in TAIL_CASES] + [
    (128, 1024, 96, 90), (32, 1024, 320, 91), (32, 3072, 1536, 92),
    (40, 1021, 33, 93)]


@pytest.mark.parametrize("b,d,slots,seed", CRAFTED_TAILS)
def test_crafted_tail_carry_holds_every_kind_of_lane(b, d, slots, seed):
    """The crafted carries that the card holds KI-tail to hold every kind
    of lane the kernel treats apart (inactive, halving, count 0, count >
    1, wrapping bounds), and on them KI-tail's plain version equals the
    lane-by-lane reference."""
    nd = tail_cases.MAX_NONDECR
    c, tb, ln, match = tail_cases.tail_inputs(b, d, slots, seed, CPU)
    got = device_solver.tail_plain(c, c.dual_at_queue, tb, ln, match, nd)
    kinds = tail_cases.lane_kinds(c, ln, got)
    assert all(kinds.values()), kinds
    want = _tail_reference(c, c.dual_at_queue, tb, ln, match, nd)
    for name in device_solver._Carry._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), want[name],
                                      err_msg=name)


@pytest.mark.parametrize("lane_case", ["count 0", "inactive",
                                       "initial bounds", "random"])
def test_plain_tail_lane_cases(lane_case):
    """KI-tail's plain version against the lane-by-lane reference on a lane
    with ``count == 0`` (the consistent branch's sum, a step over 1),
    inactive lanes (nothing moves), lanes still at the initial bounds
    (best_upper - best_lower wraps to a negative step), and random
    lanes."""
    c, daq, tb, ln, match = _tail_inputs(iteration_case(6, 20, 18, 120, 41),
                                         42)
    if lane_case == "count 0":
        ln = ln._replace(count=torch.zeros_like(ln.count))
    elif lane_case == "inactive":
        c = c._replace(lane_active=torch.zeros_like(c.lane_active))
    elif lane_case == "initial bounds":
        c = c._replace(best_upper=torch.full_like(c.best_upper, INF),
                       best_lower=torch.full_like(c.best_lower, -INF),
                       lane_active=torch.ones_like(c.lane_active))
        tb = tb._replace(upper=torch.full_like(tb.upper, INF),
                         seq_part=torch.full_like(tb.seq_part, -INF))
        ln = ln._replace(count=torch.full_like(ln.count, 6),
                         sg=torch.where(ln.sg == 0, 1, ln.sg))
        match = match._replace(score=torch.zeros_like(match.score))
    got = device_solver.tail_plain(c, daq, tb, ln, match, 3)
    want = _tail_reference(c, daq, tb, ln, match, 3)
    for name in device_solver._Carry._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), want[name],
                                      err_msg=name)
    if lane_case == "inactive":
        for name in device_solver._Carry._fields:
            if name != "dual_at_queue":
                assert torch.equal(getattr(got, name), getattr(c, name)), name
    if lane_case == "initial bounds":
        assert (got.best_upper == INF).all() and (got.best_lower <= -INF).all()
        # the wrapped gap makes a negative step: duals move against sg
        moved = (got.dual - c.dual) * ln.sg
        assert (moved[ln.sg != 0] > 0).any()

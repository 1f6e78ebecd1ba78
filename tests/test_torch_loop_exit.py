"""The loop exit of the port's fused dispatch and its one-dispatch-late
flag read, against the JAX package's ``while_loop`` and ``solve_batch``.

On the card a dispatch is one launch of a graph that runs the captured
iteration while iterations are left and a lane is active (a WHILE node,
``csrc/loop_exit.cu``), and ``device_solver.solve_batch`` reads each
dispatch's any-lane-active flag after the next dispatch is queued.  On the
CPU these tests drive that code with the stand-in graph of
``tests/test_torch_dispatch_graph.py``, which runs that loop, and the
CPU's eager loop.
The same batches go through the JAX package's ``solve_batch_chunk`` and
``solve_batch`` on the CPU: every carry and result field equal, the bodies
executed equal to the ``while_loop``'s trips (zero tolerance throughout).

The JAX loop's trips are not observable from outside its jit; they are the
largest per-lane increase of ``iterations`` over a dispatch, since a trip
runs while some lane is active, every active lane counts it, and lanes only
ever go inactive.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lara_tpu.solver import device_solver as jax_solver
from lara_tpu_torch import _build, convert
from lara_tpu_torch.app import enumerate_pairs
from lara_tpu_torch.io.records import InputStorage
from lara_tpu_torch.params import Parameters
from lara_tpu_torch.solver import device_driver, device_solver, dispatch_graph
from lara_tpu_torch.workloads import make_family, without_structure

from tests.test_device_solver import write_family
from tests.test_torch_dispatch_graph import RecordingGraph, _count_kernels
from tests.test_torch_slice import write_conflicting

CPU = torch.device("cpu")


class Batch:
    """One chunk as ``device_driver`` packs it on the CPU, with the solver
    arguments of ``params``: ``model`` numpy rows (for JAX), ``tmodel`` the
    port's unpacked model."""

    def __init__(self, records, params, pad):
        pairs = enumerate_pairs(records)
        models, _ = device_driver._filter_and_build(records, pairs, params,
                                                    pad, pad, CPU)
        self.dcap = device_driver._chunk_dcap(models)
        n = device_driver._padded_batch(len(models))
        self.model = device_driver._model_rows(models, pad, pad, self.dcap, n)
        self.tmodel, self.scan_steps = device_driver._pack_models(
            models, params, pad, pad, CPU, self.dcap)
        self.pad = pad
        self.go, self.ge = int(params.gap_open_int), int(params.gap_extend_int)
        self.step0 = np.float32(params.step_size_factor)
        self.n_iter = int(params.num_iterations)
        self.nondecr = int(params.max_nondecr_iterations)
        self.lookahead = int(params.matching)

    def jax_model(self):
        return jax_solver.BatchModel(*(jnp.asarray(x) for x in self.model))

    def carry0(self):
        b = self.model.la.shape[0]
        return device_solver._init_carry(b, self.dcap, self.pad, self.step0,
                                         self.n_iter, CPU)

    def jax_carry0(self):
        return jax_solver._init_carry(self.model.la.shape[0], self.dcap,
                                      self.pad, self.step0, self.n_iter)

    def chunk(self, carry, steps, eager=False):
        solve = device_solver._eager_dispatch if eager \
            else device_solver.solve_batch_chunk
        return solve(self.tmodel, carry, self.go, self.ge, self.pad,
                     self.pad, steps, self.nondecr, self.lookahead,
                     self.scan_steps)

    def jax_chunk(self, carry, steps):
        return jax_solver.solve_batch_chunk(
            self.jax_model(), carry, self.go, self.ge, self.pad, self.pad,
            steps, self.nondecr, self.lookahead, self.scan_steps)

    def args(self):
        return (self.go, self.ge, self.step0, self.pad, self.pad,
                self.n_iter, self.nondecr, self.lookahead)


@pytest.fixture(scope="module")
def structure_free():
    """The bench's tRNA family (``make_family(n=16)``, 120 pairs, one 96x96
    chunk of 128 lanes) with every record's base-pair edges removed: no
    dual entry, every lane done in its first iteration."""
    return Batch(without_structure(make_family(n=16)),
                 Parameters(in_file="<structure-free>"), 96)


@pytest.fixture(scope="module")
def converging(tmp_path_factory):
    """``write_family(n=4, seed=0)`` through at most 100 iterations: six
    pairs (eight lanes), the longest done after 52."""
    path = write_family(tmp_path_factory.mktemp("family"), n=4, seed=0)
    return Batch(InputStorage(in_file=path),
                 Parameters(in_file=path, num_iterations=100), 32)


@pytest.fixture(scope="module")
def conflicting(tmp_path_factory):
    """Three records whose structures conflict: one of their three pairs
    runs to the limit of 40 iterations."""
    path = write_conflicting(tmp_path_factory.mktemp("conflict"))
    return Batch(InputStorage(in_file=path),
                 Parameters(in_file=path, num_iterations=40), 32)


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    monkeypatch.delenv("LARA_CHUNK", raising=False)
    for key in ("LARA_DP_GRID", "LARA_DP_RESIDENT"):
        monkeypatch.delenv(key, raising=False)
    dispatch_graph.release()
    yield
    dispatch_graph.release()


@pytest.fixture
def graph(monkeypatch):
    monkeypatch.setattr(dispatch_graph, "Graph", RecordingGraph)
    monkeypatch.setattr(RecordingGraph, "captures", 0)
    return RecordingGraph


def _assert_equal(got, want, fields):
    for field, g, w in zip(fields, got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=field)


def _trips(before, after) -> int:
    """Iterations a dispatch ran: the largest per-lane increase from
    ``before`` (a copy of the lanes' iterations: JAX takes the carry)."""
    return int((np.asarray(after.iterations) - before).max())


def test_structure_free_dispatch_matches_jax_trips(structure_free, graph):
    """One dispatch of 125 on the structure-free chunk: the graph's carry
    equals the JAX ``solve_batch_chunk``'s and the eager loop's, and its
    one replay runs the iteration once, as the ``while_loop`` makes one
    trip."""
    sf = structure_free
    want = sf.jax_chunk(sf.jax_carry0(), 125)
    trips = _trips(0, want)
    assert trips == 1
    got = sf.chunk(sf.carry0(), 125)
    fields = device_solver._Carry._fields
    _assert_equal(convert.carry_to_numpy(got), convert.carry_to_numpy(want),
                  fields)
    _assert_equal(convert.carry_to_numpy(got),
                  convert.carry_to_numpy(sf.chunk(sf.carry0(), 125,
                                                  eager=True)), fields)
    (entry,) = dispatch_graph._entries
    assert entry.graph.replays == 1
    assert entry.graph.executed == int(entry.counters[1]) == trips
    assert int(entry.counters[0]) == 125 - trips
    assert not entry.counters[2:].any()


def test_bodies_per_dispatch_follow_the_jax_trips(converging, graph,
                                                  monkeypatch):
    """Dispatches of 7 through the converging chunk's 52 iterations: after
    each one the graph's carry equals the JAX carry, its executed bodies
    equal that dispatch's ``while_loop`` trips (7 seven times, then 3 and
    0), and K1, K2 and K3 are counted once per executed body, the loop
    exit's kernel once per dispatch (the body's KI-tail evaluates the exit
    after each body)."""
    cv = converging
    _count_kernels(monkeypatch)
    _build.reset_launches()
    carry, jax_carry = cv.carry0(), cv.jax_carry0()
    executed, per_dispatch = 0, []
    for _ in range(9):
        before = np.asarray(jax_carry.iterations).copy()
        jax_next = cv.jax_chunk(jax_carry, 7)
        carry = cv.chunk(carry, 7)
        _assert_equal(convert.carry_to_numpy(carry),
                      convert.carry_to_numpy(jax_next),
                      device_solver._Carry._fields)
        (entry,) = dispatch_graph._entries
        per_dispatch.append(entry.graph.executed - executed)
        assert per_dispatch[-1] == _trips(before, jax_next)
        executed, jax_carry = entry.graph.executed, jax_next
    assert per_dispatch == [7] * 7 + [3, 0]
    assert entry.graph.replays == 9
    dispatch_graph.release()
    assert {k: n for k, n in _build.launches.items() if n} == {
        "gotoh_dp": 52, "gotoh_tb": 52, "matching_rounds": 52,
        "loop_exit": 9}
    assert not entry.counters[2:].any()


def _spied_dispatches(monkeypatch, module):
    steps = []
    real = module.solve_batch_chunk

    def spy(model, carry, go, ge, la, lb, max_steps, *rest, **kw):
        steps.append(max_steps)
        return real(model, carry, go, ge, la, lb, max_steps, *rest, **kw)

    monkeypatch.setattr(module, "solve_batch_chunk", spy)
    return steps


@pytest.mark.parametrize("family,chunk,dispatches", [
    ("structure_free", None, 2),
    ("converging", "7", 9),
    ("conflicting", "7", 6),
])
@pytest.mark.parametrize("graphed", [True, False], ids=["graph", "eager"])
def test_solve_batch_dispatches_as_jax(request, monkeypatch, family, chunk,
                                       dispatches, graphed):
    """``solve_batch`` issues the JAX ``solve_batch``'s dispatches, the one
    after the last lane finished included (it reads each flag one
    dispatch late), and gives its results: the structure-free chunk in
    two dispatches of 125; in dispatches of 7 (``LARA_CHUNK``, which both
    read) the converging chunk in 9, its 52 iterations and one more, and
    the conflicting one in 6, to its limit of 40 with none after."""
    batch = request.getfixturevalue(family)
    if chunk:
        monkeypatch.setenv("LARA_CHUNK", chunk)
    if graphed:
        monkeypatch.setattr(dispatch_graph, "Graph", RecordingGraph)
    jax_steps = _spied_dispatches(monkeypatch, jax_solver)
    want = jax_solver.solve_batch(batch.jax_model(), *batch.args(),
                                  scan_steps=batch.scan_steps)
    steps = _spied_dispatches(monkeypatch, device_solver)
    got = device_solver.solve_batch(batch.tmodel, *batch.args(),
                                    scan_steps=batch.scan_steps)
    _assert_equal([t.numpy() for t in got], [np.asarray(x) for x in want],
                  device_solver.BatchResult._fields)
    assert steps == jax_steps
    ran = int(got.iterations.max())
    # the dispatch in which the last lane finished, and one more, within
    # the limit
    size = int(chunk or 125)
    assert len(steps) == dispatches == min(-(-ran // size) + 1,
                                           -(-batch.n_iter // size))
    if graphed:
        (entry,) = dispatch_graph._entries
        assert entry.graph.executed == ran
        assert entry.graph.replays == len(steps)

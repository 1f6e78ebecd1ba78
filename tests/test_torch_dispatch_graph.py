"""The port's dispatch graph (``lara_tpu_torch.solver.dispatch_graph``).

On the card ``solve_batch_chunk`` captures one solver iteration as a CUDA
graph, once per static configuration, and replays it once per iteration.
On the CPU these tests run that code with the CUDA graph object alone
replaced: :class:`RecordingGraph` records the captured callable without
running it and runs it on each replay.  A replay
is the card's loop: while iterations are left and the captured predicate,
``lane_active.any()``, holds, it runs the body, counting it as the loop
exit does on the card (``csrc/loop_exit.cu``: its kernel before the first
run, the body's KI-tail after each).  The key, the
cache, the warm-up on scratch copies, the copy-in of model and carry, the
iteration budget, the copy-out and the launch bookkeeping are the card's
code.  The same numpy batch
(``__graft_entry__._example_batch``) goes through the JAX package's
``solve_batch_chunk``, the port's eager loop and the graph; every carry
field must be equal (zero tolerance).

On a card, ``tests/test_torch_cuda.py`` holds the real graph against the
eager loop, and ``python3 chip_smoke.py`` does the same at the bench's
chunks.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from __graft_entry__ import _example_batch
from lara_tpu.solver import device_solver as jax_solver
from lara_tpu_torch import _build, convert
from lara_tpu_torch.app import enumerate_pairs
from lara_tpu_torch.io.records import InputStorage
from lara_tpu_torch.io.writers import OutputLibrary
from lara_tpu_torch.params import Parameters
from lara_tpu_torch.solver import device_driver, device_solver, dispatch_graph

from tests.test_device_solver import write_family

CPU = torch.device("cpu")
LA_MAX = LB_MAX = 32
STEP0 = np.float32(1.0)
KNOBS = ("LARA_DP_GRID", "LARA_DP_RESIDENT", "LARA_DCHUNK", "LARA_SOLVER",
         "LARA_REFILL", "LARA_NO_REFILL", "LARA_PIPELINE", "LARA_NO_PIPELINE",
         "LARA_SPLIT_SINGLE", "LARA_MAX_BATCH", "LARA_CHUNK")


class RecordingGraph:
    """Stand-in for :class:`dispatch_graph.CudaGraph`: ``capture`` records
    the callable and its predicate without running them; ``replay`` runs
    the callable once, or with a predicate, as the card's loop does, while
    iterations are left (``counters[0]``) and the predicate holds, counting
    each run in ``counters[1]``.  The loop exit's kernel counts once per
    replay, as ``CudaGraph.replay`` counts it (the body's KI-tail evaluates
    the exit after each run); the ticket, ``counters[2:]``, is zero around
    each replay."""

    captures = 0
    closed = 0

    @staticmethod
    def applies(device):
        return True

    def __init__(self, device):
        self.fn = self.active = self.counters = None
        self.replays = 0
        self.executed = 0

    def use(self):
        return contextlib.nullcontext()

    def capture(self, fn, active=None, counters=None):
        type(self).captures += 1
        if active is not None:
            assert counters.dtype == torch.int32 and counters.numel() == 4
        self.fn, self.active, self.counters = fn, active, counters

    def _go(self):
        left, ran, *ticket = self.counters
        assert not any(ticket)
        if int(left) <= 0 or not bool(self.active.any()):
            return False
        left -= 1
        ran += 1
        return True

    def replay(self):
        if self.active is not None:
            _build.count("loop_exit")  # as CudaGraph.replay counts it
        self._loop()

    def _loop(self):
        self.replays += 1
        if self.active is None:
            self.fn()
            return
        while self._go():
            self.executed += 1
            self.fn()

    def close(self):
        type(self).closed += 1


class FailingGraph(RecordingGraph):
    def capture(self, fn, active=None, counters=None):
        raise RuntimeError("capture refused")


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for key in KNOBS:
        monkeypatch.delenv(key, raising=False)
    dispatch_graph.release()
    yield
    dispatch_graph.release()


@pytest.fixture
def graph(monkeypatch):
    monkeypatch.setattr(dispatch_graph, "Graph", RecordingGraph)
    monkeypatch.setattr(RecordingGraph, "captures", 0)
    monkeypatch.setattr(RecordingGraph, "closed", 0)
    return RecordingGraph


@pytest.fixture(scope="module")
def batch():
    return _example_batch()


def _carry0(b, d):
    return device_solver._init_carry(b, d, LA_MAX, STEP0, 20, CPU)


def _chunk(model, carry, steps, go, ge, max_nondecr=5, lookahead=5,
           scan_steps=0, eager=False, la_max=LA_MAX, lb_max=LB_MAX):
    solve = device_solver._eager_dispatch if eager \
        else device_solver.solve_batch_chunk
    return solve(model, carry, go, ge, la_max, lb_max, steps, max_nondecr,
                 lookahead, scan_steps)


def _assert_carry_equal(got, want):
    for field, g, w in zip(device_solver._Carry._fields,
                           convert.carry_to_numpy(got),
                           convert.carry_to_numpy(want)):
        np.testing.assert_array_equal(g, w, err_msg=field)


@pytest.mark.parametrize("steps", [1, 7, 20])
def test_graph_carry_matches_jax_and_eager(batch, graph, steps):
    """One dispatch of 1, 7 and 20 iterations: a warm-up on scratch
    copies, a capture, then one replay, which runs the iterations the
    predicate lets through."""
    model, go, ge = batch
    b, d = model.dual_l.shape
    want = jax_solver.solve_batch_chunk(
        jax_solver.BatchModel(*(jnp.asarray(x) for x in model)),
        jax_solver._init_carry(b, d, LA_MAX, STEP0, 20), go, ge, LA_MAX,
        LB_MAX, steps, 5, 5)
    tmodel = convert.model_to_torch(model, CPU)
    got = _chunk(tmodel, _carry0(b, d), steps, go, ge)
    _assert_carry_equal(got, want)
    _assert_carry_equal(got, _chunk(tmodel, _carry0(b, d), steps, go, ge,
                                    eager=True))
    assert graph.captures == 1
    (entry,) = dispatch_graph._entries
    assert entry.graph.replays == 1
    assert entry.graph.executed == int(got.iterations.max())
    # the carry that comes back is the caller's, not the entry's
    assert all(o.data_ptr() != s.data_ptr()
               for o, s in zip(got, entry.carry))


def test_graph_resumes_across_dispatches(batch, graph):
    """Dispatches of 4 and 3 iterations equal one of 7: the second reuses
    the graph (no capture, a second replay) and the carry the first
    returned."""
    model, go, ge = batch
    b, d = model.dual_l.shape
    tmodel = convert.model_to_torch(model, CPU)
    once = _chunk(tmodel, _carry0(b, d), 7, go, ge, eager=True)
    first = _chunk(tmodel, _carry0(b, d), 4, go, ge)
    twice = _chunk(tmodel, first, 3, go, ge)
    _assert_carry_equal(twice, once)
    (entry,) = dispatch_graph._entries
    assert graph.captures == 1 and entry.graph.replays == 2
    # a dispatch from another carry on the same model reloads the carry
    again = _chunk(tmodel, _carry0(b, d), 7, go, ge)
    _assert_carry_equal(again, once)
    # an in-place change to the returned carry is seen and copied in
    back = _chunk(tmodel, _carry0(b, d), 4, go, ge)
    back.dual.add_(3)
    want = _chunk(tmodel, back, 3, go, ge, eager=True)
    _assert_carry_equal(_chunk(tmodel, back, 3, go, ge), want)
    assert graph.captures == 1


def test_graph_refill_matches_eager(batch, graph):
    """Two dispatches around ``splice_lanes`` (lanes 3 and 1 take the
    pairs of lanes 0 and 2) equal the eager refill: the second dispatch
    copies the spliced model, its invariants and the carry into the graph's
    buffers, and nothing is captured again."""
    model, go, ge = batch
    b, d = model.dual_l.shape
    tmodel = convert.model_to_torch(model, CPU)
    rows = device_solver.BatchModel(*(t[[0, 2]].clone() for t in tmodel))

    def refill(eager):
        carry = _chunk(tmodel, _carry0(b, d), 5, go, ge, eager=eager)
        spliced, carry = device_solver.splice_lanes(tmodel, carry, [3, 1],
                                                    rows, STEP0, 20)
        return _chunk(spliced, carry, 6, go, ge, eager=eager)

    _assert_carry_equal(refill(False), refill(True))
    (entry,) = dispatch_graph._entries
    assert graph.captures == 1 and entry.graph.replays == 2
    assert torch.equal(entry.model.la,
                       torch.from_numpy(model.la)[[0, 2, 2, 0]])


def _variant(batch, field):
    """(model, go, ge, keyword arguments of _chunk) with the key field
    ``field`` changed from the base batch's."""
    model, go, ge = batch
    kw = {}
    if field == "b":
        model = _example_batch(batch=3)[0]
    elif field == "d":
        model = _example_batch(dcap=128)[0]
    elif field in ("la_max", "ne"):
        model = _example_batch(la_max=40)[0]
        kw["la_max"] = 40
    elif field == "lb_max":
        model = _example_batch(lb_max=36)[0]
        kw["lb_max"] = 36
    elif field == "go":
        go -= 1024
    elif field == "ge":
        ge -= 1024
    elif field in ("max_nondecr", "lookahead", "scan_steps"):
        kw[field] = 3
    return model, go, ge, kw


@pytest.mark.parametrize("field", [f for f in dispatch_graph.Key._fields
                                   if f != "device"])
def test_key_field_change_misses_cache(batch, graph, monkeypatch, field):
    """The same key hits the cache; a change to any one key field misses
    it (and drops the old key's idle entry), and the new key's graph gives
    the eager loop's carry."""
    model, go, ge = batch
    b, d = model.dual_l.shape
    base = convert.model_to_torch(model, CPU)
    _chunk(base, _carry0(b, d), 3, go, ge)
    _chunk(base, _carry0(b, d), 3, go, ge)
    assert graph.captures == 1
    key = dispatch_graph.key_of(base, go, ge, LA_MAX, LB_MAX, 5, 5, 0)
    if field == "plan":
        monkeypatch.setenv("LARA_DP_GRID", "1")
        kw, vmodel, vgo, vge = {}, base, go, ge
    else:
        vmodel, vgo, vge, kw = _variant(batch, field)
        vmodel = convert.model_to_torch(vmodel, CPU)
    vb, vd = vmodel.dual_l.shape
    la_max = kw.get("la_max", LA_MAX)
    vkey = dispatch_graph.key_of(
        vmodel, vgo, vge, la_max, kw.get("lb_max", LB_MAX),
        kw.get("max_nondecr", 5), kw.get("lookahead", 5),
        kw.get("scan_steps", 0))
    # NE is LA x LB: the two change together
    grid = {"la_max", "ne"} if field in ("la_max", "ne") else \
        {"lb_max", "ne"} if field == "lb_max" else {field}
    assert {f for f in key._fields
            if getattr(key, f) != getattr(vkey, f)} == grid

    def carry():
        return device_solver._init_carry(vb, vd, la_max, STEP0, 20, CPU)

    got = _chunk(vmodel, carry(), 4, vgo, vge, **kw)
    assert graph.captures == 2 and graph.closed == 1
    assert [e.key for e in dispatch_graph._entries] == [vkey]
    _assert_carry_equal(got, _chunk(vmodel, carry(), 4, vgo, vge, eager=True,
                                    **kw))


def test_key_names_the_device(batch):
    model, go, ge = batch
    tmodel = convert.model_to_torch(model, CPU)
    key = dispatch_graph.key_of(tmodel, go, ge, LA_MAX, LB_MAX, 5, 5, 0)
    assert key.device == CPU
    assert key._replace(device=torch.device("cuda", 0)) != key


def _count_kernels(monkeypatch):
    """Make the CPU's plain DP and matching count a launch of K1, K2 and
    K3 each, as their kernels' wrappers do on the card."""
    align, match = (device_solver.gotoh_cuda.align_pssm_batch,
                    device_solver.greedy_matching_queue)

    def counted_align(*args, **kw):
        _build.count("gotoh_dp")
        _build.count("gotoh_tb")
        return align(*args, **kw)

    def counted_match(*args):
        _build.count("matching_rounds")
        return match(*args)

    monkeypatch.setattr(device_solver.gotoh_cuda, "align_pssm_batch",
                        counted_align)
    monkeypatch.setattr(device_solver, "greedy_matching_queue", counted_match)


def test_launch_counts_are_iterations_times_kernels(batch, graph,
                                                    monkeypatch):
    """``_build.launches`` after dispatches of 7 and 5 iterations: K1, K2
    and K3 once per executed iteration, as many as the longest lane ran
    (the batch converges in its first: 1 of the 12 dispatched), and the
    loop exit's kernel once per dispatch."""
    model, go, ge = batch
    b, d = model.dual_l.shape
    tmodel = convert.model_to_torch(model, CPU)
    _count_kernels(monkeypatch)
    _build.reset_launches()
    out = _chunk(tmodel, _chunk(tmodel, _carry0(b, d), 7, go, ge), 5, go, ge)
    ran = int(out.iterations.max())
    (entry,) = dispatch_graph._entries
    assert ran == entry.graph.executed == 1 and entry.graph.replays == 2
    assert not entry.counters[2:].any()
    # the loop exit's kernel: once per dispatch (KI-tail after each
    # iteration)
    assert {k: n for k, n in _build.launches.items() if n} == {
        "gotoh_dp": ran, "gotoh_tb": ran, "matching_rounds": ran,
        "loop_exit": 2}


def test_every_dispatch_rearms_the_ticket(batch, graph):
    """A ticket left non-zero (``counters[2:]``) does not reach the next
    dispatch: the host zeroes it with the bodies run before each launch,
    so the loop still runs (the stand-in's loop refuses a non-zero
    ticket, as the card's loop would never end on one)."""
    model, go, ge = batch
    b, d = model.dual_l.shape
    tmodel = convert.model_to_torch(model, CPU)
    out = _chunk(tmodel, _carry0(b, d), 7, go, ge)
    (entry,) = dispatch_graph._entries
    entry.counters[2:] = torch.tensor([5, 1], dtype=torch.int32)
    fresh = _chunk(tmodel, _carry0(b, d), 7, go, ge)
    assert entry.graph.replays == 2 and entry.graph.executed == 2
    assert int(entry.counters[1]) == int(fresh.iterations.max()) == 1
    for name, x, y in zip(device_solver._Carry._fields, fresh, out):
        assert torch.equal(x, y), name


class CardCountGraph(RecordingGraph):
    """Counts as on the card: the capture runs the callable's Python once
    (on the card it enqueues nothing; here it computes, so this stand-in's
    carries are not compared, and its predicate is put back as it was),
    and a replay runs no wrapper's count."""

    def capture(self, fn, active=None, counters=None):
        super().capture(fn, active, counters)
        before = active.clone()
        fn()
        active.copy_(before)

    def replay(self):
        _build.count("loop_exit")
        with _build.recording():
            self._loop()


def test_capture_launches_are_added_per_replay(batch, monkeypatch):
    """The card's bookkeeping: the capture's launches are taken out of
    ``launches`` and added once per iteration the loop exit let run (the
    count on the card, settled by ``release``), so the count is again the
    executed iterations times the kernels per iteration; the loop exit's
    kernel counts once per dispatch (KI-tail evaluates the exit in the
    loop)."""
    model, go, ge = batch
    b, d = model.dual_l.shape
    monkeypatch.setattr(dispatch_graph, "Graph", CardCountGraph)
    _count_kernels(monkeypatch)
    _build.reset_launches()
    tmodel = convert.model_to_torch(model, CPU)
    _chunk(tmodel, _chunk(tmodel, _carry0(b, d), 7, go, ge), 5, go, ge)
    (entry,) = dispatch_graph._entries
    assert entry.per_body == {"gotoh_dp": 1, "gotoh_tb": 1,
                              "matching_rounds": 1}
    assert entry.graph.replays == 2 and entry.graph.executed == 1
    dispatch_graph.release()
    assert {k: n for k, n in _build.launches.items() if n} == {
        "gotoh_dp": 1, "gotoh_tb": 1, "matching_rounds": 1, "loop_exit": 2}


def test_recording_is_per_thread():
    """Inside ``recording`` this thread's counts go to the record; another
    thread's still go to ``launches``; ``add`` adds a record n times."""
    import threading

    _build.reset_launches()
    with _build.recording() as record:
        _build.count("gotoh_dp")
        other = threading.Thread(target=_build.count, args=("gotoh_tb",))
        other.start()
        other.join()
    assert record == {"gotoh_dp": 1}
    assert _build.launches["gotoh_dp"] == 0
    assert _build.launches["gotoh_tb"] == 1
    _build.add(record, 4)
    assert _build.launches["gotoh_dp"] == 4


def test_capture_failure_raises(batch, monkeypatch):
    """A graph that fails at capture makes ``solve_batch_chunk`` raise: no
    eager result comes back, and the broken entry is dropped."""
    model, go, ge = batch
    b, d = model.dual_l.shape
    monkeypatch.setattr(dispatch_graph, "Graph", FailingGraph)
    with pytest.raises(RuntimeError, match="capture refused"):
        _chunk(convert.model_to_torch(model, CPU), _carry0(b, d), 7, go, ge)
    assert len(dispatch_graph._entries) == 0


def test_zero_steps_return_the_carry(batch, graph):
    model, go, ge = batch
    b, d = model.dual_l.shape
    carry = _carry0(b, d)
    assert _chunk(convert.model_to_torch(model, CPU), carry, 0, go,
                  ge) is carry
    assert graph.captures == 0


def test_new_key_drops_idle_entries_of_old_key(batch, graph):
    """A dispatch of a new key drops the idle entries of the other keys on
    its card (their graphs closed): ``device_driver`` solves each bucket
    once, so no later chunk reuses them.  Idle entries of the same key stay (a
    second shard's), and so do busy entries and entries on another card;
    ``release`` drops every idle one."""
    model, go, ge = batch
    b, d = model.dual_l.shape
    tmodel = convert.model_to_torch(model, CPU)
    carry = _carry0(b, d)
    old = dispatch_graph.key_of(tmodel, go, ge, LA_MAX, LB_MAX, 5, 5, 0)
    shards = [dispatch_graph._acquire(old, tmodel, carry) for _ in range(2)]
    busy = dispatch_graph._acquire(old._replace(lookahead=3), tmodel, carry)
    elsewhere = dispatch_graph._acquire(
        old._replace(device=torch.device("cuda", 0)), tmodel, carry)
    for entry in shards + [elsewhere]:
        dispatch_graph._give_back(entry, True)
    _chunk(tmodel, carry, 2, go, ge)
    assert graph.captures == 1 and graph.closed == 0
    assert len(dispatch_graph._entries) == 4
    _chunk(tmodel, carry, 2, go - 1024, ge)
    assert graph.captures == 2 and graph.closed == 2
    assert dispatch_graph._entries[:2] == [busy, elsewhere]
    assert dispatch_graph._entries[2].key == old._replace(go=go - 1024)
    dispatch_graph._give_back(busy, True)
    dispatch_graph.release()
    assert len(dispatch_graph._entries) == 0 and graph.closed == 5


def _library(path, devices, **kw):
    params = Parameters(in_file=str(path), **kw)
    store = InputStorage(in_file=str(path))
    lib = OutputLibrary(store, params.out_format)
    for res in device_driver.solve_all(store, enumerate_pairs(store), params,
                                       devices):
        lib.add_alignment(res.seq_indices, res.columns, res.score)
    return lib.to_string()


@pytest.mark.parametrize("env,n_dev", [
    ({}, 1),
    ({"LARA_REFILL": "1", "LARA_MAX_BATCH": "3", "LARA_CHUNK": "7"}, 1),
    ({"LARA_SPLIT_SINGLE": "1", "LARA_PIPELINE": "1"}, 1),
    ({}, 2),
    ({"LARA_DP_GRID": "1"}, 1),
    ({"LARA_DP_RESIDENT": "1"}, 1),
], ids=["default", "refill", "split-pipelined", "two-shards", "grid",
        "resident"])
def test_driver_paths_run_graphs(tmp_path, monkeypatch, env, n_dev):
    """Every fused path of ``device_driver`` (chunks, lane refill, the split
    pipelined through the solver thread, shards on threads, the grid and
    resident DP plans) solves through the graph and writes the eager
    loop's bytes; its graphs are gone when the solve ends."""
    path = write_family(tmp_path, n=5, seed=7)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    eager = _library(path, [CPU] * n_dev, num_iterations=40)
    monkeypatch.setattr(dispatch_graph, "Graph", RecordingGraph)
    monkeypatch.setattr(RecordingGraph, "captures", 0)
    dispatches = []
    real = dispatch_graph.run

    def spy(model, carry, key, steps):
        dispatches.append(key)
        return real(model, carry, key, steps)

    monkeypatch.setattr(dispatch_graph, "run", spy)
    assert _library(path, [CPU] * n_dev, num_iterations=40) == eager
    assert dispatches and RecordingGraph.captures >= 1
    if env.get("LARA_DP_GRID"):
        assert {k.plan.variant for k in dispatches} == {"grid"}
    if env.get("LARA_DP_RESIDENT"):
        assert {k.plan.variant for k in dispatches} == {"resident"}
    assert len(dispatch_graph._entries) == 0

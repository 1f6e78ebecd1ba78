"""The hybrid backend's device step as a graph, on the CPU.

On the card ``hybrid_driver._DeviceStep`` captures its step (the upload of
the pinned rows, the sparse PSSM updates, the DP with lines, the pack and
the download) once per bucket, after one eager turn, and replays it once
per turn.  Here the stand-in graph of ``tests/test_torch_dispatch_graph.py``
records the captured step and runs it on each replay: the graphed step must
equal the eager one turn by turn, across full-plane uploads and under each
DP plan, and a whole hybrid solve through the graph must equal the JAX
hybrid (zero tolerance).  ``tests/test_torch_cuda.py`` holds the real graph
against the eager step on a card.
"""

import numpy as np
import pytest
import torch

from lara_tpu.app import enumerate_pairs
from lara_tpu.params import Parameters
from lara_tpu.solver import hybrid_driver as jax_hybrid
from lara_tpu_torch import app
from lara_tpu_torch.solver import device_driver, dispatch_graph, hybrid_driver
from lara_tpu_torch.types import PSSM_INIT

from tests.test_hybrid import make_family
from tests.test_torch_dispatch_graph import RecordingGraph
from tests.test_torch_standalone import jax_native_or_skip, port_params

CPU = torch.device("cpu")
UPD_CAP = hybrid_driver.UPD_CAP


@pytest.fixture
def graph(monkeypatch):
    for key in ("LARA_DP_GRID", "LARA_DP_RESIDENT"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(dispatch_graph, "Graph", RecordingGraph)
    monkeypatch.setattr(RecordingGraph, "captures", 0)
    monkeypatch.setattr(RecordingGraph, "closed", 0)
    return RecordingGraph


def _turns(rng, lanes, la_max, lb_max, n_turns):
    """Per turn: lane lengths, sparse updates (indices, values, counts) and
    the lanes whose whole plane goes up before it."""
    turns = []
    for t in range(n_turns):
        las = rng.integers(1, la_max + 1, lanes).astype(np.int32)
        lbs = rng.integers(1, lb_max + 1, lanes).astype(np.int32)
        counts = rng.integers(0, 40, lanes).astype(np.int32)
        idx = np.zeros((lanes, UPD_CAP), np.int32)
        val = np.zeros((lanes, UPD_CAP), np.int32)
        for k in range(lanes):
            n = int(counts[k])
            idx[k, :n] = rng.choice(la_max * lb_max, n, replace=False)
            val[k, :n] = rng.integers(-3000, 9000, n)
        planes = {int(k): rng.integers(-5000, 9000, (la_max, lb_max))
                  .astype(np.int32) for k in rng.choice(lanes, t % 2)}
        turns.append((las, lbs, idx, val, counts, planes))
    return turns


def _run(step, turns):
    outs = []
    for las, lbs, idx, val, counts, planes in turns:
        for k, plane in planes.items():
            step.set_plane(k, plane)
        step.upd_idx[:] = idx
        step.upd_val[:] = val
        step.upd_n[:] = counts
        outs.append(step.run(las, lbs))
    return outs


@pytest.mark.parametrize("switch", [None, "LARA_DP_GRID", "LARA_DP_RESIDENT"],
                         ids=["k1-k2", "grid", "resident"])
def test_graphed_step_equals_eager_turn_by_turn(graph, monkeypatch, switch):
    """Six turns on four 32x32 lanes, with full-plane uploads before some
    of them: the graphed step (one eager turn, a capture, five replays)
    gives the eager step's download every turn, and the same PSSM planes;
    the graph goes with the step."""
    if switch:
        monkeypatch.setenv(switch, "1")
    rng = np.random.default_rng(17)
    lanes, la_max, lb_max = 4, 32, 32
    pssm = rng.integers(-5000, 9000, (lanes, la_max, lb_max)).astype(np.int32)
    params = port_params(Parameters(in_file="<test>"))
    turns = _turns(rng, lanes, la_max, lb_max, 6)

    monkeypatch.setattr(dispatch_graph, "Graph", dispatch_graph.CudaGraph)
    eager = hybrid_driver._DeviceStep(pssm.copy(), params, CPU)
    want = _run(eager, turns)
    assert eager.graph is None

    monkeypatch.setattr(dispatch_graph, "Graph", graph)
    hybrid_driver.replays = 0
    step = hybrid_driver._DeviceStep(pssm.copy(), params, CPU)
    got = _run(step, turns)
    assert graph.captures == 1 and step.graph.replays == 5
    assert hybrid_driver.replays == 5
    for t, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"turn {t}")
    assert torch.equal(step.pssm, eager.pssm)
    step.close()
    assert step.graph is None and graph.closed == 1


def test_replay_reads_the_rows_of_its_turn(graph):
    """The captured step reads ``host_in`` when it replays: rows written
    after the capture reach the PSSM, and the downloaded result is a copy
    that the next replay does not overwrite."""
    params = port_params(Parameters(in_file="<test>"))
    pssm = np.full((2, 32, 32), int(PSSM_INIT), np.int32)
    pssm[:, :8, :8] = 100
    step = hybrid_driver._DeviceStep(pssm, params, CPU)
    lens = np.full(2, 8, np.int32)
    first = step.run(lens, lens)
    step.upd_idx[0, 0], step.upd_val[0, 0], step.upd_n[0] = 0, 5000, 1
    second = step.run(lens, lens)
    assert int(step.pssm[0]) == 5000 and int(step.pssm[32 * 32]) == 100
    assert second[0, 0] == first[0, 0] + 4900
    step.upd_n[0] = 0
    third = step.run(lens, lens)
    np.testing.assert_array_equal(third, second)
    assert second[0, 0] != first[0, 0]


@pytest.mark.parametrize("kwargs", [
    dict(num_iterations=60, matching=0),
    dict(num_iterations=60, matching=12),
])
def test_graphed_hybrid_matches_jax_hybrid(graph, kwargs):
    """A whole hybrid solve with every device step after the first a
    replay: every pair's columns, score, bounds and iterations equal the
    JAX hybrid's, one capture per bucket, and every turn but the first of
    each bucket a replay."""
    jax_native_or_skip()
    records = make_family()
    params = Parameters(in_file="<test>", **kwargs)
    pairs = enumerate_pairs(records)
    want = {r.seq_indices: r for r in jax_hybrid.solve_all(records, pairs,
                                                            params)}
    hybrid_driver.turns = hybrid_driver.replays = 0
    got = {r.seq_indices: r for r in hybrid_driver.solve_all(
        records, app.enumerate_pairs(records), port_params(params), CPU)}
    assert got.keys() == want.keys()
    for key, res in want.items():
        mine = got[key]
        assert (mine.columns, mine.score, mine.best_upper, mine.best_lower,
                mine.iterations) == (res.columns, res.score, res.best_upper,
                                     res.best_lower, res.iterations), key
    buckets = len(device_driver.buckets_of(records, app.enumerate_pairs(
        records)))
    assert graph.captures == graph.closed == buckets
    assert hybrid_driver.replays == hybrid_driver.turns - buckets > 0

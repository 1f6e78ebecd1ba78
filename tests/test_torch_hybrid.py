"""The port's hybrid backend vs. the JAX hybrid and the scalar mirror.

``lara_tpu_torch.solver.hybrid_driver`` on the CPU (the DP's plain
versions, the port's own native ``lagrange_host`` bookkeeping, on the
port's own ``Parameters``) must give every
pair the same columns, score, bounds and iteration count as
``lara_tpu.solver.hybrid_driver.solve_all`` and
``reference_driver.solve_pair``, on the family of ``tests/test_hybrid.py``,
including work stealing, the full-plane upload after an update overflow,
and the grid and resident DP variants.
"""

import pytest
import torch

from lara_tpu.app import enumerate_pairs
from lara_tpu.params import Parameters
from lara_tpu.solver import hybrid_driver as jax_hybrid
from lara_tpu.solver import reference_driver
from lara_tpu_torch import app
from lara_tpu_torch.native import NativeBuildError
from lara_tpu_torch.solver import device_driver, hybrid_driver

from tests.test_hybrid import make_family
from tests.test_torch_standalone import jax_native_or_skip, port_params

CPU = torch.device("cpu")


def _fields(res):
    return (res.columns, res.score, res.best_upper, res.best_lower,
            res.iterations)


def _port(records, params, **kw):
    """The port's results, on the port's copy of ``params``."""
    pairs = app.enumerate_pairs(records)
    results = list(hybrid_driver.solve_all(records, pairs,
                                           port_params(params), CPU, **kw))
    assert len(results) == len(pairs)
    return {r.seq_indices: r for r in results}


@pytest.mark.parametrize("kwargs", [
    dict(num_iterations=60),
    dict(num_iterations=60, library_score_min=0, library_score_max=100,
         library_score_is_linear=True),
    dict(num_iterations=60, matching=2),
    dict(num_iterations=60, matching=0),
    dict(num_iterations=60, matching=12),
    dict(num_iterations=7),
])
def test_hybrid_matches_jax_hybrid_and_mirror(kwargs):
    jax_native_or_skip()
    records = make_family()
    params = Parameters(in_file="<test>", **kwargs)
    pairs = enumerate_pairs(records)
    port = _port(records, params)
    jax = {r.seq_indices: r
           for r in jax_hybrid.solve_all(records, pairs, params)}
    for (ia, ib) in pairs:
        ref = reference_driver.solve_pair(records[ia], records[ib], params,
                                          (ia, ib))
        got = port[ref.seq_indices]
        assert _fields(got) == _fields(ref), (ia, ib)
        assert _fields(got) == _fields(jax[ref.seq_indices]), (ia, ib)


def test_work_stealing_more_pairs_than_lanes():
    """15 pairs through 3 lanes: each finished lane is refilled at once."""
    jax_native_or_skip()
    records = make_family(n=6)
    params = Parameters(in_file="<test>", num_iterations=30)
    pairs = enumerate_pairs(records)
    assert len(pairs) == 15
    port = _port(records, params, max_lanes=3)
    jax = {r.seq_indices: r
           for r in jax_hybrid.solve_all(records, pairs, params, max_lanes=3)}
    for (ia, ib) in pairs:
        got = port[(min(ia, ib), max(ia, ib))]
        assert _fields(got) == _fields(jax[got.seq_indices]), (ia, ib)


def test_update_overflow_uploads_full_planes(monkeypatch):
    """With room for only 2 sparse PSSM updates per lane, lanes overflow
    (count -1) and re-upload their whole plane; the results stay equal."""
    jax_native_or_skip()
    records = make_family()
    params = Parameters(in_file="<test>", num_iterations=40)
    want = _port(records, params)
    planes = []
    set_plane = hybrid_driver._DeviceStep.set_plane

    def counting(self, lane, plane):
        planes.append(lane)
        return set_plane(self, lane, plane)

    monkeypatch.setattr(hybrid_driver, "UPD_CAP", 2)
    monkeypatch.setattr(hybrid_driver._DeviceStep, "set_plane", counting)
    got = _port(records, params)
    assert planes, "no lane overflowed its update capacity"
    for key, res in want.items():
        assert _fields(got[key]) == _fields(res), key


@pytest.mark.parametrize("switch", ["LARA_DP_GRID", "LARA_DP_RESIDENT"])
def test_dp_variants_give_the_same_results(monkeypatch, switch):
    jax_native_or_skip()
    records = make_family()
    params = Parameters(in_file="<test>", num_iterations=40, matching=0)
    want = _port(records, params)
    monkeypatch.setenv(switch, "1")
    got = _port(records, params)
    for key, res in want.items():
        assert _fields(got[key]) == _fields(res), key


def test_turns_count_batched_iterations():
    """One lane per pair and no refill: the loop turns as often as the
    longest pair iterates."""
    jax_native_or_skip()
    records = make_family()
    params = Parameters(in_file="<test>", num_iterations=25)
    hybrid_driver.turns = 0
    iterations = [r.iterations for r in _port(records, params).values()]
    assert max(iterations) == 25 and min(iterations) < 25
    assert hybrid_driver.turns == 25


def test_failed_native_build_raises(monkeypatch, tmp_path):
    """No silent fall-back to the scalar mirror: a failed lagrange_host
    build raises from solve_all and is a clean error in the CLI."""
    from lara_tpu_torch.cli import main
    from lara_tpu_torch.native import lagrange

    def broken():
        raise NativeBuildError("g++ failed for lagrange_host: no compiler")

    monkeypatch.setattr(lagrange, "_load", broken)
    records = make_family(n=2)
    params = port_params(Parameters(in_file="<test>", matching=0))
    with pytest.raises(NativeBuildError):
        device_driver.solve_all(records, app.enumerate_pairs(records), params,
                                [CPU])
    path = tmp_path / "two.dbn"
    path.write_text(">h1\nGGGGAAAACCCC\n((((....))))\n"
                    ">h2\nGGGCAAAAGCCC\n(((.(...))))\n")
    monkeypatch.setenv("LARA_PLATFORM", "cpu")
    assert main(["-i", str(path), "-m", "0"]) == 1

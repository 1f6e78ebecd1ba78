"""The output check: a sound run is correct, and the control and each
fault the cells can have make ``correct`` false.  The runs skip the look
for a card and drive the rest of a run on the CPU at a size that fits a
test, with the timed path broken underneath.  (The cells run on one card,
so there is no exchange between cards to leave out.)"""

import dataclasses
import time

import pytest

from gpubench import harness
from gpubench.tests.conftest import TINY_CONFIG, TINY_TRAFFIC


def _rehearse(seed=5):
    return harness.rehearse("trna72.families15", seed, 1.0, TINY_CONFIG,
                            TINY_TRAFFIC)


def test_a_sound_run_is_correct(cpu):
    out = _rehearse()
    assert out["correct"], out["checks"]
    assert out["checks"]["pairs_compared"] == min(6, 3 * out["attempted"])
    assert list(out)[-1] == "checks"


def test_the_control_fails(cpu):
    import torch

    cell = harness.load_cell("trna72.families15")
    cell = cell._replace(
        config={**cell.config,
                "generator": {**cell.config["generator"], "length": 30},
                "params": {**cell.config["params"], "num_iterations": 20}},
        traffic={**cell.traffic, **TINY_TRAFFIC})
    out = harness.run(cell, 5, 1.0, False, torch.device("cpu"),
                      time.monotonic(), 1, control=True)
    checks = out["checks"]
    assert checks["pairs_differing"]["value"] == 0
    assert checks["control_pairs_differing"]["value"] > 0


def test_a_step_that_returns_its_state_unchanged_fails(cpu, monkeypatch):
    from lara_tpu_torch.solver import device_solver

    monkeypatch.setattr(device_solver, "_iteration",
                        lambda model, st, c, *args, **kwargs: c)
    assert not _rehearse()["correct"]


def test_half_of_the_pairs_left_out_fails(cpu, monkeypatch):
    from lara_tpu_torch import app

    enumerate_pairs = app.enumerate_pairs
    monkeypatch.setattr(app, "enumerate_pairs", lambda store: (
        lambda pairs: pairs[:len(pairs) // 2])(enumerate_pairs(store)))
    out = _rehearse()
    assert not out["correct"]
    assert out["checks"]["pairs_unaccounted"]["value"] > 0


@pytest.mark.parametrize("field", ["iterations", "columns"])
def test_an_answer_altered_where_it_is_produced_fails(cpu, monkeypatch,
                                                      field):
    from lara_tpu_torch.solver import device_driver

    produce = device_driver._postprocess_lane

    def altered(*args, **kwargs):
        result = produce(*args, **kwargs)
        if field == "iterations":
            return dataclasses.replace(result,
                                       iterations=result.iterations + 1)
        cols = [(a, b, 1500 - w) for (a, b, w) in result.columns]
        return dataclasses.replace(result, columns=cols)

    monkeypatch.setattr(device_driver, "_postprocess_lane", altered)
    out = _rehearse()
    assert not out["correct"]
    assert out["checks"]["pairs_differing"]["value"] > 0


def test_a_job_that_fails_in_the_window_fails(cpu, monkeypatch):
    from lara_tpu_torch import app

    calls = []
    solve = app._run

    def second_fails(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:  # the warm-up job passes, the window's first not
            raise RuntimeError("a job that fails")
        return solve(*args, **kwargs)

    monkeypatch.setattr(app, "_run", second_fails)
    out = _rehearse()
    assert not out["correct"]
    assert out["failed"] == 1 and out["checks"]["jobs_failed"]["value"] == 1

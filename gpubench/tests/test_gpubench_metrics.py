"""BENCHMARK.json's metrics against the harness: every cell reports the
end-to-end metric that each of its per-layer metrics moves, every
per-layer metric has its reader, and a ``.card`` reader reads what its
original reads."""

import json
from pathlib import Path

import pytest

from gpubench import harness

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
PER_LAYER = [m["name"] for m in BENCH["per_layer"]]
CARD = [n for n in PER_LAYER if n.endswith(".card")]


def _window(*jobs):
    return harness.Window(cell=None, wall_s=2.0, jobs=[
        harness.JobStat(wall_s=wall, pairs=pairs, phases=phases)
        for wall, pairs, phases in jobs], iterations=0, trace=None)


JOBS = (
    (0.5, 10, {"read input": 0.003, "write results": 0.004,
               "interaction build (host)": 0.010,
               "interaction build: pair": 0.030,
               "interaction build: native call": 0.020,
               "edge filter (device)": 0.006,
               "edge filter: unskew (host)": 0.002,
               "model packing: host buffer": 0.004,
               "result postprocess (host)": 0.005,
               "graph capture": 0.008, "graph warm-up": 0.001,
               "dispatch (host)": 0.012}),
    (0.7, 30, {"read input": 0.005, "write results": 0.006,
               "interaction build (host)": 0.030,
               "interaction build: pair": 0.090,
               "interaction build: native call": 0.050,
               "edge filter (device)": 0.009,
               "edge filter: unskew (host)": 0.006,
               "model packing: host buffer": 0.004,
               "result postprocess (host)": 0.015,
               "graph capture": 0.012,
               "dispatch (host)": 0.020}),
)


@pytest.mark.parametrize("workload", CELLS)
def test_a_cell_reports_what_its_per_layer_metrics_move(workload):
    cell = harness.load_cell(workload)
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in reported - {"setup_s"}, m["name"]


@pytest.mark.parametrize("name", PER_LAYER)
def test_a_per_layer_metric_has_its_reader(name):
    assert (REPO / "gpubench" / "metrics" / f"{name}.py").is_file()


@pytest.mark.parametrize("name", CARD)
def test_a_card_reader_reads_as_its_original(name):
    original = name[:-len(".card")]
    assert original in PER_LAYER
    for window in (_window(*JOBS), _window()):
        assert harness.read_metric(name, window) \
            == harness.read_metric(original, window)


def test_the_per_layer_rate_and_tail_read_the_window():
    window = _window(*JOBS)
    assert harness.read_metric("entry.alignments_per_s", window) \
        == pytest.approx(40 / 2.0)
    assert harness.read_metric("entry.family_p95_ms", window) \
        == pytest.approx(1e3 * (0.5 + 0.95 * 0.2))
    assert harness.read_metric("entry.alignments_per_s", _window()) is None
    assert harness.read_metric("entry.family_p95_ms", _window()) is None


def test_the_card_metric_is_no_cpu_number(cpu):
    """On the CPU the window has no dispatch to time: the card's metric is
    left out of the line, never read as 0."""
    from gpubench.tests.conftest import TINY_CONFIG, TINY_TRAFFIC

    out = harness.rehearse("trna72.families15", 7, 1.0, TINY_CONFIG,
                           TINY_TRAFFIC)
    assert set(out["metrics"]) == {"setup_s"}
    assert out["window"]["alignments_per_s"] > 0

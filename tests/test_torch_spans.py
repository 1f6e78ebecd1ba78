"""The port's phases as spans: ``timing.phase`` is a profiler range only
while a profiler runs, the driver, the entry and the dispatch graph time
their host work under the phases the benchmark's readers match on, and
each reader of ``gpubench/metrics/`` reads those phases.

The phases are looked up through the module (``timing.phase``) at every
call, so a spy put in its place sees every span, on every thread.
"""

import contextlib
import threading

import numpy as np
import pytest
import torch

from gpubench import harness
from lara_tpu_torch import app
from lara_tpu_torch.params import Parameters
from lara_tpu_torch.solver import device_driver, device_solver, dispatch_graph
from lara_tpu_torch.utils import timing

from tests.test_device_solver import write_family
from tests.test_torch_dispatch_graph import RecordingGraph

CPU = torch.device("cpu")

#: (nested phase, its parent): the nested one's seconds are at most the
#: parent's, summed over a run
NESTED = [
    ("edge filter: unskew (host)", "edge filter (device)"),
    ("model packing: host buffer", "model packing (host)"),
    ("interaction build: native call", "interaction build: pair"),
    ("edge filter inputs (host)", "solve"),
    ("result postprocess (host)", "solve"),
    ("library add (host)", "solve"),
    ("dispatch flag wait (host)", "subgradient solve (device)"),
]


def _spy_phases(monkeypatch):
    """Replace ``timing.phase`` by a wrapper that records (name, thread)
    of every phase entered, and returns that list."""
    seen = []
    real = timing.phase
    lock = threading.Lock()

    @contextlib.contextmanager
    def phase(name):
        with lock:
            seen.append((name, threading.current_thread()))
        with real(name):
            yield

    monkeypatch.setattr(timing, "phase", phase)
    return seen


def test_phase_enters_no_range_without_a_profiler(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: calls.append(a))
    timing.reset()
    assert not torch.autograd._profiler_enabled()
    with timing.phase("spans test"):
        pass
    assert calls == []
    assert timing._COUNTS["spans test"] == 1


def test_phase_is_a_range_under_the_profiler():
    timing.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timing.phase("spans test"):
            with timing.phase("spans test: inner"):
                pass
    names = {e.name for e in prof.events()}
    assert {"phase:spans test", "phase:spans test: inner"} <= names
    assert timing._COUNTS["spans test"] == 1
    assert timing._COUNTS["spans test: inner"] == 1


@pytest.fixture(scope="module")
def family_run(tmp_path_factory):
    """``app.run`` on the CPU at ``-j 2`` over a family of 5 (10 pairs),
    40 iterations in dispatches of 10, with every phase entered recorded:
    (run, phases entered, counts, seconds)."""
    tmp = tmp_path_factory.mktemp("spans")
    path = write_family(tmp, n=5, seed=11)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LARA_PLATFORM", "cpu")
        mp.setenv("LARA_CHUNK", "10")  # four dispatches: flags are read
        seen = _spy_phases(mp)
        run = app.run(Parameters(in_file=path, num_iterations=40, threads=2,
                                 out_file=str(tmp / "out.lib")),
                      devices=[CPU])
        counts = dict(timing._COUNTS)
        seconds = dict(timing.snapshot())
    return run, seen, counts, seconds


def test_pair_build_is_a_span_on_the_pool_threads(family_run):
    """The chunk's native build books each pair's seconds inside the
    library ("native call") and with its share of the Python work around
    the call ("pair"), one count a pair each, after the call; the library's
    threads, at most ``-j`` of them, run under "interaction build
    (host)"."""
    run, seen, counts, seconds = family_run
    pairs = len(run.results)
    assert pairs == 10
    assert counts["interaction build: pair"] == pairs
    assert counts["interaction build: native call"] == pairs
    assert seconds["interaction build: native call"] \
        <= seconds["interaction build: pair"]
    # at most -j 2 threads build at once
    assert seconds["interaction build: pair"] \
        <= 2 * seconds["interaction build (host)"]
    hosts = [t for name, t in seen if name == "interaction build (host)"]
    assert hosts and all(t is threading.main_thread() for t in hosts)
    assert not [t for name, t in seen if name == "interaction build: pair"]


@pytest.mark.parametrize("name", ["interaction build: native call",
                                  "result postprocess (host)",
                                  "library add (host)"])
def test_per_pair_spans_once_a_pair(family_run, name):
    run, _, counts, _ = family_run
    assert counts[name] == len(run.results)


@pytest.mark.parametrize("inner, outer", NESTED)
def test_nested_span_is_at_most_its_parent(family_run, inner, outer):
    _, _, counts, seconds = family_run
    assert counts[inner] >= 1
    assert seconds[inner] <= seconds[outer]


def test_native_build_fallback_is_logged_once(monkeypatch, capsys):
    """Without the native library the build falls back to NumPy as
    before, and says why once, at verbosity 1."""
    from lara_tpu_torch import native
    from lara_tpu_torch.solver import interactions
    from lara_tpu_torch.utils import get_verbosity, set_verbosity

    def refuse(name):
        raise OSError(f"no {name} here")

    monkeypatch.setattr(native, "shared_library", refuse)
    monkeypatch.setattr(interactions, "_NATIVE_BUILD", None)
    monkeypatch.delenv("LARA_NO_NATIVE_BUILD", raising=False)
    level = get_verbosity()
    set_verbosity(1)
    try:
        assert interactions._native_build() is None
        assert interactions._native_build() is None
    finally:
        set_verbosity(level)
    err = capsys.readouterr().err
    assert err.count("native model build unavailable") == 1
    assert "no model_build here" in err


def _chunk_batch(tmp_path):
    """A chunk of the port's own models on the CPU: (model, la_max,
    lb_max, scan_steps)."""
    from lara_tpu_torch.io.records import InputStorage

    path = write_family(tmp_path, n=4, seed=5)
    store = InputStorage(in_file=path)
    params = Parameters(in_file=path)
    pairs = app.enumerate_pairs(store)
    la = max(len(store[a].sequence) for a, _ in pairs)
    lb = max(len(store[b].sequence) for _, b in pairs)
    models, _ = device_driver._filter_and_build(store, pairs, params, la, lb,
                                                CPU)
    model, scan = device_driver._pack_models(models, params, la, lb, CPU)
    return model, la, lb, scan


def test_graph_capture_and_warm_up_spans(tmp_path, monkeypatch):
    """With the recording stand-in for the CUDA graph: "graph capture" once
    per new entry, "graph warm-up" once per key, both inside "dispatch
    (host)", which is entered once per dispatch."""
    monkeypatch.setenv("LARA_PLATFORM", "cpu")
    monkeypatch.setattr(dispatch_graph, "Graph", RecordingGraph)
    monkeypatch.setattr(dispatch_graph, "_warm", set())
    dispatch_graph.release()
    model, la, lb, scan = _chunk_batch(tmp_path)
    b, d = model.dual_l.shape
    timing.reset()

    def dispatch(carry, max_nondecr=5):
        return device_solver.solve_batch_chunk(model, carry, 3, 1, la, lb, 4,
                                               max_nondecr, 5, scan)

    def carry0():
        return device_solver._init_carry(b, d, la, np.float32(1.0), 20, CPU)

    try:
        dispatch(dispatch(carry0()))       # one entry, captured once
        dispatch_graph.release()
        dispatch(carry0())                 # a new entry of the same key
        dispatch(carry0(), max_nondecr=6)  # a second key
    finally:
        dispatch_graph.release()
    counts, seconds = timing._COUNTS, timing.snapshot()
    assert counts["dispatch (host)"] == 4
    assert counts["graph capture"] == 3
    assert counts["graph warm-up"] == 2
    assert seconds["graph capture"] + seconds["graph warm-up"] \
        <= seconds["dispatch (host)"]


# -- the readers --------------------------------------------------------

def _window(*jobs):
    return harness.Window(cell=None, wall_s=1.0, jobs=[
        harness.JobStat(wall_s=0.5, pairs=pairs, phases=phases)
        for pairs, phases in jobs], iterations=0, trace=None)


JOBS = (
    (10, {"interaction build (host)": 0.010,
          "interaction build: pair": 0.030,
          "interaction build: native call": 0.020,
          "edge filter: unskew (host)": 0.002,
          "model packing: host buffer": 0.004,
          "result postprocess (host)": 0.005,
          "graph capture": 0.008, "graph warm-up": 0.001,
          "dispatch (host)": 0.012}),
    (30, {"interaction build (host)": 0.030,
          "interaction build: pair": 0.090,
          "interaction build: native call": 0.050,
          "edge filter: unskew (host)": 0.006,
          "model packing: host buffer": 0.004,
          "result postprocess (host)": 0.015,
          "graph capture": 0.012,
          "dispatch (host)": 0.020}),
)

#: each reader's value on ``JOBS``: 40 pairs over 2 jobs
READINGS = {
    "driver.build_parallelism": 0.120 / 0.040,
    "driver.build_prelude_ms_per_pair": 1e3 * (0.120 - 0.070) / 40,
    "driver.filter_unskew_ms_per_pair": 1e3 * 0.008 / 40,
    "driver.pack_host_ms_per_pair": 1e3 * 0.008 / 40,
    "driver.postprocess_ms_per_pair": 1e3 * 0.020 / 40,
    "graph.capture_span_ms_per_family": 1e3 * 0.020 / 2,
    "solver.launch_ms_per_family": 1e3 * (0.032 - 0.020 - 0.001) / 2,
}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader_reads_its_spans(name):
    assert harness.read_metric(name, _window(*JOBS)) \
        == pytest.approx(READINGS[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader_is_none_without_jobs_or_spans(name):
    assert harness.read_metric(name, _window()) is None
    # a program without the spans: only the phases it had before them
    older = {"interaction build (host)": 0.01, "edge filter (device)": 0.01,
             "model packing (host)": 0.01, "solve": 0.1}
    assert harness.read_metric(name, _window((10, older))) is None

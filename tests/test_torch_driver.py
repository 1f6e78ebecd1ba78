"""The port's single-device driver scheduling on the CPU (``LARA_PLATFORM=cpu``).

The cross-chunk pipeline and its depth-2 drain, the forced single-bucket
split, chunking, the device byte budget's gates, ``LARA_CHUNK`` and
``LARA_PROFILE`` may change when work runs, never the results: every case
must write the library bytes of the JAX device backend and of the scalar
mirror, with zero tolerance.  Spies show that each case took the branch it
names.  ``_model_rows`` is held against the JAX package's on the same
numpy inputs.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lara_tpu_torch.app import enumerate_pairs
from lara_tpu_torch.io.records import InputStorage
from lara_tpu_torch.io.writers import OutputLibrary
from lara_tpu_torch.params import Parameters
from lara_tpu_torch.solver import device_driver, device_solver

from tests.test_device_solver import run_backend, write_family

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
KNOBS = ("LARA_PIPELINE", "LARA_SPLIT_SINGLE", "LARA_MAX_BATCH", "LARA_CHUNK",
         "LARA_PROFILE")


@pytest.fixture(autouse=True)
def clean_knobs(monkeypatch):
    for key in KNOBS:
        monkeypatch.delenv(key, raising=False)


@functools.lru_cache(maxsize=None)
def _expected(text: str, backend: str, kw: tuple) -> str:
    """The JAX package's library for a family (``backend`` "device" or
    "reference"), computed once per family and parameters."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "family.dbn")
        with open(path, "w") as handle:
            handle.write(text)
        return run_backend(path, backend, **dict(kw))


def expected(path, backend, **kw):
    with open(path) as handle:
        return _expected(handle.read(), backend, tuple(sorted(kw.items())))


def assert_jax_and_mirror(port: str, path, **kw):
    assert port == expected(path, "reference", **kw)
    assert port == expected(path, "device", **kw)


def solve_port(path, events=None, **kw):
    """The port's library for ``path``; ``events`` (a list) gets one
    ("yield", pair) entry per result as it arrives."""
    params = Parameters(in_file=str(path), **kw)
    store = InputStorage(in_file=str(path))
    lib = OutputLibrary(store, params.out_format)
    for res in device_driver.solve_all(store, enumerate_pairs(store), params,
                                       [CPU]):
        if events is not None:
            events.append(("yield", res.seq_indices))
        lib.add_alignment(res.seq_indices, res.columns, res.score)
    return lib.to_string()


def spy(monkeypatch, module, name, record):
    """Replace ``module.name`` with a wrapper that calls ``record(*args)``
    first."""
    original = getattr(module, name)

    def wrapper(*args, **kwargs):
        record(*args)
        return original(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapper)


def write_mixed(tmp_path):
    """Three length classes (32, 64 and 96 pads): three buckets, so the
    pipeline's depth-2 window drains mid-loop (the family of
    ``tests/test_device_solver.py::test_pipelined_chunks_match_serial``)."""
    short = "GGGCGCAAGCCUUAAGGCGCCC"
    long_ = ("GGGCGCAAGCCUUAAGGCGCCCAAGGCUUAGCGGGCGCAAGCCUUAAGGCGCCCAAGGCUUAGC")
    st_s = "(((((((......))))))).."
    st_l = "(((((((......)))))))............(((((((......)))))))............"
    longer = long_ + "GGGCGCAAGCCUUAAGGCGCCCAAGGCUUAGC"
    st_x = st_l + "(((((((......)))))))............"[: len(longer) - len(st_l)]
    rng = np.random.default_rng(9)
    lines = []
    for prefix, seq0, st, n in (("s", short, st_s, 3), ("l", long_, st_l, 3),
                                ("x", longer, st_x, 2)):
        for k in range(n):
            seq = list(seq0)
            seq[int(rng.integers(0, len(seq)))] = "ACGU"[rng.integers(0, 4)]
            lines.append(f">{prefix}{k}\n{''.join(seq)}\n{st}")
    path = tmp_path / "mixed.dbn"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_pipeline_matches_serial(tmp_path, monkeypatch):
    """Three buckets pipelined under LARA_PIPELINE=1 (depth 2, drained
    mid-loop) against the serial default."""
    path = write_mixed(tmp_path)
    solved = []
    spy(monkeypatch, device_driver, "_solve_on",
        lambda stream, prep, params: solved.append(len(prep.chunk)))
    serial = solve_port(path, num_iterations=40)
    assert solved == []
    monkeypatch.setenv("LARA_PIPELINE", "1")
    pipelined = solve_port(path, num_iterations=40)
    assert pipelined == serial
    store = InputStorage(in_file=path)
    sizes = [len(p) for _, p in device_driver.buckets_of(
        store, enumerate_pairs(store))]
    assert len(sizes) > 2 and sorted(solved) == sorted(sizes)
    assert_jax_and_mirror(pipelined, path, num_iterations=40)


def test_forced_split_matches_unsplit(tmp_path, monkeypatch):
    """LARA_SPLIT_SINGLE=1 cuts the one chunk of 10 short pairs into two
    pipelined chunks of 5 (8 lanes each); 0 keeps one chunk."""
    path = write_family(tmp_path, n=5, seed=17)
    monkeypatch.setenv("LARA_PIPELINE", "1")
    solved = []
    spy(monkeypatch, device_driver, "_solve_on",
        lambda stream, prep, params: solved.append(len(prep.chunk)))
    monkeypatch.setenv("LARA_SPLIT_SINGLE", "0")
    unsplit = solve_port(path, num_iterations=60)
    assert solved == []
    monkeypatch.setenv("LARA_SPLIT_SINGLE", "1")
    split = solve_port(path, num_iterations=60)
    assert split == unsplit
    assert solved == [5, 5]
    assert_jax_and_mirror(split, path, num_iterations=60)


def test_split_rules():
    """The split needs LARA_SPLIT_SINGLE=1 on one device, long pairs
    included, and a lone chunk of at least 4 pairs whose halves pad to one
    batch."""
    forced = {"LARA_SPLIT_SINGLE": "1"}

    def tasks(n, la, env):
        os.environ.update(env)
        try:
            plan = device_driver._split_single(
                [device_driver._Task(la, la, list(range(n)))])
        finally:
            for key in env:
                del os.environ[key]
        return [len(t.pairs) for t in plan]

    assert tasks(28, 1536, {}) == [28]
    assert tasks(28, 96, {}) == [28]
    assert tasks(28, 96, forced) == [14, 14]
    assert tasks(28, 1536, forced) == [14, 14]
    assert tasks(28, 1536, {"LARA_SPLIT_SINGLE": "0"}) == [28]
    assert tasks(9, 1536, forced) == [9]    # 5 + 4 pad to 8 + 4
    assert tasks(3, 1536, forced) == [3]
    assert tasks(17, 1536, forced) == [17]  # 9 + 8 pad to 16 + 8


@pytest.mark.parametrize("env", [
    {},                                           # one chunk
    {"LARA_MAX_BATCH": "3"},                      # serial chunks
    {"LARA_SPLIT_SINGLE": "1", "LARA_PIPELINE": "1"},  # forced split
    {"LARA_MAX_BATCH": "3", "LARA_PIPELINE": "1"},     # chunking + pipeline
    {"LARA_MAX_BATCH": "4", "LARA_CHUNK": "7"},   # short dispatches
], ids=["default", "no-pipeline", "split", "max-batch-3", "refill"])
def test_scheduler_knobs_match_mirror(tmp_path, monkeypatch, env):
    """Five scheduler configurations, under the case names of the JAX
    package's scheduler-equivalence test, write the mirror's bytes (and
    the JAX device backend's).  The port has no lane refill: its
    ``refill`` case runs serial chunks in short dispatches."""
    path = write_family(tmp_path, n=5, seed=41)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    assert_jax_and_mirror(solve_port(path, num_iterations=50), path,
                          num_iterations=50)


@pytest.mark.parametrize("env", [
    {},
    {"LARA_PIPELINE": "1", "LARA_MAX_BATCH": "3"},
], ids=["chunk", "refill-fallback"])
def test_halving_guard(tmp_path, monkeypatch, env):
    """A chunk whose estimate is above twice the device budget is solved in
    halves, down to single pairs when the budget is tiny; under the
    pipeline, a chunk above the budget leaves it (``_prepare_chunk`` hands
    its models back) and is solved in halves the same way."""
    path = write_family(tmp_path, n=4, seed=3)
    monkeypatch.setattr(device_driver, "DEVICE_BUDGET", 1)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    packed, solved = [], []
    spy(monkeypatch, device_driver, "_prepare",
        lambda chunk, *rest: packed.append(len(chunk)))
    spy(monkeypatch, device_driver, "_solve_on",
        lambda *args: solved.append(args))
    port = solve_port(path, num_iterations=60)
    assert packed == [1] * 6 and not solved
    assert_jax_and_mirror(port, path, num_iterations=60)


def test_pending_budget_keeps_one_chunk(tmp_path, monkeypatch):
    """Single-pair chunks above the budget still enter the pipeline, and
    the budget drains the pending chunks down to one, not to none: chunk
    k+1 is prepared before chunk k's result is read, and chunk k's result
    is read before chunk k+2 is prepared (the budget's drain, ahead of the
    depth-2 one)."""
    path = write_family(tmp_path, n=4, seed=3)
    monkeypatch.setattr(device_driver, "DEVICE_BUDGET", 1)
    monkeypatch.setenv("LARA_MAX_BATCH", "1")
    monkeypatch.setenv("LARA_PIPELINE", "1")
    events = []
    spy(monkeypatch, device_driver, "_prepare_chunk",
        lambda store, task, *rest: events.append(
            ("prep", tuple(sorted(task.pairs[0])))))
    port = solve_port(path, events=events, num_iterations=60)
    pairs = [pair for kind, pair in events if kind == "prep"]
    assert len(pairs) == 6
    want = [("prep", pairs[0])]
    for k in range(1, 6):
        want += [("prep", pairs[k]), ("yield", pairs[k - 1])]
    want.append(("yield", pairs[5]))
    assert events == want
    assert_jax_and_mirror(port, path, num_iterations=60)


def _random_model(rng, b, la_max, lb_max, d):
    """A numpy BatchModel with involutive rev rows."""
    ne = la_max * lb_max
    rev = np.empty((b, d), np.int32)
    for k in range(b):
        perm = rng.permutation(d)
        rev[k] = np.arange(d)
        for x, y in zip(perm[0::2], perm[1::2]):
            rev[k, x], rev[k, y] = y, x
    return device_solver.BatchModel(
        seq_score=rng.integers(-500, 500, (b, ne)).astype(np.int32),
        active=rng.random((b, ne)) < 0.5,
        dual_l=rng.integers(0, ne, (b, d)).astype(np.int32),
        dual_m=rng.integers(0, ne, (b, d)).astype(np.int32),
        sscore=rng.integers(0, 100, (b, d)).astype(np.int32),
        rev=rev,
        dvalid=rng.random((b, d)) < 0.7,
        qrank=np.stack([rng.permutation(d) for _ in range(b)]).astype(
            np.int32),
        la=rng.integers(1, la_max + 1, b).astype(np.int32),
        lb=rng.integers(1, lb_max + 1, b).astype(np.int32))


def test_model_rows_match_jax(tmp_path):
    """The port's padded model rows (the tests' plain reference) equal
    the JAX driver's ``_model_rows``, padding lanes included, and every
    rev row is an involution."""
    from lara_tpu.solver import device_driver as jax_driver

    path = write_family(tmp_path, n=3, seed=7)
    store = InputStorage(in_file=path)
    params = Parameters(in_file=path)
    pairs = enumerate_pairs(store)
    models, _ = device_driver._filter_and_build(store, pairs, params, 32, 32,
                                                CPU)
    dcap = device_driver._chunk_dcap(models)
    assert dcap == jax_driver._chunk_dcap(models)
    got = device_driver._model_rows(models, 32, 32, dcap)
    want = jax_driver._model_rows(models, 32, 32, dcap)
    for name, g, w in zip(device_solver.BatchModel._fields, got, want):
        np.testing.assert_array_equal(g, w, name)
    padded = device_driver._model_rows(models, 32, 32, dcap, 4)
    for name, g, w in zip(device_solver.BatchModel._fields, padded, got):
        np.testing.assert_array_equal(g[:3], w, name)
    assert (padded.la[3], padded.lb[3], padded.dvalid[3].sum()) == (1, 1, 0)
    for row in padded.rev:
        np.testing.assert_array_equal(row[row], np.arange(dcap))


def test_chunk_env_sets_dispatch(tmp_path, monkeypatch):
    """LARA_CHUNK=7 cuts the solve into 7-iteration dispatches with the same
    bytes; LARA_CHUNK=0 raises before any work.  The family's structures
    conflict, so its pairs iterate."""
    from tests.test_torch_slice import write_conflicting

    path = write_conflicting(tmp_path)
    steps = []
    spy(monkeypatch, device_solver, "solve_batch_chunk",
        lambda model, carry, go, ge, la, lb, max_steps, *rest:
            steps.append(max_steps))
    monkeypatch.setenv("LARA_CHUNK", "7")
    port = solve_port(path, num_iterations=40)
    assert len(steps) > 1 and set(steps[:-1]) == {7} and steps[-1] <= 7
    assert_jax_and_mirror(port, path, num_iterations=40)
    monkeypatch.setenv("LARA_CHUNK", "0")
    store = InputStorage(in_file=path)
    with pytest.raises(ValueError, match="LARA_CHUNK"):
        device_driver.solve_all(store, enumerate_pairs(store),
                                Parameters(in_file=path), [CPU])


def test_profile_env_writes_trace(tmp_path):
    """LARA_PROFILE=<dir> writes a torch.profiler trace there and the same
    library bytes, and the port still never imports JAX."""
    path = write_family(tmp_path, n=3, seed=29)
    plain, traced = tmp_path / "plain.lib", tmp_path / "traced.lib"
    trace_dir = tmp_path / "trace"
    code = (
        "import os, sys\n"
        "from lara_tpu_torch.cli import main\n"
        f"assert main(['-i', {path!r}, '-w', {str(plain)!r}, '-n', '40']) "
        "== 0\n"
        f"os.environ['LARA_PROFILE'] = {str(trace_dir)!r}\n"
        f"assert main(['-i', {path!r}, '-w', {str(traced)!r}, '-n', '40']) "
        "== 0\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
    )
    env = dict(os.environ, LARA_PLATFORM="cpu")
    env.pop("LARA_PROFILE", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    traces = list(trace_dir.glob("*.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    assert traced.read_text() == plain.read_text()
    assert plain.read_text() == expected(path, "reference", num_iterations=40)

"""The chunk build of the interaction models vs. the JAX package.

``lara_tpu_torch.solver.interactions.build_chunk`` builds every pair of a
chunk in one call of the native model_build library (C++ threads, the
interpreter's lock released), reading the edge filter's ``[B, LA, LB]``
grid in place; without the library it builds each pair with the NumPy
mirror on a pool of Python threads.  Either way each model must equal
``lara_tpu.solver.interactions.build_pair_model`` of the same pair in
every field, the lazily gathered ``seq_score`` included, with zero
tolerance (every field is an integer or a float32 scale).
"""

import math

import numpy as np
import pytest

from lara_tpu.io.records import RnaRecord as JaxRecord
from lara_tpu.params import Parameters as JaxParameters
from lara_tpu.solver import interactions as jax_interactions
from lara_tpu_torch.io.records import RnaRecord
from lara_tpu_torch.params import Parameters
from lara_tpu_torch.solver import interactions
from lara_tpu_torch.utils import timing

#: fields of the JAX package's model, each compared
FIELDS = ("la", "lb", "seq_a", "seq_b", "active", "seq_score", "dual_l",
          "dual_m", "sscore", "rev", "qperm", "scale")
NATIVE = "interaction build: native call"
PAIR = "interaction build: pair"

#: parameter sets: the defaults, ``-b auto`` with ``-c``, precise weights
PARAMS = {
    "default": {},
    "auto": {"balance_auto": True, "sequence_scale": 0.5},
    "precise": {"precise_bpp": True, "balance": 0.5},
}


def _random_edges(rng, length):
    edges = []
    for _ in range(int(rng.integers(0, length))):
        i, j = sorted(rng.choice(length, 2, replace=False).tolist())
        if j - i < 4:
            continue
        p = float(rng.uniform(0.02, 0.95))
        edges.append((i, j, math.log(p / 0.003)))
    return sorted(edges)


def _chunk(seed, b, la_max, lb_max, empty=()):
    """A random chunk of ``b`` pairs of mixed lengths under one
    ``(la_max, lb_max)``: (port records, JAX records, active grid, opt
    scores).  Cells beyond a pair's lengths are set at random, so a build
    that reads past them differs; the lanes in ``empty`` have no active
    cell."""
    rng = np.random.default_rng(seed)
    ports, jaxes = [], []
    active = rng.random((b, la_max, lb_max)) < 0.4
    opts = []
    for k in range(b):
        la = int(rng.integers(max(1, la_max // 3), la_max + 1))
        lb = int(rng.integers(max(1, lb_max // 3), lb_max + 1))
        pair_p, pair_j = [], []
        for name, length in (("a", la), ("b", lb)):
            seq = "".join("ACGU"[c] for c in rng.integers(0, 4, length))
            edges = _random_edges(rng, length)
            pair_p.append(RnaRecord(name=f"{name}{k}", sequence=seq,
                                    bpp_edges=edges))
            pair_j.append(JaxRecord(name=f"{name}{k}", sequence=seq,
                                    bpp_edges=edges))
        ports.append(tuple(pair_p))
        jaxes.append(tuple(pair_j))
        for a in range(min(la, lb)):
            active[k, a, a] = True
        if k in empty:
            active[k] = False
        # av_seq_id on both sides of -b auto's thresholds (0 and 0.8)
        opts.append(int(rng.integers(-8192 * la // 4, 8192 * max(la, lb))))
    return ports, jaxes, active, opts


def _assert_equals_jax(models, jaxes, active, opts, kind):
    jax_params = JaxParameters(in_file="<test>", **PARAMS[kind])
    assert len(models) == len(jaxes)
    for k, (model, (rec_a, rec_b)) in enumerate(zip(models, jaxes)):
        la, lb = len(rec_a.sequence), len(rec_b.sequence)
        want = jax_interactions.build_pair_model(
            rec_a, rec_b, jax_params, active[k, :la, :lb].copy(), opts[k])
        for name in FIELDS:
            got, ref = getattr(model, name), getattr(want, name)
            if isinstance(ref, np.ndarray):
                assert got.dtype == ref.dtype, (k, name)
            np.testing.assert_array_equal(got, ref, f"pair {k}: {name}")


@pytest.fixture
def native():
    if interactions._native_build() is None:
        pytest.skip("no C++ toolchain for the native model build")


@pytest.fixture
def numpy_build(monkeypatch):
    """The NumPy fallback: ``LARA_NO_NATIVE_BUILD`` set, the library's
    handle forgotten for the test and restored after it."""
    monkeypatch.setenv("LARA_NO_NATIVE_BUILD", "1")
    monkeypatch.setattr(interactions, "_NATIVE_BUILD", None)
    assert interactions._native_build() is None


@pytest.mark.parametrize("workers", [1, 2, 4, 64])
@pytest.mark.parametrize("kind", sorted(PARAMS))
def test_chunk_build_equals_jax(native, kind, workers):
    """Mixed lengths under one padded shape, two lanes with no active
    cell, one to more threads than pairs."""
    ports, jaxes, active, opts = _chunk(7 + workers, 12, 40, 32,
                                        empty=(3, 8))
    models = interactions.build_chunk(
        ports, Parameters(in_file="<test>", **PARAMS[kind]), active, opts,
        workers)
    _assert_equals_jax(models, jaxes, active, opts, kind)
    assert all(len(models[k].dual_l) == 0 for k in (3, 8))


@pytest.mark.parametrize("kind", sorted(PARAMS))
def test_numpy_fallback_equals_jax(numpy_build, kind):
    ports, jaxes, active, opts = _chunk(3, 9, 36, 36, empty=(0,))
    models = interactions.build_chunk(
        ports, Parameters(in_file="<test>", **PARAMS[kind]), active, opts, 3)
    _assert_equals_jax(models, jaxes, active, opts, kind)


@pytest.mark.parametrize("workers", [1, 4])
def test_chunk_of_empty_lanes(native, workers):
    ports, jaxes, active, opts = _chunk(5, 5, 24, 20, empty=range(5))
    models = interactions.build_chunk(ports, Parameters(in_file="<test>"),
                                      active, opts, workers)
    _assert_equals_jax(models, jaxes, active, opts, "default")
    assert all(len(m.dual_l) == 0 for m in models)


@pytest.mark.parametrize("seed", range(3))
def test_pair_api_equals_jax(native, seed):
    """``build_pair_model``, the chunk build of one pair, on a tight
    ``[la, lb]`` grid."""
    ports, jaxes, active, opts = _chunk(20 + seed, 1, 48, 40)
    (rec_a, rec_b), = ports
    grid = np.ascontiguousarray(
        active[0, :len(rec_a.sequence), :len(rec_b.sequence)])
    model = interactions.build_pair_model(rec_a, rec_b,
                                          Parameters(in_file="<test>"), grid,
                                          opts[0])
    _assert_equals_jax([model], jaxes, active, opts, "default")


@pytest.mark.parametrize("workers", [1, 3])
def test_engagement_count_is_the_native_pairs(native, workers):
    """One "native call" and one "pair" count a pair built natively, the
    native seconds within the pair's, both within the threads' share of
    the call's wall."""
    ports, _, active, opts = _chunk(11, 7, 30, 30, empty=(2,))
    timing.reset()
    with timing.phase("wall"):
        interactions.build_chunk(ports, Parameters(in_file="<test>"), active,
                                 opts, workers)
    counts, seconds = dict(timing._COUNTS), timing.snapshot()
    assert counts[NATIVE] == counts[PAIR] == len(ports)
    assert 0 < seconds[NATIVE] <= seconds[PAIR]
    assert seconds[PAIR] <= workers * seconds["wall"]


def test_engagement_count_is_zero_on_the_fallback(numpy_build):
    ports, _, active, opts = _chunk(11, 7, 30, 30)
    timing.reset()
    interactions.build_chunk(ports, Parameters(in_file="<test>"), active,
                             opts, 3)
    assert timing._COUNTS.get(NATIVE, 0) == 0
    assert timing._COUNTS[PAIR] == len(ports)


def test_seq_score_is_gathered_on_first_read(native):
    """The chunk build leaves ``seq_score`` ungathered; the first read
    gathers it once."""
    ports, jaxes, active, opts = _chunk(13, 2, 20, 20)
    model = interactions.build_chunk(ports, Parameters(in_file="<test>"),
                                     active, opts, 1)[0]
    assert "seq_score" not in vars(model)
    first = model.seq_score
    assert model.seq_score is first
    _assert_equals_jax([model], jaxes[:1], active, opts, "default")


def test_grid_smaller_than_a_pair_raises(native):
    ports, _, active, opts = _chunk(17, 2, 20, 20)
    with pytest.raises(ValueError, match="smaller than a pair"):
        interactions.build_chunk(ports, Parameters(in_file="<test>"),
                                 active[:, :4, :4], opts, 1)

"""The packed one-buffer model upload against the JAX driver's.

On one device ``device_driver._pack_models`` uploads a chunk as one int32
buffer in the JAX driver's layout (``lara_tpu/solver/device_driver.py:
776-806``) and rebuilds the ``BatchModel`` on the device
(``_unpack_model``).  Both layouts are held here, ``packed15`` on a tRNA
chunk and ``packed_seq`` on a 200x200 chunk (``la_max * lb_max > 32768``):
the port's buffer equals the JAX driver's word for word (its one-device
branch, reached by giving JAX one local device inside the test), the JAX
``_get_unpack_model`` of the port's buffer equals the port's unpack field
by field, padding cells included, and a solve from the unpacked model
equals a solve from the raw rows of ``_model_rows`` (zero tolerance).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lara_tpu.solver import device_driver as jax_driver
from lara_tpu_torch.app import enumerate_pairs
from lara_tpu_torch.params import Parameters
from lara_tpu_torch.solver import device_driver, device_solver
from lara_tpu_torch.workloads import make_family, make_long_family

CPU = torch.device("cpu")


class Chunk:
    def __init__(self, records, pad):
        self.records = records
        self.params = Parameters(in_file="<packed>", num_iterations=60)
        self.pairs = enumerate_pairs(records)
        self.models, self.las = device_driver._filter_and_build(
            records, self.pairs, self.params, pad, pad, CPU)
        self.pad = pad
        self.dcap = device_driver._chunk_dcap(self.models)
        self.n = device_driver._padded_batch(len(self.models))
        self.submat = np.asarray(self.params.score_matrix, np.int32)

    def buffer(self):
        return device_driver._packed_buffer(
            self.models, self.pad, self.pad, self.dcap, self.n,
            self.submat.shape[0]).numpy()


@pytest.fixture(scope="module")
def chunks():
    """tRNA: ``make_family(n=6)``, 15 pairs in one 96x96 chunk of 16 lanes
    (``packed15``); long: three 180 nt molecules (``make_long_family``),
    3 pairs padded to 200x200 in 4 lanes (``packed_seq``); solves of 60
    iterations."""
    return {
        "packed15": Chunk(make_family(n=6), 96),
        "packed_seq": Chunk(make_long_family(n=3, length=180, seed=31,
                                             mutations=12), 200),
    }


MODES = ["packed15", "packed_seq"]


@pytest.mark.parametrize("mode", MODES)
def test_buffer_equals_jax_buffer(chunks, mode, monkeypatch):
    """The JAX driver's ``_pack_models`` on one local device uploads the
    port's buffer, word for word, in the same mode."""
    chunk = chunks[mode]
    assert device_driver._packed_mode(chunk.pad, chunk.pad,
                                      chunk.dcap) == mode
    sent = []
    real = jax_driver._get_unpack_model

    def spy(ne, d, la_max, lb_max, got_mode, nk=5):
        unpack = real(ne, d, la_max, lb_max, got_mode, nk)

        def run(buf, submat_f):
            sent.append((np.asarray(buf), got_mode))
            return unpack(buf, submat_f)
        return run

    one = jax.local_devices()[:1]
    monkeypatch.setattr(jax, "local_devices", lambda *a, **k: one)
    monkeypatch.setattr(jax_driver, "_get_unpack_model", spy)
    lbs = np.array([len(chunk.records[b].sequence)
                    for _, b in chunk.pairs], np.int32)
    jax_driver._pack_models(chunk.records, chunk.pairs, chunk.models,
                            chunk.params, chunk.pad, chunk.pad, chunk.las,
                            lbs, chunk.dcap)
    ((want, want_mode),) = sent
    assert want_mode == mode
    np.testing.assert_array_equal(chunk.buffer(), want)


@pytest.mark.parametrize("mode", MODES)
def test_jax_unpack_equals_port_unpack(chunks, mode):
    """The port's buffer through the JAX ``_get_unpack_model`` and through
    the port's ``_unpack_model``: every field equal, padding lanes and the
    cells beyond each lane's (la, lb) included."""
    chunk = chunks[mode]
    buf = chunk.buffer()
    nk = chunk.submat.shape[0]
    want = jax_driver._get_unpack_model(
        chunk.pad * chunk.pad, chunk.dcap, chunk.pad, chunk.pad, mode, nk)(
        jnp.asarray(buf), jnp.asarray(chunk.submat, jnp.float32))
    got = device_driver._unpack_model(torch.from_numpy(buf),
                                      torch.from_numpy(chunk.submat),
                                      chunk.pad, chunk.pad, chunk.dcap)
    for name, g, w in zip(device_solver.BatchModel._fields, got, want):
        assert g.is_contiguous(), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)


@pytest.mark.parametrize("mode", MODES)
def test_unpack_equals_raw_rows(chunks, mode):
    """The unpacked model equals ``_model_rows``' raw rows in every field
    but the seq-score grid, and there inside each lane's (la, lb): the
    rebuilt grid is the host's float32 scale-and-truncate, bit for bit."""
    chunk = chunks[mode]
    got = device_driver._unpack_model(
        torch.from_numpy(chunk.buffer()), torch.from_numpy(chunk.submat),
        chunk.pad, chunk.pad, chunk.dcap)
    raw = device_driver._model_rows(chunk.models, chunk.pad, chunk.pad,
                                    chunk.dcap, chunk.n)
    for name, g, w in zip(device_solver.BatchModel._fields, got, raw):
        if name != "seq_score":
            np.testing.assert_array_equal(g.numpy(), w, name)
    grid = got.seq_score.numpy().reshape(chunk.n, chunk.pad, chunk.pad)
    for k, m in enumerate(chunk.models):
        np.testing.assert_array_equal(grid[k, :m.la, :m.lb], m.seq_score)


@pytest.mark.parametrize("mode", MODES)
def test_packed_solve_equals_raw_solve(chunks, mode):
    """``solve_batch`` from the packed upload and from the raw rows gives
    the same result in every field (no result reads the padding cells,
    where the two models differ)."""
    chunk = chunks[mode]
    packed, scan_steps = device_driver._pack_models(
        chunk.models, chunk.params, chunk.pad, chunk.pad, CPU, chunk.dcap)
    raw = device_driver._upload_model(device_driver._model_rows(
        chunk.models, chunk.pad, chunk.pad, chunk.dcap, chunk.n), CPU)
    assert not torch.equal(packed.seq_score, raw.seq_score)
    p = chunk.params
    args = (int(p.gap_open_int), int(p.gap_extend_int),
            np.float32(p.step_size_factor), chunk.pad, chunk.pad,
            int(p.num_iterations), int(p.max_nondecr_iterations),
            int(p.matching))
    got = device_solver.solve_batch(packed, *args, scan_steps=scan_steps)
    want = device_solver.solve_batch(raw, *args, scan_steps=scan_steps)
    for name, g, w in zip(device_solver.BatchResult._fields, got, want):
        assert torch.equal(g, w), name


def test_active_words_round_trip_off_the_word_grid():
    """A grid whose cell count is no multiple of 32 (33x20): the last word
    is padded, and the unpack gives back every cell of the active mask."""
    rng = np.random.default_rng(5)
    submat = np.arange(25, dtype=np.int32).reshape(5, 5) * 37 - 400

    class Model:
        la, lb = 30, 17
        active = rng.random((30, 17)) < 0.4
        dual_l = dual_m = sscore = rev = qperm = np.zeros(0, np.int32)
        seq_a = rng.integers(0, 5, 30).astype(np.int32)
        seq_b = rng.integers(0, 5, 17).astype(np.int32)
        scale = 1.37
        seq_score = np.trunc(np.float32(scale) * submat[
            seq_a[:, None], seq_b[None, :]].astype(np.float32)).astype(
                np.int32)

    buf = device_driver._packed_buffer([Model], 33, 20, 512, 2, 5)
    got = device_driver._unpack_model(buf, torch.from_numpy(submat), 33, 20,
                                      512)
    raw = device_driver._model_rows([Model], 33, 20, 512, 2)
    for name, g, w in zip(device_solver.BatchModel._fields, got, raw):
        if name != "seq_score":
            np.testing.assert_array_equal(g.numpy(), w, name)
    np.testing.assert_array_equal(
        got.seq_score.numpy().reshape(2, 33, 20)[0, :30, :17],
        Model.seq_score)

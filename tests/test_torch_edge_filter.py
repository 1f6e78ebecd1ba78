"""K4, the port's edge filter, vs. the JAX package, on the CPU.

On the card the edge filter is two kernels: K4's sweep (K1's wavefront in a
prefix mode over each pair and over its reversed sequences,
``csrc/gotoh_dp.cu``) and K4's pack (``csrc/edge_filter.cu``).  Here, with
zero tolerance (every output is an integer), against
``lara_tpu.ops.gotoh.edge_filter_skewed_words`` (two XLA scans): the
wrapper ``gotoh_cuda.edge_filter_skewed_words`` on CPU tensors, the
composition of the two plain versions (``gotoh.edge_sweep`` then
``gotoh.edge_pack``), which is the kernels' decomposition, and a model of
the pack kernel's warp loop (its word, bit and (d, a) bookkeeping).  The
driver's ``_filter_and_build`` goes through the wrapper and builds the
models the JAX filter gives.  ``tests/test_torch_cuda.py`` holds the
kernels against the plain versions on a card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lara_tpu.ops import gotoh as jax_gotoh
from lara_tpu_torch.app import enumerate_pairs
from lara_tpu_torch.io.records import InputStorage
from lara_tpu_torch.ops import gotoh, gotoh_cuda
from lara_tpu_torch.params import Parameters
from lara_tpu_torch.solver import device_driver
from lara_tpu_torch.types import f2i

PARAMS = Parameters(in_file="<test>")
SUBMAT = np.asarray(PARAMS.score_matrix, np.int32)
GO, GE = int(PARAMS.gap_open_int), int(PARAMS.gap_extend_int)
SUBOPT = int(f2i(PARAMS.suboptimal_diff))
SUBOPTS = [0, SUBOPT, 10 * SUBOPT]

# (batch, la_max, lb_max, la, lb, seed): la_max not a multiple of 32 with
# la > lb, la < lb far apart, la_max = 1, a 1x1 lane, lanes of length 1 on
# either side, and rows of exactly 32 and 33
CASES = [
    (4, 37, 20, [37, 13, 1, 20], [20, 20, 7, 1], 1),
    (3, 12, 41, [12, 5, 1], [41, 30, 1], 2),
    (2, 1, 9, [1, 1], [9, 3], 3),
    (1, 1, 1, [1], [1], 4),
    (3, 33, 32, [33, 32, 1], [32, 1, 31], 5),
]


def _problem(case):
    """Rna5 residues in each lane, padded with 4 as the driver pads."""
    b, la_max, lb_max, la, lb, seed = case
    rng = np.random.default_rng(seed)
    la = np.asarray(la, np.int32)
    lb = np.asarray(lb, np.int32)
    seq_a = np.full((b, la_max), 4, np.int32)
    seq_b = np.full((b, lb_max), 4, np.int32)
    for k in range(b):
        seq_a[k, :la[k]] = rng.integers(0, 4, la[k])
        seq_b[k, :lb[k]] = rng.integers(0, 4, lb[k])
    return seq_a, seq_b, la, lb, la_max, lb_max


def _jax_words(seq_a, seq_b, la, lb, la_max, lb_max, subopt):
    return np.asarray(jax_gotoh.edge_filter_skewed_words(
        seq_a, seq_b, la, lb, SUBMAT, GO, GE, subopt, la_max, lb_max))


def _torch(*arrays):
    return tuple(torch.from_numpy(x) for x in arrays)


@pytest.mark.parametrize("subopt", SUBOPTS)
@pytest.mark.parametrize("case", CASES)
def test_wrapper_matches_jax(case, subopt):
    seq_a, seq_b, la, lb, la_max, lb_max = _problem(case)
    want = _jax_words(seq_a, seq_b, la, lb, la_max, lb_max, subopt)
    got = gotoh_cuda.edge_filter_skewed_words(
        *_torch(seq_a, seq_b, la, lb, SUBMAT), GO, GE, subopt, la_max,
        lb_max)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("subopt", SUBOPTS)
@pytest.mark.parametrize("case", CASES)
def test_sweep_then_pack_matches_jax(case, subopt):
    """The kernels' decomposition: the forward prefix over the forward and
    the per-lane reversed grids, then the threshold and the bit pack."""
    seq_a, seq_b, la, lb, la_max, lb_max = _problem(case)
    want = _jax_words(seq_a, seq_b, la, lb, la_max, lb_max, subopt)
    inputs = _torch(seq_a, seq_b, la, lb, SUBMAT)
    prefix, finals = gotoh.edge_sweep(*inputs, GO, GE)
    assert prefix.shape == (2 * len(la), la_max + lb_max + 1, la_max + 1)
    assert finals.shape == (3, 2 * len(la))
    got = gotoh.edge_pack(prefix, finals, *inputs, subopt)
    np.testing.assert_array_equal(got.numpy(), want)
    # both halves reach the same optimum (edge_filter.hpp:141)
    np.testing.assert_array_equal(finals.max(0).values[:len(la)],
                                  finals.max(0).values[len(la):])


@pytest.mark.parametrize("case", CASES)
def test_sweep_forward_half_is_the_prefix_scan(case):
    """Lanes 0..B-1 of the sweep are the JAX package's prefix scan over
    the forward grid, on every cell inside the lanes' rectangles."""
    seq_a, seq_b, la, lb, la_max, lb_max = _problem(case)
    skewed = jax_gotoh.skew_scores(
        jax_gotoh._sub_grid(SUBMAT, seq_a, seq_b), jax_gotoh.NEG_INF)
    ref = jax_gotoh.gotoh_scan(skewed, la, lb, GO, GE, la_max, emit="prefix")
    prefix, finals = gotoh.edge_sweep(*_torch(seq_a, seq_b, la, lb, SUBMAT),
                                      GO, GE)
    b = len(la)
    np.testing.assert_array_equal(
        finals[:, :b].numpy(),
        np.stack([np.asarray(ref.final_m), np.asarray(ref.final_h),
                  np.asarray(ref.final_v)]))
    aux = np.asarray(ref.aux)
    for k in range(b):
        for i in range(la[k] + 1):
            for j in range(lb[k] + 1):
                assert prefix[k, i + j, i] == aux[i + j, k, i], (k, i, j)


@pytest.mark.parametrize("case", CASES)
def test_pack_reads_only_the_rectangles(case):
    """The sweep kernel writes the cells inside the lanes' rectangles only;
    the pack must give the same words whatever the others hold."""
    seq_a, seq_b, la, lb, la_max, lb_max = _problem(case)
    inputs = _torch(seq_a, seq_b, la, lb, SUBMAT)
    prefix, finals = gotoh.edge_sweep(*inputs, GO, GE)
    want = gotoh.edge_pack(prefix, finals, *inputs, SUBOPT)
    b = len(la)
    d_idx = torch.arange(la_max + lb_max + 1)[None, :, None]
    i_idx = torch.arange(la_max + 1)[None, None, :]
    la2, lb2 = (torch.from_numpy(np.concatenate([x, x]))[:, None, None]
                for x in (la, lb))
    inside = (i_idx <= la2) & (d_idx >= i_idx) & (d_idx - i_idx <= lb2)
    rng = np.random.default_rng(case[-1])
    junk = torch.from_numpy(rng.integers(-2**31, 2**31, prefix.shape,
                                         dtype=np.int64).astype(np.int32))
    got = gotoh.edge_pack(torch.where(inside, prefix, junk), finals,
                          *inputs, SUBOPT)
    assert inside[:b].sum() == sum((la + 1) * (lb + 1))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _wrap(x):
    return (x + 2**31) % 2**32 - 2**31


def _pack_model(prefix, finals, seq_a, seq_b, la_arr, lb_arr, subopt):
    """``edge_pack_kernel`` (``csrc/edge_filter.cu``) warp by warp, its 32
    lanes as numpy vectors: warp n packs words 32n .. 32n+31, lane t bit t
    of each, walking its flat index as (d, a) 32 cells at a time."""
    pairs, la_max = seq_a.shape
    lb_max = seq_b.shape[1]
    width, num_diag = la_max + 1, la_max + lb_max + 1
    n_words = -(-num_diag * width // 32)
    lane = np.arange(32)
    sub_entry = np.zeros(32, np.int64)
    sub_entry[:25] = SUBMAT.reshape(-1)
    flat_prefix = prefix.reshape(2 * pairs, -1).astype(np.int64)
    out = np.full((pairs, n_words + 1), -7, np.int64)
    for p in range(pairs):
        la, lb = int(la_arr[p]), int(lb_arr[p])
        opt = int(finals[:, p].max())
        cut = _wrap(opt - subopt)
        for word0 in range(0, n_words + 1, 32):
            d, a = divmod(32 * word0 + lane, width)
            mine = np.zeros(32, np.int64)
            for w in range(32):
                b = d - a
                edge = (a < la) & (b >= 0) & (b < lb)
                ca = np.where(edge, seq_a[p, np.where(edge, a, 0)], 0)
                cb = np.where(edge, seq_b[p, np.where(edge, b, 0)], 0)
                fwd = flat_prefix[p, np.where(edge, d * width + a, 0)]
                bwd = flat_prefix[pairs + p, np.where(
                    edge, (la + lb - 2 - d) * width + la - 1 - a, 0)]
                total = np.where(edge, _wrap(fwd + bwd), 0)
                bit = edge & (_wrap(total + sub_entry[5 * ca + cb]) >= cut)
                mine[w] = _wrap(int((bit.astype(np.int64) << lane).sum()))
                a = a + 32
                while (a >= width).any():
                    d = np.where(a >= width, d + 1, d)
                    a = np.where(a >= width, a - width, a)
            for t, k in enumerate(word0 + lane):
                if k < n_words:
                    out[p, k] = mine[t]
                elif k == n_words:
                    out[p, k] = opt
    return out


@pytest.mark.parametrize("subopt", [0, SUBOPT])
@pytest.mark.parametrize("case", CASES)
def test_pack_kernel_model_matches_jax(case, subopt):
    seq_a, seq_b, la, lb, la_max, lb_max = _problem(case)
    prefix, finals = gotoh.edge_sweep(*_torch(seq_a, seq_b, la, lb, SUBMAT),
                                      GO, GE)
    got = _pack_model(prefix.numpy(), finals.numpy(), seq_a, seq_b, la, lb,
                      subopt)
    np.testing.assert_array_equal(
        got, _jax_words(seq_a, seq_b, la, lb, la_max, lb_max, subopt))


def _write_family(tmp_path, kind):
    """Two small families: related hairpins with ragged lengths, and three
    records whose structures conflict."""
    path = tmp_path / f"{kind}.dbn"
    if kind == "conflicting":
        path.write_text(
            ">x\nGGGAAAGGGAAACCCAAACCC\n(((...(((...)))...)))\n"
            ">y\nGGGAAAGGGAAACCCAAACCC\n(((...)))...(((...)))\n"
            ">z\nGGGAAAGGGAAACCCAAACC\n((....((....))....))\n")
    else:
        path.write_text(
            ">a\nGGGCGCAAGCCUUAAGGCGCCC\n(((((((......)))))))..\n"
            ">b\nGGGCGCAAGCAUUAAGGCGC\n(((((((......)))))))\n"
            ">c\nGGGAGCAAGCCUUAAGGCUCCCAA\n(((((((......)))))))....\n"
            ">d\nGCGCAAGCCUUAAGGCGC\n.(((((......))))).\n")
    return str(path)


@pytest.mark.parametrize("kind", ["hairpins", "conflicting"])
def test_filter_and_build_calls_the_wrapper(kind, tmp_path, monkeypatch):
    """``_filter_and_build`` (every path's edge filter) calls
    ``gotoh_cuda.edge_filter_skewed_words`` once for the chunk, and builds
    the models that the JAX package's filter gives."""
    path = _write_family(tmp_path, kind)
    store = InputStorage(in_file=path)
    params = Parameters(in_file=path)
    pairs = enumerate_pairs(store)
    cpu = torch.device("cpu")
    wrapper = gotoh_cuda.edge_filter_skewed_words
    calls = []

    def spy(seq_a, seq_b, *rest):
        calls.append((tuple(seq_a.shape), tuple(seq_b.shape), rest[-2:]))
        return wrapper(seq_a, seq_b, *rest)

    monkeypatch.setattr(gotoh_cuda, "edge_filter_skewed_words", spy)
    models, las = device_driver._filter_and_build(store, pairs, params, 32,
                                                  32, cpu)
    assert calls == [((len(pairs), 32), (len(pairs), 32), (32, 32))]

    def jax_filter(seq_a, seq_b, la, lb, submat, go, ge, subopt, la_max,
                   lb_max):
        return torch.from_numpy(np.array(jax_gotoh.edge_filter_skewed_words(
            seq_a.numpy(), seq_b.numpy(), la.numpy(), lb.numpy(),
            submat.numpy(), go, ge, subopt, la_max, lb_max)))

    monkeypatch.setattr(gotoh_cuda, "edge_filter_skewed_words", jax_filter)
    want, want_las = device_driver._filter_and_build(store, pairs, params,
                                                     32, 32, cpu)
    np.testing.assert_array_equal(las, want_las)
    assert len(models) == len(want) == len(pairs)
    for got_model, want_model in zip(models, want):
        for field in dataclasses.fields(got_model):
            np.testing.assert_array_equal(
                getattr(got_model, field.name),
                getattr(want_model, field.name), field.name)
        # gathered on first read, so not among the dataclass's fields
        np.testing.assert_array_equal(got_model.seq_score,
                                      want_model.seq_score, "seq_score")
    assert any(m.active.any() for m in models)

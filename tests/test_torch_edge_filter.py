"""K4, the port's edge filter, vs. the JAX package, on the CPU.

On the card the edge filter is two kernels: K4's sweep (K1's wavefront in a
prefix mode over each pair and over its reversed sequences,
``csrc/gotoh_dp.cu``) and K4's pack (``csrc/edge_filter.cu``), which writes
the active grid as row-major words (bit a * lb_max + b of a lane, then the
lane's optimum).  Here, with zero tolerance (every output is an integer),
against the grid the JAX driver builds its models from,
``lara_tpu.ops.gotoh.unskew_active_words(edge_filter_skewed_words(...))``,
read row-major: the wrapper ``gotoh_cuda.edge_filter_active_words`` on CPU
tensors, the composition of the two plain versions (``gotoh.edge_sweep``
then ``gotoh.edge_pack``), which is the kernels' decomposition, and a
model of the pack kernel's bands, warps and word assembly.  The driver's
``_filter_and_build`` goes through the wrapper, hands the build the
unpacked words in place and builds the models the JAX filter gives.
``tests/test_torch_cuda.py`` holds the kernels against the plain versions
on a card.
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
from lara_tpu_torch.solver import device_driver, interactions
from lara_tpu_torch.types import f2i
from lara_tpu_torch.utils import timing

PARAMS = Parameters(in_file="<test>")
SUBMAT = np.asarray(PARAMS.score_matrix, np.int32)
GO, GE = int(PARAMS.gap_open_int), int(PARAMS.gap_extend_int)
SUBOPT = int(f2i(PARAMS.suboptimal_diff))
SUBOPTS = [0, SUBOPT, 10 * SUBOPT]

# (batch, la_max, lb_max, la, lb, seed): la_max not a multiple of 32 with
# la > lb, la < lb far apart, la_max = 1, a 1x1 lane, lanes of length 1 on
# either side, and rows of exactly 32 and 33; then three bands of rows
# whose words straddle rows (lb_max % 32 and la_max * lb_max % 32 not 0,
# so the last word has padding), and rows of five column words, more than
# the pack kernel's warps
CASES = [
    (4, 37, 20, [37, 13, 1, 20], [20, 20, 7, 1], 1),
    (3, 12, 41, [12, 5, 1], [41, 30, 1], 2),
    (2, 1, 9, [1, 1], [9, 3], 3),
    (1, 1, 1, [1], [1], 4),
    (3, 33, 32, [33, 32, 1], [32, 1, 31], 5),
    (3, 70, 45, [70, 64, 33], [45, 40, 1], 6),
    (2, 40, 150, [40, 21], [150, 133], 7),
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


def _row_major_words(active, opt):
    """[B, LA, LB] bool and [B] -> ``[B, nw+1]`` int32: the grid as
    little-endian words, bit a * LB + b (``device_driver._packed_buffer``'s
    packing), then opt."""
    b, la_max, lb_max = active.shape
    nw = -(-la_max * lb_max // 32)
    octets = np.zeros((b, 4 * nw), np.uint8)
    octets[:, :-(-la_max * lb_max // 8)] = np.packbits(
        active.reshape(b, -1), axis=1, bitorder="little")
    return np.concatenate([octets.view("<u4").view(np.int32),
                           np.asarray(opt, np.int32)[:, None]], axis=1)


def _jax_grid(seq_a, seq_b, la, lb, la_max, lb_max, subopt):
    """(active [B, LA, LB], opt): what the JAX driver builds from."""
    active, opt = jax_gotoh.unskew_active_words(np.asarray(
        jax_gotoh.edge_filter_skewed_words(seq_a, seq_b, la, lb, SUBMAT, GO,
                                           GE, subopt, la_max, lb_max)),
        la_max, lb_max)
    return np.asarray(active), np.asarray(opt)


def _jax_words(seq_a, seq_b, la, lb, la_max, lb_max, subopt):
    return _row_major_words(*_jax_grid(seq_a, seq_b, la, lb, la_max, lb_max,
                                       subopt))


def _hold_to_jax(words, case, subopt):
    """``words`` are the JAX grid's row-major words, and unpack to it."""
    seq_a, seq_b, la, lb, la_max, lb_max = _problem(case)
    want_active, want_opt = _jax_grid(seq_a, seq_b, la, lb, la_max, lb_max,
                                      subopt)
    np.testing.assert_array_equal(
        words, _row_major_words(want_active, want_opt))
    active, opt = gotoh.unpack_active_words(words, la_max, lb_max)
    np.testing.assert_array_equal(active, want_active)
    np.testing.assert_array_equal(opt, want_opt)


def _torch(*arrays):
    return tuple(torch.from_numpy(x) for x in arrays)


@pytest.mark.parametrize("subopt", SUBOPTS)
@pytest.mark.parametrize("case", CASES)
def test_wrapper_matches_jax(case, subopt):
    seq_a, seq_b, la, lb, la_max, lb_max = _problem(case)
    got = gotoh_cuda.edge_filter_active_words(
        *_torch(seq_a, seq_b, la, lb, SUBMAT), GO, GE, subopt, la_max,
        lb_max)
    assert got.dtype == torch.int32
    assert got.shape == (len(la), -(-la_max * lb_max // 32) + 1)
    _hold_to_jax(got.numpy(), case, subopt)


@pytest.mark.parametrize("subopt", SUBOPTS)
@pytest.mark.parametrize("case", CASES)
def test_sweep_then_pack_matches_jax(case, subopt):
    """The kernels' decomposition: the forward prefix over the forward and
    the per-lane reversed grids, then the threshold and the bit pack."""
    seq_a, seq_b, la, lb, la_max, lb_max = _problem(case)
    inputs = _torch(seq_a, seq_b, la, lb, SUBMAT)
    prefix, finals = gotoh.edge_sweep(*inputs, GO, GE)
    assert prefix.shape == (2 * len(la), la_max + lb_max + 1, la_max + 1)
    assert finals.shape == (3, 2 * len(la))
    got = gotoh.edge_pack(prefix, finals, *inputs, subopt)
    _hold_to_jax(got.numpy(), case, subopt)
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
    # the kernel's model too: its bands read nothing else either
    np.testing.assert_array_equal(
        _pack_model(torch.where(inside, prefix, junk).numpy(),
                    finals.numpy(), seq_a, seq_b, la, lb, SUBOPT),
        want.numpy())


def _wrap(x):
    return (x + 2**31) % 2**32 - 2**31


#: the pack kernel's constants (``csrc/edge_filter.cu``)
PACK_WARPS, BAND = 4, 32


def _pack_model(prefix, finals, seq_a, seq_b, la_arr, lb_arr, subopt):
    """``edge_pack_kernel`` (``csrc/edge_filter.cu``) CTA by CTA and warp
    by warp, a warp's 32 lanes as numpy vectors: CTA (x, p) takes rows
    32x .. 32x+31 of pair p; warp v sweeps its run of whole column words
    [c0, c1) as a parallelogram, lane t at step s on row 32x + t and
    column c0 + s - t (one diagonal a step), gathering its row's bits into
    32-column words of a shared [32, n_col_words + 1] bit matrix; then
    each thread cuts row-major word i of the band out of that matrix by
    funnel shifts, row after row."""
    pairs, la_max = seq_a.shape
    lb_max = seq_b.shape[1]
    width = la_max + 1
    n_words = -(-la_max * lb_max // 32)
    n_col_words = -(-lb_max // 32)
    per_warp = -(-n_col_words // PACK_WARPS)
    lane = np.arange(32)
    sub_entry = np.zeros(32, np.int64)
    sub_entry[:25] = SUBMAT.reshape(-1)
    flat_prefix = prefix.reshape(2 * pairs, -1).astype(np.int64)
    out = np.full((pairs, n_words + 1), -7, np.int64)
    for p in range(pairs):
        la, lb = int(la_arr[p]), int(lb_arr[p])
        opt = int(finals[:, p].max())
        cut = _wrap(opt - subopt)
        for x in range(-(-la_max // BAND)):
            a0 = BAND * x
            band = np.zeros((BAND, n_col_words + 1), np.uint64)
            for v in range(PACK_WARPS):
                c0 = 32 * per_warp * v
                c1 = min(c0 + 32 * per_warp, lb)
                if not (a0 < la and c0 < c1):
                    continue
                a = a0 + lane
                row = a < la
                ca = np.where(row, seq_a[p, np.minimum(a, la_max - 1)], 0)
                bits = np.zeros(32, np.uint64)
                for s in range(c1 - c0 + 31):
                    b = c0 + s - lane
                    d = a0 + c0 + s
                    edge = row & (b >= c0) & (b < c1)
                    cb = np.where(edge, seq_b[p, np.where(edge, b, 0)], 0)
                    fwd = flat_prefix[p, np.where(edge, d * width + a, 0)]
                    bwd = flat_prefix[pairs + p, np.where(
                        edge, (la + lb - 2 - d) * width + la - 1 - a, 0)]
                    total = np.where(edge, _wrap(fwd + bwd), 0)
                    bit = edge & (_wrap(total + sub_entry[5 * ca + cb])
                                  >= cut)
                    bits |= bit.astype(np.uint64) << (np.where(edge, b, 0)
                                                      % 32).astype(np.uint64)
                    flush = edge & ((b % 32 == 31) | (b == c1 - 1))
                    band[lane[flush], b[flush] // 32] = bits[flush]
                    bits[flush] = 0
            word0 = x * lb_max
            for i in range(min(lb_max, n_words - word0)):
                r, b = divmod(32 * i, lb_max)
                word = filled = 0
                while filled < 32 and r < BAND:
                    n = min(32 - filled, lb_max - b)
                    shift = b % 32
                    got = int(band[r, b // 32]) >> shift
                    if shift:
                        got |= (int(band[r, b // 32 + 1]) << (32 - shift)) \
                            & 0xFFFFFFFF
                    word |= (got & ((1 << n) - 1)) << filled
                    filled += n
                    r, b = r + 1, 0
                out[p, word0 + i] = _wrap(word)
        out[p, n_words] = opt
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
    ``gotoh_cuda.edge_filter_active_words`` once for the chunk, and builds
    the models that the JAX package's filter gives."""
    path = _write_family(tmp_path, kind)
    store = InputStorage(in_file=path)
    params = Parameters(in_file=path)
    pairs = enumerate_pairs(store)
    cpu = torch.device("cpu")
    wrapper = gotoh_cuda.edge_filter_active_words
    calls = []

    def spy(*args):
        calls.append(args)
        return wrapper(*args)

    monkeypatch.setattr(gotoh_cuda, "edge_filter_active_words", spy)
    models, las = device_driver._filter_and_build(store, pairs, params, 32,
                                                  32, cpu)
    assert [(tuple(c[0].shape), tuple(c[1].shape), c[-2:]) for c in calls] \
        == [((len(pairs), 32), (len(pairs), 32), (32, 32))]

    # the JAX driver's grid from the same inputs, and the models the
    # build gives from it (the build's input before row-major words)
    seq_a, seq_b, la, lb, submat = (x.numpy() for x in calls[0][:5])
    go, ge, subopt = calls[0][5:8]
    want_active, want_opt = jax_gotoh.unskew_active_words(np.asarray(
        jax_gotoh.edge_filter_skewed_words(seq_a, seq_b, la, lb, submat, go,
                                           ge, subopt, 32, 32)), 32, 32)
    want = interactions.build_chunk(
        [(store[ia], store[ib]) for ia, ib in pairs], params,
        np.ascontiguousarray(want_active), np.asarray(want_opt), 1)
    np.testing.assert_array_equal(las, la)
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


@pytest.mark.parametrize("kind", ["hairpins", "conflicting"])
def test_build_reads_the_unpacked_words_in_place(kind, tmp_path,
                                                 monkeypatch):
    """The grid ``_filter_and_build`` hands ``interactions.build_chunk`` is
    the host's unpack of K4's words itself, a contiguous ``[B, LA, LB]``
    view (no strided copy), equal to the JAX driver's grid; the words are
    the active section of the chunk's packed upload; "edge filter: unskew
    (host)" is booked once for the chunk."""
    path = _write_family(tmp_path, kind)
    store = InputStorage(in_file=path)
    params = Parameters(in_file=path)
    pairs = enumerate_pairs(store)
    words, unpacked, built = [], [], []
    wrapper = gotoh_cuda.edge_filter_active_words
    unpack = gotoh.unpack_active_words
    build = interactions.build_chunk

    def filter_spy(*args):
        words.append((args, wrapper(*args)))
        return words[-1][1]

    def unpack_spy(*args):
        unpacked.append(unpack(*args))
        return unpacked[-1]

    def build_spy(chunk, params, active, opt, workers):
        built.append((active, opt))
        return build(chunk, params, active, opt, workers)

    monkeypatch.setattr(gotoh_cuda, "edge_filter_active_words", filter_spy)
    monkeypatch.setattr(gotoh, "unpack_active_words", unpack_spy)
    monkeypatch.setattr(interactions, "build_chunk", build_spy)
    timing.reset()
    models, _ = device_driver._filter_and_build(store, pairs, params, 40, 37,
                                                torch.device("cpu"))
    counts = dict(timing._COUNTS)
    assert counts["edge filter: unskew (host)"] == 1
    assert counts["edge filter (device)"] == 1
    assert len(words) == len(unpacked) == len(built) == 1
    (active, opt), = built
    assert active is unpacked[0][0] and opt is unpacked[0][1]
    b = len(pairs)
    assert active.shape == (b, 40, 37) and active.dtype == bool
    assert active.strides == (40 * 37, 37, 1)
    assert not active.flags.owndata     # a view of the unpacked bits
    args, got_words = words[0]
    seq_a, seq_b, la, lb, submat = (x.numpy() for x in args[:5])
    want_active, want_opt = jax_gotoh.unskew_active_words(np.asarray(
        jax_gotoh.edge_filter_skewed_words(seq_a, seq_b, la, lb, submat,
                                           *args[5:])), 40, 37)
    np.testing.assert_array_equal(active, want_active)
    np.testing.assert_array_equal(opt, want_opt)
    assert active.any()
    # word for word the active section of the chunk's one-device upload
    nw = -(-40 * 37 // 32)
    buf = device_driver._packed_buffer(models, 40, 37,
                                       device_driver._chunk_dcap(models), b,
                                       len(params.score_matrix))
    np.testing.assert_array_equal(buf.numpy()[:, :nw],
                                  got_words.numpy()[:, :nw])

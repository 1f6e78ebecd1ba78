"""The PyTorch port's DP, traceback and edge filter vs. the JAX package.

On the CPU the port's wrappers (``lara_tpu_torch.ops.gotoh_cuda``) run the
plain torch versions of K1 and K2; they are held here, with zero tolerance
(every output is an integer), against ``lara_tpu.ops.gotoh`` (XLA) and the
Pallas kernels in interpret mode.  ``tests/test_torch_cuda.py`` holds the
kernels against the plain versions on a card.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lara_tpu.ops import gotoh as jax_gotoh
from lara_tpu.ops.gotoh_pallas import align_pssm_batch_pallas
from lara_tpu.types import PSSM_INIT, f2i
from lara_tpu_torch.ops import gotoh, gotoh_cuda, gotoh_plan
from lara_tpu_torch.params import Parameters

GO, GE = -49152, -16384

# (batch, la_max, lb_max, la, lb, seed): the tests/test_gotoh_pallas.py shape
# plus ragged random ones with la or lb of 1 and PSSM_INIT cells
CASES = [
    (4, 12, 10, [12, 7, 12, 2], [10, 9, 1, 2], 3),
    (5, 17, 23, [17, 1, 9, 16, 3], [23, 20, 1, 11, 23], 7),
    (3, 32, 32, [32, 30, 5], [31, 32, 29], 11),
]


def _problem(case):
    b, la_max, lb_max, la, lb, seed = case
    rng = np.random.default_rng(seed)
    pssm = rng.integers(-9000, 9000, (b, la_max, lb_max), dtype=np.int32)
    # the solver masks inactive cells with PSSM_INIT
    pssm[rng.random(pssm.shape) < 0.2] = PSSM_INIT
    seq = rng.integers(-5000, 5000, (b, la_max, lb_max), dtype=np.int32)
    return (pssm, np.asarray(la, np.int32), np.asarray(lb, np.int32), seq,
            la_max, lb_max)


def _port_align(pssm, la, lb, seq, la_max, lb_max):
    t = torch.from_numpy
    out = gotoh_cuda.align_pssm_batch(t(pssm), t(la), t(lb), GO, GE, la_max,
                                      lb_max, t(seq))
    return gotoh.Traceback(*(x.numpy() for x in out))


@pytest.mark.parametrize("case", CASES)
def test_align_matches_xla(case):
    pssm, la, lb, seq, la_max, lb_max = _problem(case)
    ref = jax_gotoh.align_pssm_batch(jnp.asarray(pssm), jnp.asarray(la),
                                     jnp.asarray(lb), GO, GE, la_max, lb_max)
    got = _port_align(pssm, la, lb, seq, la_max, lb_max)
    np.testing.assert_array_equal(got.upper, np.asarray(ref.upper))
    np.testing.assert_array_equal(got.partner, np.asarray(ref.partner))
    np.testing.assert_array_equal(got.n_lines, np.asarray(ref.n_lines))
    np.testing.assert_array_equal(got.gap_score, np.asarray(ref.gap_score))
    pmask = got.partner[:, :, None] == np.arange(lb_max)[None, None, :]
    want_seq = np.sum(np.where(pmask, seq, 0), axis=(1, 2))
    np.testing.assert_array_equal(got.seq_part, want_seq)


@pytest.mark.parametrize("case", CASES)
def test_align_matches_pallas_interpret(case):
    pssm, la, lb, seq, la_max, lb_max = _problem(case)
    pal = align_pssm_batch_pallas(
        jnp.asarray(pssm), jnp.asarray(la), jnp.asarray(lb), GO, GE, la_max,
        lb_max, block_b=8, interpret=True, emit_lines=False,
        seq_scores=jnp.asarray(seq))
    got = _port_align(pssm, la, lb, seq, la_max, lb_max)
    for field in gotoh.Traceback._fields:
        np.testing.assert_array_equal(getattr(got, field),
                                      np.asarray(getattr(pal, field)), field)


@pytest.mark.parametrize("case", CASES)
def test_dirs_match_gotoh_scan_on_valid_cells(case):
    pssm, la, lb, _seq, la_max, lb_max = _problem(case)
    skewed = jax_gotoh.skew_scores(jnp.asarray(pssm), jax_gotoh.NEG_INF)
    ref = jax_gotoh.gotoh_scan(skewed, jnp.asarray(la), jnp.asarray(lb), GO,
                               GE, la_max, emit="dirs")
    dirs, finals = gotoh_cuda.dp_forward(
        torch.from_numpy(pssm), torch.from_numpy(la), torch.from_numpy(lb),
        GO, GE)
    assert dirs.shape == (len(la), la_max + lb_max + 1, la_max + 1)
    assert dirs.dtype == torch.int8
    np.testing.assert_array_equal(
        finals.numpy(),
        np.stack([np.asarray(ref.final_m), np.asarray(ref.final_h),
                  np.asarray(ref.final_v)]))
    d_ref = np.asarray(ref.aux).astype(np.int32)
    d_got = dirs.numpy().astype(np.int32)
    for k in range(len(la)):
        for d in range(la[k] + lb[k] + 1):
            for i in range(min(d, la[k]) + 1):
                if d - i <= lb[k]:
                    assert d_got[k, d, i] == d_ref[d, k, i], (k, d, i)


@pytest.mark.parametrize("seed", range(3))
def test_edge_filter_matches_jax(seed):
    rng = np.random.default_rng(40 + seed)
    params = Parameters(in_file="<test>")
    b, la_max, lb_max = 4, 24, 20
    la = np.array([24, 13, 1, 20], np.int32)
    lb = np.array([20, 20, 7, 1], np.int32)
    seq_a = np.full((b, la_max), 4, np.int32)
    seq_b = np.full((b, lb_max), 4, np.int32)
    for k in range(b):
        seq_a[k, :la[k]] = rng.integers(0, 4, la[k])
        seq_b[k, :lb[k]] = rng.integers(0, 4, lb[k])
    submat = np.asarray(params.score_matrix, np.int32)
    go, ge = int(params.gap_open_int), int(params.gap_extend_int)
    subopt = int(f2i(params.suboptimal_diff))
    want = np.asarray(jax_gotoh.edge_filter_skewed_words(
        seq_a, seq_b, la, lb, submat, go, ge, subopt, la_max, lb_max))
    got = gotoh.edge_filter_active_words(
        torch.from_numpy(seq_a), torch.from_numpy(seq_b),
        torch.from_numpy(la), torch.from_numpy(lb),
        torch.from_numpy(submat), go, ge, subopt, la_max,
        lb_max).numpy()
    assert got.shape == (b, -(-la_max * lb_max // 32) + 1)
    active, opt = gotoh.unpack_active_words(got, la_max, lb_max)
    want_active, want_opt = jax_gotoh.unskew_active_words(want, la_max,
                                                          lb_max)
    np.testing.assert_array_equal(active, want_active)
    np.testing.assert_array_equal(opt, want_opt)
    assert active.any()


@pytest.mark.parametrize("go,ge", [(GO, GE), (5, 3), (0, 0), (-3, 7),
                                   (100000, -1)])
def test_border_codes_match_plain_sweep(go, ge):
    """K1 takes the M and H codes of the left border cells (i, 0) from
    ``gotoh_cuda.border_codes`` instead of sweeping the cells left of
    column 0; they equal the plain sweep's for every i, whatever the gap
    scores (the wrap of NEG_INF sums included)."""
    rng = np.random.default_rng(go & 0xffff)
    la_max, lb_max = 70, 9
    pssm = torch.from_numpy(
        rng.integers(-9000, 9000, (3, la_max, lb_max)).astype(np.int32))
    la = torch.tensor([la_max, 1, 33], dtype=torch.int32)
    lb = torch.tensor([lb_max, 4, 1], dtype=torch.int32)
    dirs, _ = gotoh.dp_forward(pssm, la, lb, go, ge)
    codes = gotoh_cuda.border_codes(go, ge, la_max + 1)
    for k in range(3):
        i = torch.arange(int(la[k]) + 1)
        np.testing.assert_array_equal(dirs[k, i, i].numpy() & 15,
                                      codes[:int(la[k]) + 1])


def _k1_constants():
    """kMaxWarps, kRing and kSub as ``csrc/gotoh_dp.cu`` defines them."""
    path = os.path.join(os.path.dirname(gotoh_cuda.__file__), os.pardir,
                        "csrc", "gotoh_dp.cu")
    with open(path) as handle:
        src = handle.read()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", src)
                     .group(1)) for name in ("kMaxWarps", "kRing", "kSub"))


def _strip_schedule_finishes(la, lb, cluster):
    """A model of K1's strip schedule on one pair of la x lb: warp g of the
    pair's P takes strips g, g + P, ...; a block of kSub steps of strip k
    runs once strip k-1 has put the up cells it reads (lane 31 puts column
    s - 31 after the block holding step s) and strip k+1 has consumed
    enough of the ring for the cells it puts.  True if every strip ends."""
    max_warps, ring, sub = _k1_constants()
    strips = (la + 32) // 32
    p = cluster * min(max_warps, -(-strips // cluster))
    ncol, nblocks = lb + 1, -(-(lb + 32) // sub)
    done = [0] * strips                  # blocks run
    put = [-1] * strips                  # last column put
    consumed = [0] * p                   # the count each producer warp reads
    moved = True
    while moved:
        moved = False
        for k in range(strips):
            if k >= p and done[k - p] < nblocks:
                continue                 # its warp still runs strip k - p
            while done[k] < nblocks:
                s0 = done[k] * sub
                take = k > 0 and s0 <= lb
                if take and put[k - 1] < min(s0 + sub - 1, lb):
                    break
                out_last = min(s0 + sub - 1 - 31, lb)
                if k + 1 < strips and out_last >= 0 and \
                        consumed[k % p] < k // p * ncol + out_last + 1 - ring:
                    break
                done[k] += 1
                moved = True
                if k + 1 < strips and out_last >= 0:
                    put[k] = out_last
                if take:
                    consumed[(k - 1) % p] = (k - 1) // p * ncol + min(
                        s0 + sub, ncol)
    return all(d == nblocks for d in done)


def test_k1_constants_match_the_source():
    assert _k1_constants() == (gotoh_plan.K1_MAX_WARPS, gotoh_plan.K1_RING,
                               gotoh_plan.K1_SUB)


def _never_asked(cluster):
    raise AssertionError(f"asked for clusters of {cluster}")


def _seats(limit_above_8, limit=132):
    """Clusters a card seats at once: ``limit`` up to 8 CTAs, else
    ``limit_above_8``."""
    return lambda c: limit if c <= 8 else limit_above_8


# (b, SMs, clusters seated, la_max, lb_max, CTAs per pair): the 16S chunk,
# its K4 sweep (56 and 64 lanes) and the tRNA chunk and sweep keep 4, 2, 1
# and 1 without asking what the card seats; a lone 16S pair and its sweep
# (2 lanes) spread to 16, on an H100 PCIe's 114 SMs too, where B=32 takes
# 3 and B=8 14; where the card seats fewer clusters than B at a size, the
# next size down; pairs of 3 or 4 strips keep the 4 of a full card; the
# stalling 600 x 1800 steps up from 1 CTA as before, and spreads at B=2
CHOOSER = [
    (1, 132, _seats(1), 1536, 1536, 16),
    (2, 132, _seats(2), 1536, 1536, 16),
    (32, 132, _never_asked, 1536, 1536, 4),
    (56, 132, _never_asked, 1536, 1536, 2),
    (64, 132, _never_asked, 1536, 1536, 2),
    (128, 132, _never_asked, 96, 96, 1),
    (256, 132, _never_asked, 96, 96, 1),
    (1, 114, _seats(1), 1536, 1536, 16),
    (32, 114, _never_asked, 1536, 1536, 3),
    (8, 114, _seats(8), 1536, 1536, 14),
    (8, 132, _seats(7), 1536, 1536, 8),
    (8, 132, _seats(7, 7), 1536, 1536, 4),
    (1, 132, _seats(0), 1536, 1536, 8),
    (4, 132, lambda c: 4 if c <= 12 else 3, 1536, 1536, 12),
    (1, 132, _never_asked, 96, 96, 4),
    (1, 132, _never_asked, 64, 64, 4),
    (2, 132, _seats(2), 600, 1800, 16),
    (40, 132, _never_asked, 600, 1800, 3),
    (128, 132, _never_asked, 600, 1800, 2),
]


@pytest.mark.parametrize("b,sms,resident,la_max,lb_max,want", CHOOSER)
def test_k1_cluster_choice(b, sms, resident, la_max, lb_max, want):
    """K1's CTAs per pair as a function of the batch, the card's SMs and
    the clusters it seats at once: what fills the card up to 4, spread up
    to 16 only where the batch leaves SMs idle and the card seats every
    pair's cluster at once, and a schedule that finishes."""
    got = gotoh_cuda.choose_cluster(b, sms, resident, la_max, lb_max)
    assert got == want
    assert gotoh_cuda.ring_safe(la_max, lb_max, got)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_k1_ring_safe_shapes_finish(cluster):
    """Every shape that ``ring_safe`` admits (and the launcher then runs)
    finishes in the model of K1's strip schedule, up to the longest row it
    admits; with more strips than warps, a row 4 cells per warp past that
    still finishes, and 8 more stall the model: the hang the launcher
    refuses.  Up to 2900 rows have more strips than warps on up to 4 CTAs
    per pair; on 8 and 16 every strip has a warp of its own, so no row
    length stalls."""
    stalls = multi = 0
    for la in (90, 600, 1100, 1536, 2100, 2900):
        strips = (la + 32) // 32
        p = cluster * min(gotoh_plan.K1_MAX_WARPS, -(-strips // cluster))
        longest = p * (gotoh_plan.K1_RING + 28 - gotoh_plan.K1_SUB) - 32
        for lb in (1, 45, 700, 1536, longest - 40, longest):
            if lb >= 1 and gotoh_cuda.ring_safe(la, lb, cluster):
                assert _strip_schedule_finishes(la, lb, cluster), (la, lb)
        if strips > p:
            multi += 1
            assert not gotoh_cuda.ring_safe(la, longest + 1, cluster)
            assert _strip_schedule_finishes(la, longest + 4 * p, cluster)
            stalls += not _strip_schedule_finishes(la, longest + 4 * p + 8,
                                                   cluster)
    assert stalls == multi
    assert (multi > 0) == (cluster <= 4)

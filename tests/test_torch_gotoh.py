"""The PyTorch port's DP, traceback and edge filter vs. the JAX package.

On the CPU the port's wrappers (``lara_tpu_torch.ops.gotoh_cuda``) run the
plain torch versions of K1 and K2; they are held here, with zero tolerance
(every output is an integer), against ``lara_tpu.ops.gotoh`` (XLA) and the
Pallas kernels in interpret mode.  ``tests/test_torch_cuda.py`` holds the
kernels against the plain versions on a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lara_tpu.ops import gotoh as jax_gotoh
from lara_tpu.ops.gotoh_pallas import align_pssm_batch_pallas
from lara_tpu.params import Parameters
from lara_tpu.types import PSSM_INIT, f2i
from lara_tpu_torch.ops import gotoh, gotoh_cuda

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
    got = gotoh.edge_filter_skewed_words(
        torch.from_numpy(seq_a), torch.from_numpy(seq_b),
        torch.from_numpy(la), torch.from_numpy(lb),
        torch.from_numpy(submat), go, ge, subopt, la_max,
        lb_max).numpy()
    np.testing.assert_array_equal(got, want)
    active, opt = gotoh.unskew_active_words(got, la_max, lb_max)
    want_active, want_opt = jax_gotoh.unskew_active_words(want, la_max,
                                                          lb_max)
    np.testing.assert_array_equal(active, want_active)
    np.testing.assert_array_equal(opt, want_opt)
    assert active.any()

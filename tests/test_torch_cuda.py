"""The PyTorch port's CUDA kernels vs. their plain PyTorch versions, on a card.

K1 + K2 (``lara_tpu_torch.ops.gotoh_cuda``) and K3
(``lara_tpu_torch.solver.matching_cuda``) against the plain versions on the
same CUDA tensors, with zero tolerance (every output is an integer).  This
file imports no JAX, so it runs on a machine that has a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` configures JAX).  Without a card
every test skips.
"""

import numpy as np
import pytest
import torch

from lara_tpu.types import PSSM_INIT
from lara_tpu_torch import _build
from lara_tpu_torch.ops import gotoh, gotoh_cuda
from lara_tpu_torch.solver import matching_cuda, matching_device

pytestmark = pytest.mark.cuda

GO, GE = -49152, -16384


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _int_equal(got, want, name):
    assert got.shape == want.shape, name
    assert torch.equal(got.to(torch.int64), want.to(torch.int64)), name


# (batch, la_max, lb_max, seed): tiny, ragged, the tRNA bucket, wider than
# one CTA (1100 offsets > 1024 threads) and beyond 48 KB of shared memory
@pytest.mark.parametrize("case", [(4, 12, 10, 3), (9, 33, 47, 5),
                                  (16, 96, 96, 7), (2, 1100, 40, 9),
                                  (1, 1400, 16, 13)])
def test_dp_kernels_match_plain(case, cuda):
    b, la_max, lb_max, seed = case
    rng = np.random.default_rng(seed)
    pssm = rng.integers(-9000, 9000, (b, la_max, lb_max)).astype(np.int32)
    pssm[rng.random(pssm.shape) < 0.3] = PSSM_INIT
    seq = rng.integers(-5000, 5000, (b, la_max, lb_max)).astype(np.int32)
    la = rng.integers(1, la_max + 1, b).astype(np.int32)
    lb = rng.integers(1, lb_max + 1, b).astype(np.int32)
    la[0], lb[0] = la_max, lb_max
    if b > 1:
        la[1], lb[-1] = 1, 1
    pssm_t, seq_t, la_t, lb_t = (torch.from_numpy(x).to(cuda)
                                 for x in (pssm, seq, la, lb))

    before = dict(_build.launches)
    dirs_k, finals_k = gotoh_cuda.dp_forward(pssm_t, la_t, lb_t, GO, GE)
    tb_k = gotoh_cuda.dp_traceback(dirs_k, finals_k, la_t, lb_t, GO, GE, seq_t)
    assert _build.launches["gotoh_dp"] == before["gotoh_dp"] + 1
    assert _build.launches["gotoh_tb"] == before["gotoh_tb"] + 1
    dirs_p, finals_p = gotoh.dp_forward(pssm_t, la_t, lb_t, GO, GE)
    tb_p = gotoh.dp_traceback(dirs_p, finals_p, la_t, lb_t, GO, GE, seq_t)
    torch.cuda.synchronize()

    _int_equal(finals_k, finals_p, "finals")
    d_idx = torch.arange(la_max + lb_max + 1, device=cuda)[None, :, None]
    i_idx = torch.arange(la_max + 1, device=cuda)[None, None, :]
    valid = (i_idx <= la_t[:, None, None]) & (d_idx >= i_idx) \
        & (d_idx - i_idx <= lb_t[:, None, None])
    _int_equal(torch.where(valid, dirs_k, 0), torch.where(valid, dirs_p, 0),
               "dirs")
    for field, got, want in zip(gotoh.Traceback._fields, tb_k, tb_p):
        _int_equal(got, want, field)


def _matching_case(b, width, slots, seed):
    """Queue-ordered columns with exact weight ties among dead columns."""
    rng = np.random.default_rng(seed)
    n_edges = 4096
    cols = {name: np.zeros((b, width), np.int32) for name in ("l", "m", "w")}
    live = np.zeros((b, width), bool)
    line = np.full((b, slots), n_edges, np.int32)
    for k in range(b):
        n_lines = int(rng.integers(2, slots))
        lines = np.sort(rng.choice(n_edges, n_lines, replace=False))
        line[k, :n_lines] = lines
        inter = set()
        for _ in range(int(rng.integers(0, width // 2))):
            x, y = rng.choice(n_lines, 2, replace=False)
            l, m = sorted((int(lines[x]), int(lines[y])))
            inter.add((l, m, int(rng.integers(0, 6)) * 2))
        order = sorted(inter, key=lambda t: (-t[2], t[0], t[1]))
        at = np.sort(rng.choice(width, len(order), replace=False))
        for c, (l, m, w) in zip(at, order):
            cols["l"][k, c], cols["m"][k, c], cols["w"][k, c] = l, m, w
            live[k, c] = True
    return cols["l"], cols["m"], cols["w"], live, line


@pytest.mark.parametrize("width", [64, 300])
@pytest.mark.parametrize("lookahead", [1, 2, 5, 8])
def test_matching_kernel_matches_plain(width, lookahead, cuda):
    args = [torch.from_numpy(x).to(cuda)
            for x in _matching_case(12, width, 24, width + lookahead)]
    before = _build.launches["matching_rounds"]
    got = matching_device.greedy_matching_queue(*args, lookahead)
    assert _build.launches["matching_rounds"] == before + 1
    want = matching_device.rounds_loop(*args, lookahead)
    _int_equal(got.score, want.score, "score")
    _int_equal(got.used_slot, want.used_slot, "used_slot")


def test_wrappers_reject_bad_inputs(cuda):
    pssm = torch.zeros((2, 8, 8), dtype=torch.int32, device=cuda)
    la64 = torch.ones(2, dtype=torch.int64, device=cuda)
    la = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="la"):
        gotoh_cuda.dp_forward(pssm, la64, la, GO, GE)
    with pytest.raises(ValueError, match="pssm"):
        gotoh_cuda.dp_forward(pssm.transpose(1, 2), la, la, GO, GE)
    cols = torch.zeros((2, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="live"):
        matching_cuda.rounds_loop_cuda(cols, cols, cols, cols, cols, 5)

"""The PyTorch port's greedy matching vs. the JAX package.

On the CPU ``greedy_matching_queue`` runs the plain rounds loop (the plain
version of K3); it is held with zero tolerance against
``lara_tpu.solver.matching_device._rounds_loop`` (XLA) and
``rounds_loop_pallas`` in interpret mode, on the fuzz of
``tests/test_matching_pallas.py``: exact weight ties, compacted and sparse
live masks, lookahead 1, 2, 5 and 8 (the interpreter only to 5, as in
``tests/test_matching_pallas.py``).  ``tests/test_torch_cuda.py`` holds
K3 against the plain version on a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lara_tpu.solver.matching_device import _rounds_loop
from lara_tpu.solver.matching_pallas import rounds_loop_pallas
from lara_tpu_torch.solver.matching_device import (greedy_matching_queue,
                                                   rounds_loop)

from tests.test_matching_device import (_build_compact_case, _queue_sorted,
                                        run_case)

I32 = np.int32


def _fuzz(seed, lookahead, sparse):
    """A batch of queue-ordered candidate columns: (lq, mq, wq, live, line
    edges).  ``sparse`` interleaves dead columns (the solver's calling
    shape); otherwise the live columns are a compacted prefix."""
    rng = np.random.default_rng(seed * 37 + lookahead + (500 if sparse else 0))
    n_edges = 512
    batch, dcap, lcap = 6, 64, 16
    lq = np.zeros((batch, dcap), I32)
    mq = np.zeros((batch, dcap), I32)
    wq = np.zeros((batch, dcap), I32)
    live = np.zeros((batch, dcap), bool)
    line_edges = np.full((batch, lcap), n_edges, I32)
    for k in range(batch):
        n_lines = int(rng.integers(2, 10))
        lines, inter = run_case(rng, n_lines, int(rng.integers(0, dcap // 2)),
                                lookahead, n_edges)
        for slot, line in enumerate(lines[:lcap]):
            line_edges[k, slot] = line
        if sparse:
            slots = np.sort(rng.choice(dcap, size=len(inter), replace=False))
        else:
            slots = np.arange(len(inter))
        for idx, (l, m, w) in enumerate(_queue_sorted(inter)):
            s = int(slots[idx])
            lq[k, s], mq[k, s], wq[k, s] = l, m, w
            live[k, s] = True
    return lq, mq, wq, live, line_edges


def _port(lq, mq, wq, live, line_edges, lookahead):
    out = greedy_matching_queue(
        *(torch.from_numpy(x) for x in (lq, mq, wq, live, line_edges)),
        lookahead)
    return out.score.numpy(), out.used_slot.numpy()


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("lookahead", [1, 2, 5, 8])
@pytest.mark.parametrize("seed", range(2))
def test_matches_xla_rounds_loop(seed, lookahead, sparse):
    lq, mq, wq, live, line_edges = _fuzz(seed, lookahead, sparse)
    ref = _rounds_loop(jnp.asarray(lq), jnp.asarray(mq), jnp.asarray(wq),
                       jnp.asarray(live), jnp.asarray(line_edges),
                       jnp.asarray(live.sum(1).astype(I32)), lookahead,
                       lq.shape[1])
    score, used = _port(lq, mq, wq, live, line_edges, lookahead)
    np.testing.assert_array_equal(score, np.asarray(ref.score))
    np.testing.assert_array_equal(used, np.asarray(ref.used_slot))


# lookahead 8 is held against the XLA loop above: the interpreter runs the
# kernel's 2^8-subset memo unrolled, which takes minutes per call
@pytest.mark.parametrize("lookahead", [1, 2, 5])
@pytest.mark.parametrize("seed", range(2))
def test_matches_pallas_interpret(seed, lookahead):
    lq, mq, wq, live, line_edges = _fuzz(seed, lookahead, sparse=True)
    want_score, want_used = rounds_loop_pallas(
        jnp.asarray(lq), jnp.asarray(mq), jnp.asarray(wq), jnp.asarray(live),
        jnp.asarray(line_edges), lookahead, lq.shape[1], interpret=True)
    score, used = _port(lq, mq, wq, live, line_edges, lookahead)
    np.testing.assert_array_equal(score, np.asarray(want_score))
    np.testing.assert_array_equal(used, np.asarray(want_used))


def test_large_queue_matches_mirror():
    """One lane with ~700 live candidates among dead columns: the exact
    Python mirror of computeGreedyMatching."""
    rng = np.random.default_rng(11)
    (w2, l_e, m_e, cand, line_edges, _qrank), (want_score, want_used) = \
        _build_compact_case(rng, 700, 1024, 5, n_edges=8192)
    score, used = _port(l_e[None], m_e[None], w2[None], cand[None],
                        line_edges[None], 5)
    assert int(score[0]) == want_score
    np.testing.assert_array_equal(used[0], want_used)


def test_empty_and_known_chain():
    score, used = _port(np.zeros((3, 4), I32), np.zeros((3, 4), I32),
                        np.zeros((3, 4), I32), np.zeros((3, 4), bool),
                        np.full((3, 2), 16, I32), 5)
    assert not score.any() and not used.any()
    # queue order (0,1)=10, (1,2)=10, (0,2)=4 (tests/test_matching_device.py)
    out = rounds_loop(torch.tensor([[0, 1, 0]], dtype=torch.int32),
                      torch.tensor([[1, 2, 2]], dtype=torch.int32),
                      torch.tensor([[10, 10, 4]], dtype=torch.int32),
                      torch.ones((1, 3), dtype=torch.bool),
                      torch.tensor([[0, 1, 2, 8]], dtype=torch.int32), 5)
    assert int(out.score[0]) == 10
    assert out.used_slot[0].tolist() == [True, True, False, False]

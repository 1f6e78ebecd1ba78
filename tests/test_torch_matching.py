"""The PyTorch port's greedy matching vs. the JAX package.

On the CPU ``greedy_matching_queue`` runs the plain rounds loop (the plain
version of K3); it is held with zero tolerance against
``lara_tpu.solver.matching_device._rounds_loop`` (XLA) and
``rounds_loop_pallas`` in interpret mode, on the fuzz of
``tests/test_matching_pallas.py``: exact weight ties, compacted and sparse
live masks, lookahead 1, 2, 5 and 8 (the interpreter only to 5, as in
``tests/test_matching_pallas.py``).  ``tests/test_torch_cuda.py`` holds
K3 against the plain version on a card.

K3 itself cannot run here, so :func:`_k3_model` holds its algorithm in
Python, step for step: one warp per lane, the columns staged through the
kernel's ring (whose invariant it asserts), selection by 32-column windows
and ballot ranks, lazy blocking (a window's columns tested against the
kernel's open-addressing set of kept endpoints when the window is read,
then against each round's kept endpoints; a window's kept columns enter
the set when the warp leaves it), and the conflict memo filled one
popcount level at a time with its subsets dealt to 32 lanes.  It is held with zero tolerance against
``rounds_loop`` and the JAX ``_rounds_loop``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lara_tpu.solver.matching_device import _rounds_loop
from lara_tpu.solver.matching_pallas import rounds_loop_pallas
from lara_tpu_torch.solver import matching_cuda
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


# ---- a CPU model of K3 (csrc/matching.cu) ----

EMPTY = -2 ** 31  # an empty entry of the kept set (INT32_MIN)


def _i32(x):
    return (int(x) + 2 ** 31) % 2 ** 32 - 2 ** 31


class _KeptSet:
    """The kernel's set of kept endpoints: open addressing, linear probing
    from a multiplicative hash, INT32_MIN as the empty mark and a flag for
    a kept endpoint equal to it."""

    def __init__(self, size):
        self.entry = [EMPTY] * size
        self.mask = size - 1
        self.shift = 32 - (size.bit_length() - 1)
        self.has_empty = False

    def _home(self, key):
        return ((key & 0xFFFFFFFF) * 0x9E3779B1 & 0xFFFFFFFF) >> self.shift

    def contains(self, key):
        if key == EMPTY:
            return self.has_empty
        h = self._home(key)
        while True:
            if self.entry[h] == key:
                return True
            if self.entry[h] == EMPTY:
                return False
            h = (h + 1) & self.mask

    def insert(self, key):
        if key == EMPTY:
            self.has_empty = True
            return
        h = self._home(key)
        while self.entry[h] not in (EMPTY, key):
            h = (h + 1) & self.mask
        self.entry[h] = key


def _ballot(bits):
    return sum(1 << lane for lane, bit in enumerate(bits) if bit)


def _lowest(mask):
    return (mask & -mask).bit_length() - 1


def _solve_model(sel, sel_cnt, pairs):
    """The kernel's solve_conflicts: lane c holds conflict pair c; returns
    the bitmask of eliminated slots."""
    active = []
    for c in range(32):
        if c < len(pairs) and pairs[c][1] < sel_cnt:
            (lx, mx, _), (ly, my, _) = sel[pairs[c][0]], sel[pairs[c][1]]
            active.append(lx == ly or lx == my or mx == ly or mx == my)
        else:
            active.append(False)
    full = _ballot(active)
    if full == 0:
        return 0
    if full & (full - 1) == 0:
        return 1 << pairs[_lowest(full)][1]
    touch = [_ballot([active[c] and i in pairs[c] for c in range(32)])
             for i in range(sel_cnt)]
    n_sub = 1 << sel_cnt
    # each lane's subsets (e mod 32): the states that end without the
    # memo are filled at once, the others wait for their level
    memo = [None] * n_sub  # None: not filled yet; reading it fails
    pending = {}
    for lane in range(32):
        for e in range(lane, n_sub, 32):
            m = full
            for i in range(sel_cnt):
                if e >> i & 1:
                    m &= ~touch[i]
            if m == 0:
                memo[e] = (0, 0)
                continue
            l, s = pairs[_lowest(m)]  # S: the higher slot
            if m & (m - 1) == 0:
                memo[e] = (sel[s][2], 1 << s)
            else:
                pending[e] = (s, l, (m & ~touch[s]) != (m & ~touch[l]))
    for level in range(sel_cnt - 2, -1, -1):
        filled = {}
        for e, (s, l, differ) in pending.items():
            if bin(e).count("1") != level:
                continue
            sub_s, sub_l = memo[e | 1 << s], memo[e | 1 << l]
            w_s, w_l = sel[s][2], sel[l][2]
            weight_s = _i32(w_s + sub_s[0])
            weight_l = _i32(w_l + sub_l[0])
            l_wins = weight_s > w_l and differ and weight_s > weight_l
            filled[e] = (weight_l, sub_l[1] | 1 << l) if l_wins \
                else (weight_s, sub_s[1] | 1 << s)
        for e, val in filled.items():  # __syncwarp
            memo[e] = val
    return memo[0][1]


def _k3_model(lq, mq, wq, live, line_edges, lookahead, ring=None):
    """K3's algorithm, lane by lane, on numpy [B, W] columns and [B, S]
    line slots.  ``ring`` overrides the plan's ring size (a small ring
    makes a narrow queue stream through it).  Returns (score [B] int32,
    used [B, S] bool, rounds [B])."""
    b, width = lq.shape
    lh = max(1, min(int(lookahead), 8))
    kp = matching_cuda.plan(width)
    ring = ring or kp.ring
    pairs = [(x, y) for x in range(lh) for y in range(x + 1, lh)]
    score = np.zeros(b, I32)
    used = np.zeros(line_edges.shape, bool)
    rounds = np.zeros(b, np.int64)
    for k in range(b):
        kept = _KeptSet(kp.table)
        staged = np.full(ring, -1)  # the column each ring slot holds
        hi = min(width, ring)
        staged[:hi] = np.arange(hi)
        lh_lane = min(lh, int(live[k].sum()))

        def load_window(pos):
            """The 32 lanes' columns of the window at pos and their ok
            bits, tested against the set."""
            nonlocal hi
            if hi < min(pos + 32, width):
                nxt = min(hi + ring // 2, width)
                cols = np.arange(hi, nxt)
                # a refill overwrites only columns before the window
                assert (staged[cols % ring] < pos).all()
                staged[cols % ring] = cols
                hi = nxt
            cols, ok = [], []
            for lane in range(32):
                c = pos + lane
                if c < width:
                    assert staged[c % ring] == c
                    col = (int(lq[k, c]), int(mq[k, c]), int(wq[k, c]))
                    ok.append(bool(live[k, c])
                              and not kept.contains(col[0])
                              and not kept.contains(col[1]))
                else:
                    col = (0, 0, 0)
                    ok.append(False)
                cols.append(col)
            return cols, ok

        def add(flags, keys):
            for flag, (l, m, *_rest) in zip(flags, keys):
                if flag:
                    kept.insert(l)
                    kept.insert(m)

        total, pos, ptr = 0, 0, 0
        cols, ok = load_window(0) if width else ([], [])
        kept_here = [False] * 32
        while ptr < width:
            rounds[k] += 1
            found, found_before, next_ptr = 0, 0, width
            sel, my_rank = [], [-1] * 32
            while True:
                cand = [ok[lane] and pos + lane >= ptr for lane in range(32)]
                ballot = _ballot(cand)
                ranks = [found + bin(ballot & ((1 << lane) - 1)).count("1")
                         for lane in range(32)]
                for lane in range(32):
                    if cand[lane] and ranks[lane] < lh_lane:
                        sel.append(cols[lane])
                        my_rank[lane] = ranks[lane]
                found_before = found
                found += bin(ballot).count("1")
                if found >= lh_lane:
                    last = _ballot([cand[lane] and ranks[lane] == lh_lane - 1
                                    for lane in range(32)])
                    if last:
                        next_ptr = pos + _lowest(last) + 1
                    break
                if pos + 32 >= width:
                    break
                add(kept_here, cols)  # leave the window
                kept_here, my_rank = [False] * 32, [-1] * 32
                pos += 32
                cols, ok = load_window(pos)
            sel_cnt = min(found, lh_lane)
            if sel_cnt == 0:
                break
            elim = _solve_model(sel, sel_cnt, pairs)
            keep = [slot < sel_cnt and not elim >> slot & 1
                    for slot in range(32)]
            total = _i32(total + sum(w for slot, (_, _, w) in enumerate(sel)
                                     if keep[slot]))
            add([keep[slot] and slot < found_before for slot in range(32)],
                sel + [(0, 0, 0)] * (32 - len(sel)))
            for lane in range(32):
                if my_rank[lane] >= 0 and keep[my_rank[lane]]:
                    kept_here[lane] = True
                ends = {v for slot in range(sel_cnt) if keep[slot]
                        for v in sel[slot][:2]}
                if cols[lane][0] in ends or cols[lane][1] in ends:
                    ok[lane] = False
            ptr = next_ptr
        add(kept_here, cols)
        score[k] = total
        used[k] = [kept.contains(int(e)) for e in line_edges[k]]
    return score, used, rounds


def _plain(lq, mq, wq, live, line_edges, lookahead):
    out = rounds_loop(*(torch.from_numpy(x)
                        for x in (lq, mq, wq, live, line_edges)), lookahead)
    return out.score.numpy(), out.used_slot.numpy()


def _xla(lq, mq, wq, live, line_edges, lookahead):
    out = _rounds_loop(jnp.asarray(lq), jnp.asarray(mq), jnp.asarray(wq),
                       jnp.asarray(live), jnp.asarray(line_edges),
                       jnp.asarray(live.sum(1).astype(I32)), lookahead,
                       lq.shape[1])
    return np.asarray(out.score), np.asarray(out.used_slot)


def _hold_model(case, lookahead, ring=None, against_xla=True):
    score, used, rounds = _k3_model(*case, lookahead, ring=ring)
    wants = [_plain(*case, lookahead)]
    if against_xla:
        wants.append(_xla(*case, lookahead))
    for want_score, want_used in wants:
        np.testing.assert_array_equal(score, want_score)
        np.testing.assert_array_equal(used, want_used)
    return rounds


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("lookahead", [1, 2, 5, 8])
@pytest.mark.parametrize("seed", range(2))
def test_k3_model_on_the_fuzz(seed, lookahead, sparse):
    _hold_model(_fuzz(seed, lookahead, sparse), lookahead)


@pytest.mark.parametrize("lookahead", [1, 5, 8])
def test_k3_model_streams_through_a_small_ring(lookahead):
    """A queue of 1000 columns through a ring of 128: every refill keeps
    the window's columns (the model asserts the ring's invariant)."""
    rng = np.random.default_rng(lookahead)
    (w2, l_e, m_e, cand, line_edges, _qrank), _ = _build_compact_case(
        rng, 300, 1000, lookahead, n_edges=4096)
    case = (l_e[None], m_e[None], w2[None], cand[None], line_edges[None])
    assert _hold_model(case, lookahead, ring=128)[0] > 1


def test_k3_model_large_queue_matches_mirror():
    """The 700-live-in-1024 case of the mirror test."""
    rng = np.random.default_rng(11)
    (w2, l_e, m_e, cand, line_edges, _qrank), (want_score, want_used) = \
        _build_compact_case(rng, 700, 1024, 5, n_edges=8192)
    case = (l_e[None], m_e[None], w2[None], cand[None], line_edges[None])
    score, used, _rounds = _k3_model(*case, 5)
    assert int(score[0]) == want_score
    np.testing.assert_array_equal(used[0], want_used)
    _hold_model(case, 5)


def test_k3_model_on_the_smoke_case():
    """The first lanes of ``chip_smoke.py``'s B=32 W=1536 S=1536 case."""
    import chip_smoke

    case = tuple(x[:4] for x in chip_smoke._matching_case(32, 1536, 1536, 22))
    assert _hold_model(case, 5).max() > 10


@pytest.mark.parametrize("lookahead", [2, 5, 8])
def test_k3_model_any_ids(lookahead):
    """Live columns with arbitrary ids, INT32_MIN (the set's empty mark)
    and negative ids among them, ties on every weight, a lane with no live
    column, a lane whose columns never conflict, and a width that is not a
    multiple of 32."""
    rng = np.random.default_rng(40 + lookahead)
    b, width, slots = 5, 77, 9
    ids = np.array([EMPTY, -7, 0, 5, 2 ** 31 - 1, 1 << 20, 3, 4, 9], I32)
    lq = ids[rng.integers(0, len(ids), (b, width))]
    mq = ids[rng.integers(0, len(ids), (b, width))]
    wq = (rng.integers(-3, 4, (b, width)) * 2).astype(I32)
    live = rng.random((b, width)) < 0.6
    live[1] = False
    lq[2] = np.arange(width, dtype=I32) * 2
    mq[2] = lq[2] + 1
    line = np.tile(ids, (b, 1))
    line[4, -1] = 12345  # a slot that no column holds
    _hold_model((lq, mq, wq, live, line), lookahead)


@pytest.mark.parametrize("lookahead", [3, 5])
def test_k3_model_tie_rule(lookahead):
    """Slots (0,10) 4, (0,20) 4, (20,30) -2 conflict as 0-1 and 1-2.
    Eliminating slot 1 costs 4, exactly slot 0's weight, so L is not
    explored (S must be strictly heavier), though eliminating 0 and 2
    would cost only 2: slots 0 and 2 stay, score 2."""
    case = (np.array([[0, 0, 20]], I32), np.array([[10, 20, 30]], I32),
            np.array([[4, 4, -2]], I32), np.ones((1, 3), bool),
            np.array([[0, 10, 20, 30, 99]], I32))
    _hold_model(case, lookahead)
    score, used = _plain(*case, lookahead)
    assert int(score[0]) == 2
    assert used[0].tolist() == [True, True, True, True, False]


@pytest.mark.parametrize("width,want", [
    (0, (128, 64, True)), (1, (128, 64, True)), (96, (128, 512, True)),
    (512, (512, 2048, True)), (1536, (2048, 8192, True)),
    (4096, (2048, 16384, True)), (4097, (2048, 32768, False)),
    (40000, (2048, 262144, False)),
])
def test_k3_plan(width, want):
    """The ring holds the whole row up to 2048 columns; the set has four
    entries per column and leaves shared memory past W = 4096."""
    assert tuple(matching_cuda.plan(width)) == want

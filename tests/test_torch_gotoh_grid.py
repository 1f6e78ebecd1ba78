"""Models of K1-grid's and K2-grid's loops (``csrc/gotoh_dp.cu``) vs. JAX.

K1-grid and K2-grid are K1's and K2's kernels over the grid variant's
layouts: pre-skewed scores ``[D, B, W]`` int32 in, diagonal-major codes
``[Dp, B, W]`` int8 out.  No card runs here, so two numpy models run the
kernels' own loops at small shapes:

* ``_k1_grid_model``: K1's warp strips (lane t one column behind lane
  t-1, the up cell from lane t-1's previous step, a strip's last row
  handed to the next strip) with K1-grid's addressing, its score ring
  and the plain step (``_wave_cell``, K1's ``wave_cell``).  It checks that
  every warp step's 32 reads and 32 writes are contiguous, that a score is
  still in its ring slot when its step reads it, and that every valid cell
  is read once and written once.
* ``_k2_grid_model``: K2's windowed walk (a window of 128 diagonals x 80
  bytes anchored where the walk stood, 32 steps per window) over the
  diagonal-major layout.  It checks that every step reads inside its
  window, and reads the byte of the cell it stands on.

Both are held, with zero tolerance, against ``gotoh_scan_pallas`` and
``align_pssm_batch_pallas`` in interpret mode and the XLA scan.
``tests/test_torch_cuda.py`` holds the kernels against the plain versions
on a card.
"""

import os
import re

import numpy as np
import pytest

import jax.numpy as jnp

from lara_tpu.ops import gotoh as jax_gotoh
from lara_tpu.ops.gotoh_pallas import align_pssm_batch_pallas, \
    gotoh_scan_pallas
from lara_tpu_torch.ops import gotoh, gotoh_cuda, gotoh_plan

from tests.test_torch_gotoh import CASES, GE, GO, _problem

NEG = int(jax_gotoh.NEG_INF)
MAT, HOR, VER = gotoh.MAT, gotoh.HOR, gotoh.VER

# CASES plus two with several strips: la_max not a multiple of 32, and
# walks of more than two windows' 32 steps
GRID_CASES = CASES + [
    (3, 70, 45, [70, 1, 40], [45, 30, 1], 13),
    (2, 40, 100, [33, 40], [100, 64], 17),
]


def _wrap(x):
    return (np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31


def _wave_cell(i, j, sc, dm, dh, dv, cm, ch, cv, um, uh, uv, go, ge,
               bcode):
    """K1's ``wave_cell`` over a warp's 32 lanes (int64 arrays holding
    int32 values): (code, the new cell's M, H, V)."""
    best = np.maximum(np.maximum(dm, dh), dv)
    mn = _wrap(best + sc)
    mdir = np.where(dm == best, MAT, np.where(dh == best, HOR, VER))
    hh, hm, hv = _wrap(ch + ge), _wrap(cm + go), _wrap(cv + go)
    hn = np.maximum(np.maximum(hh, hm), hv)
    hdir = np.where(hh == hn, HOR, np.where(hm == hn, MAT, VER))
    vv, vm, vh = _wrap(uv + ge), _wrap(um + go), _wrap(uh + go)
    vn = np.maximum(np.maximum(vv, vm), vh)
    vdir = np.where(vv == vn, VER, np.where(vm == vn, MAT, HOR))
    mh = mdir | (hdir << 2)
    top, left = i == 0, j == 0
    bg_top = np.where(j == 0, 0, _wrap(go + _wrap(ge * (j - 1))))
    mn = np.where(top, bg_top, mn)
    hn = np.where(top, np.where(j == 0, NEG, bg_top), hn)
    vn = np.where(top, NEG, vn)
    bg_left = np.where(i == 0, 0, _wrap(go + _wrap(ge * (i - 1))))
    mn = np.where(left, bg_left, mn)
    hn = np.where(left, NEG, hn)
    vn = np.where(left, np.where(i == 0, NEG, bg_left), vn)
    mh = np.where(left, bcode, mh)
    return mh | (vdir << 4), mn, hn, vn


def _k1_grid_model(skewed, la, lb, go, ge, dchunk):
    """K1-grid's warp loop over skewed [D, B, W] (numpy int32): returns
    (dirs [Dp, B, W] int16, -1 where nothing was written; finals [3, B];
    reads [D, B, W] and writes [Dp, B, W], the times each element was
    read or written)."""
    num_diag, batch, width = skewed.shape
    num_rows = -(-num_diag // dchunk) * dchunk
    flat = skewed.reshape(-1).astype(np.int64)
    dirs = np.full(num_rows * batch * width, -1, np.int16)
    reads = np.zeros(flat.size, np.int64)
    writes = np.zeros(dirs.size, np.int64)
    finals = np.zeros((3, batch), np.int64)
    border = gotoh_cuda.border_codes(go, ge, width).astype(np.int64)
    cols = gotoh_plan.K1_TILE_COLS
    t = np.arange(32)
    dstride = batch * width  # a diagonal of the skewed stream and of dirs
    for b in range(batch):
        la_b, lb_b = int(la[b]), int(lb[b])
        up_row = None  # the last row of the strip above, by column
        for k in range((la_b + 32) // 32):
            base = 32 * k
            i = base + t
            row_ok = (i >= 1) & (i <= la_b)
            bcode = np.where(i <= la_b, border[np.minimum(i, width - 1)], 0)
            # each lane's score ring: the step whose score a slot holds
            slot_step = np.full((32, cols), -1, np.int64)
            slot_val = np.zeros((32, cols), np.int64)

            def load_chunk(c):
                for s in range(32 * c, 32 * c + 32):
                    ok = row_ok & (s - t >= 1) & (s - t <= lb_b)
                    addr = ((base + s) * batch + b) * width + base + t
                    assert np.all(np.diff(addr) == 1)  # one 128-byte row
                    slot = (s - t - 1) % cols
                    reads[addr[ok]] += 1
                    slot_step[t[ok], slot[ok]] = s
                    slot_val[t[ok], slot[ok]] = flat[addr[ok]]

            cm = ch = cv = dm = dh = dv = np.full(32, NEG, np.int64)
            new_row = np.full((3, lb_b + 1), NEG, np.int64)
            load_chunk(0)
            for s in range(lb_b + 32):
                if s % 32 == 0:
                    load_chunk(s // 32 + 1)
                j = s - t
                um, uh, uv = np.roll(cm, 1), np.roll(ch, 1), np.roll(cv, 1)
                if k > 0 and s <= lb_b:
                    um[0], uh[0], uv[0] = up_row[:, s]
                else:
                    um[0] = uh[0] = uv[0] = NEG
                ci = (s - t - 1) % cols
                scored = row_ok & (j >= 1) & (j <= lb_b)
                assert np.all(slot_step[t[scored], ci[scored]] == s)
                code, cm, ch, cv = _wave_cell(
                    i, j, slot_val[t, ci], dm, dh, dv, cm, ch, cv, um, uh,
                    uv, go, ge, bcode)
                dm, dh, dv = um, uh, uv
                store = (i <= la_b) & (j >= 0) & (j <= lb_b)
                addr = ((base + s) * batch + b) * width + i
                assert np.all(np.diff(addr) == 1)  # one 32-byte store
                writes[addr[store]] += 1
                dirs[addr[store]] = code[store]
                if 0 <= s - 31 <= lb_b:
                    new_row[:, s - 31] = cm[31], ch[31], cv[31]
                at = (i == la_b) & (j == lb_b)
                if at.any():
                    finals[:, b] = cm[at][0], ch[at][0], cv[at][0]
            up_row = new_row
    return (dirs.reshape(num_rows, batch, width), finals,
            reads.reshape(skewed.shape), writes.reshape(num_rows, batch, width))


def _k2_grid_model(dirs, finals, la, lb, seq, go, ge):
    """K2-grid's walk over dirs [Dp, B, W] (numpy, codes in 0..63 on the
    cells it may read): (partner [B, LA], scalars [4, B] upper, gap,
    n_lines, seq), asserting that every step reads inside its window and
    finds there its own cell's code."""
    num_rows, batch, width = dirs.shape
    flat = dirs.reshape(-1).astype(np.uint8)
    rows, nbytes, seg = (gotoh_cuda.K2_WIN_ROWS, gotoh_cuda.K2_WIN_BYTES,
                         gotoh_cuda.K2_SEG)
    lane_stride, diag_stride = width, batch * width
    partner = np.full((batch, width - 1), -1, np.int64)
    scalars = np.zeros((4, batch), np.int64)
    for b in range(batch):
        lane_base = b * lane_stride

        def load_window(da, ia):
            win = np.full(rows * nbytes, -1, np.int64)  # -1: not copied
            for r in range(min(rows, da + 1)):
                a0 = (lane_base + (da - r) * diag_stride + ia - 63) & ~15
                for a in range(a0, a0 + nbytes, 16):
                    if 0 <= a < flat.size:
                        win[r * nbytes + a - a0:][:16] = flat[a:a + 16]
            return win

        fm, fh, fv = (int(x) for x in finals[:, b])
        upper = max(fm, fh, fv)
        state = MAT if fm == upper else (HOR if fh == upper else VER)
        i, j = int(la[b]), int(lb[b])
        gap = cnt = 0
        da, ia = i + j, i
        win = load_window(da, ia)
        first = True
        while i > 0 or j > 0:
            nda, nia = i + j, i
            nxt = None if first else load_window(nda, nia)
            kmod = (lane_base + da * diag_stride + ia - 63) & 15
            for _ in range(seg):
                if i == 0 and j == 0:
                    break
                if i == 0:
                    state = HOR
                elif j == 0:
                    state = VER
                r = da - (i + j)
                col = ((kmod - r * (diag_stride & 15)) & 15) + i - ia + 63
                assert 0 <= r < rows and 0 <= col < nbytes, (b, i, j, da, ia)
                code = int(win[r * nbytes + col])
                assert code == flat[lane_base + (i + j) * diag_stride + i]
                assert 0 <= code < 64, (b, i, j)  # a cell K1-grid wrote
                pred = (code >> (2 * state)) & 3
                if state == MAT:
                    partner[b, i - 1] = j - 1
                    cnt += 1
                else:
                    gap = int(_wrap(gap + (ge if pred == state else go)))
                if state != HOR:
                    i -= 1
                if state != VER:
                    j -= 1
                state = pred
            if first:
                first = False
                continue
            win, da, ia = nxt, nda, nia
        matched = partner[b] >= 0
        rows_m = np.nonzero(matched)[0]
        total = int(seq[b, rows_m, partner[b, rows_m]].astype(np.int64).sum())
        scalars[:, b] = upper, gap, cnt, _wrap(total)
    return partner, scalars


def _valid(la, lb, d, i):
    """[B, ...] mask of the cells (i, d - i) inside each lane's rectangle."""
    la, lb = la[:, None, None], lb[:, None, None]
    return (i <= la) & (d >= i) & (d - i <= lb)


@pytest.mark.parametrize("dchunk", [8, 5])
@pytest.mark.parametrize("case", GRID_CASES)
def test_k1_grid_model_matches_pallas(case, dchunk):
    """K1-grid's warp loop reads each scored cell of the skewed stream
    once and nothing else, writes each valid cell of [Dp, B, W] once and
    nothing else, and its codes and finals equal ``gotoh_scan_pallas``'s
    (interpret mode) and the XLA scan's."""
    pssm, la, lb, _seq, la_max, lb_max = _problem(case)
    skewed = jax_gotoh.skew_scores(jnp.asarray(pssm), jax_gotoh.NEG_INF)
    dirs, finals, reads, writes = _k1_grid_model(np.asarray(skewed), la, lb,
                                                 GO, GE, dchunk)
    _fm, _fh, _fv, d_pal = gotoh_scan_pallas(
        skewed, jnp.asarray(la), jnp.asarray(lb), GO, GE, block_b=8,
        dchunk=dchunk, interpret=True)
    xla = jax_gotoh.gotoh_scan(skewed, jnp.asarray(la), jnp.asarray(lb), GO,
                               GE, la_max, emit="dirs")
    num_diag, width = la_max + lb_max + 1, la_max + 1
    d = np.arange(dirs.shape[0])[None, :, None]
    i = np.arange(width)[None, None, :]
    valid = _valid(la, lb, d, i).transpose(1, 0, 2)  # [Dp, B, W]
    scored = valid[:num_diag] & (i.transpose(1, 0, 2) >= 1) & (
        d.transpose(1, 0, 2)[:num_diag] > i.transpose(1, 0, 2))
    np.testing.assert_array_equal(reads, scored.astype(np.int64))
    np.testing.assert_array_equal(writes, valid.astype(np.int64))
    d_pal = np.asarray(d_pal)
    assert d_pal.shape == dirs.shape
    np.testing.assert_array_equal(dirs[valid], d_pal[valid].astype(np.int16))
    want = np.stack([np.asarray(x) for x in xla[:3]])
    np.testing.assert_array_equal(finals, want)


@pytest.mark.parametrize("case", GRID_CASES)
def test_k2_grid_model_matches_pallas_traceback(case):
    """K2-grid's windowed walk over the JAX package's diagonal-major codes
    (``gotoh_scan_pallas``, interpret mode) gives the partner map and the
    upper bound, gap score, line count and seq-score sum of
    ``align_pssm_batch_pallas``; every step stays inside its window."""
    pssm, la, lb, seq, la_max, lb_max = _problem(case)
    skewed = jax_gotoh.skew_scores(jnp.asarray(pssm), jax_gotoh.NEG_INF)
    jla, jlb = jnp.asarray(la), jnp.asarray(lb)
    xla = jax_gotoh.gotoh_scan(skewed, jla, jlb, GO, GE, la_max, emit="dirs")
    _fm, _fh, _fv, d_pal = gotoh_scan_pallas(skewed, jla, jlb, GO, GE,
                                             block_b=8, dchunk=8,
                                             interpret=True)
    finals = np.stack([np.asarray(x) for x in xla[:3]])
    partner, scalars = _k2_grid_model(np.asarray(d_pal), finals, la, lb, seq,
                                      GO, GE)
    pal = align_pssm_batch_pallas(jnp.asarray(pssm), jla, jlb, GO, GE, la_max,
                                  lb_max, block_b=8, interpret=True,
                                  emit_lines=False,
                                  seq_scores=jnp.asarray(seq))
    np.testing.assert_array_equal(partner, np.asarray(pal.partner))
    for row, name in enumerate(("upper", "gap_score", "n_lines",
                                "seq_part")):
        np.testing.assert_array_equal(scalars[row],
                                      np.asarray(getattr(pal, name)), name)


@pytest.mark.parametrize("case", GRID_CASES[-2:])
def test_k2_grid_model_reads_only_what_k1_grid_wrote(case):
    """Chained as the grid branch of ``align_pssm_batch`` runs them: K2-grid
    walks K1-grid's codes with every byte K1-grid never wrote (padding
    rows, cells outside the rectangles) set to junk, and gives the port's
    plain traceback; the model asserts that it reads only written cells."""
    import torch

    pssm, la, lb, seq, la_max, lb_max = _problem(case)
    skewed = gotoh.skew_scores(torch.from_numpy(pssm), NEG).numpy()
    dirs, finals, _r, _w = _k1_grid_model(skewed, la, lb, GO, GE, 32)
    assert dirs.shape[0] == 32 * -(-(la_max + lb_max + 1) // 32)
    junk = np.where(dirs < 0, 0xFF, dirs).astype(np.uint8).view(np.int8)
    partner, scalars = _k2_grid_model(junk, finals, la, lb, seq, GO, GE)
    t = torch.from_numpy
    want = gotoh_cuda.align_pssm_batch(t(pssm), t(la), t(lb), GO, GE, la_max,
                                       lb_max, t(seq))
    np.testing.assert_array_equal(partner, want.partner.numpy())
    for row, name in enumerate(("upper", "gap_score", "n_lines",
                                "seq_part")):
        np.testing.assert_array_equal(scalars[row],
                                      getattr(want, name).numpy(), name)


def test_grid_constants_match_the_source():
    """The models' constants are the kernels': K1's score ring and K2's
    window, as ``csrc/gotoh_dp.cu`` defines them."""
    path = os.path.join(os.path.dirname(gotoh_cuda.__file__), os.pardir,
                        "csrc", "gotoh_dp.cu")
    with open(path) as handle:
        src = handle.read()
    got = tuple(int(re.search(rf"constexpr int {name} = (\d+);", src)
                    .group(1))
                for name in ("kTileCols", "kWinRows", "kWinBytes", "kSeg"))
    assert got == (gotoh_plan.K1_TILE_COLS, gotoh_cuda.K2_WIN_ROWS,
                   gotoh_cuda.K2_WIN_BYTES, gotoh_cuda.K2_SEG)
    assert not os.path.exists(os.path.join(os.path.dirname(path),
                                           "gotoh_grid.cu"))

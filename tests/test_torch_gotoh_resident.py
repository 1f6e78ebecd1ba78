"""A model of K-res's code store and walk (``csrc/gotoh_dp.cu``) vs. JAX.

K-res is K1's sweep and K2's walk in one launch, with the direction codes
in shared memory: lane t of the strip of rows base .. base+31 computes
cell (i, s - t) at step s, packs the codes of steps 4q .. 4q+3 into one
32-bit word and stores it as word q of row i, a row being an odd number of
words (``gotoh_plan.resident_pitch``); byte j + (i & 31) of row i holds cell
(i, j).  Then lane 0 of warp 0 walks as K2 does, reading each cell's byte
from that store.  No card runs here, so a numpy model runs both loops at
small shapes and checks that every valid cell is written once, into its
own byte, that a warp step's stores fall in 32 banks, and that every walk
step reads the byte of the cell it stands on; wrong pitches and a walk one
row off fail those checks.  The partner map and the scalars are held, with
zero tolerance, against the Pallas resident kernels (``LARA_DP_RESIDENT=1``,
``align_pssm_batch_pallas`` in interpret mode).  ``tests/test_torch_cuda.py``
holds the kernel against the plain versions on a card.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from lara_tpu.ops.gotoh_pallas import align_pssm_batch_pallas
from lara_tpu_torch.ops import gotoh, gotoh_cuda, gotoh_plan

from tests.test_torch_gotoh import GE, GO, _problem
from tests.test_torch_gotoh_grid import GRID_CASES, NEG, _wave_cell, _wrap

MAT, HOR, VER = gotoh.MAT, gotoh.HOR, gotoh.VER


def _kres_model(pssm, la, lb, seq, go, ge, pitch=None, walk_row=0):
    """K-res's sweep and walk over pssm [B, LA, LB] (numpy int32): returns
    (partner [B, LA], scalars [4, B] upper, gap, n_lines, seq).  ``pitch``
    overrides the row pitch in words and ``walk_row`` shifts the row the
    walk reads (mutants)."""
    batch, la_max, lb_max = pssm.shape
    pitch = gotoh_plan.resident_pitch(lb_max) if pitch is None else pitch
    width = la_max + 1
    border = gotoh_cuda.border_codes(go, ge, width).astype(np.int64)
    t = np.arange(32)
    partner = np.full((batch, la_max), -1, np.int64)
    scalars = np.zeros((4, batch), np.int64)
    for b in range(batch):
        la_b, lb_b = int(la[b]), int(lb[b])
        words = np.zeros((la_max + 1) * pitch, np.uint32)
        nbytes = 4 * words.size
        # the cell whose code each byte holds, (-1, -1) for none
        owner = np.full((nbytes, 2), -1, np.int64)
        stored = np.zeros((la_max + 1, lb_max + 1), np.int64)
        code_of = {}
        fin = None
        up_row = None
        for k in range((la_b + 32) // 32):
            base = 32 * k
            i = base + t
            row_valid = i <= la_b
            bcode = np.where(row_valid, border[np.minimum(i, width - 1)], 0)
            cm = ch = cv = dm = dh = dv = np.full(32, NEG, np.int64)
            new_row = np.full((3, lb_b + 1), NEG, np.int64)
            word = np.zeros(32, np.uint32)
            cells = [[] for _ in range(32)]
            nsteps = -(-(lb_b + 32) // 8) * 8  # whole blocks of 8 steps
            for s in range(nsteps):
                j = s - t
                um, uh, uv = np.roll(cm, 1), np.roll(ch, 1), np.roll(cv, 1)
                if k > 0 and s <= lb_b:
                    um[0], uh[0], uv[0] = up_row[:, s]
                else:
                    um[0] = uh[0] = uv[0] = NEG
                ok = (i >= 1) & (i <= la_b) & (j >= 1) & (j <= lb_b)
                sc = np.full(32, NEG, np.int64)
                sc[ok] = pssm[b, i[ok] - 1, j[ok] - 1]
                code, cm, ch, cv = _wave_cell(i, j, sc, dm, dh, dv, cm, ch,
                                              cv, um, uh, uv, go, ge, bcode)
                dm, dh, dv = um, uh, uv
                word |= (code.astype(np.uint32) & 0xFF) << np.uint32(
                    8 * (s & 3))
                for lane in range(32):
                    cells[lane].append((int(i[lane]), int(j[lane]),
                                        int(code[lane])))
                if s & 3 == 3:
                    store = row_valid & (j >= 0) & (j - 3 <= lb_b)
                    addr = i * pitch + (s >> 2)
                    # a warp step's stores fall in 32 distinct banks
                    banks = addr[store] % 32
                    assert len(set(banks.tolist())) == int(store.sum()), \
                        (b, k, s, pitch)
                    # each word inside its own row
                    assert not store.any() or s >> 2 < pitch, (b, k, s)
                    for lane in np.nonzero(store)[0]:
                        words[addr[lane]] = word[lane]
                        for q, (ci, cj, cc) in enumerate(cells[lane]):
                            byte = 4 * addr[lane] + q
                            owner[byte] = ci, cj
                            if 0 <= cj <= lb_b and ci <= la_b:
                                # cell (i, j) at byte j + (i & 31) of row i
                                assert byte == 4 * ci * pitch + cj + (ci & 31)
                                stored[ci, cj] += 1
                                code_of[ci, cj] = cc
                    word[:] = 0
                    cells = [[] for _ in range(32)]
                if 0 <= s - 31 <= lb_b:
                    new_row[:, s - 31] = cm[31], ch[31], cv[31]
                at = (i == la_b) & (j == lb_b)
                if at.any():
                    fin = cm[at][0], ch[at][0], cv[at][0]
            up_row = new_row
        # every valid cell written once (its word stored once)
        np.testing.assert_array_equal(stored[:la_b + 1, :lb_b + 1], 1)
        assert stored[la_b + 1:].sum() == 0 and stored[:, lb_b + 1:].sum() == 0
        # and no later store wrote over a valid cell's byte
        for (ci, cj) in code_of:
            byte = 4 * ci * pitch + cj + (ci & 31)
            assert tuple(owner[byte]) == (ci, cj), (b, ci, cj)
        data = words.view(np.uint8)

        # the walk: lane 0 of warp 0
        fm, fh, fv = (int(x) for x in fin)
        upper = max(fm, fh, fv)
        state = MAT if fm == upper else (HOR if fh == upper else VER)
        ii, jj = la_b, lb_b
        gap = cnt = 0
        while ii > 0 or jj > 0:
            if ii == 0:
                state = HOR
            elif jj == 0:
                state = VER
            byte = (ii + walk_row) * 4 * pitch + jj + (ii & 31)
            assert 0 <= byte < nbytes and tuple(owner[byte]) == (ii, jj), \
                (b, ii, jj)
            code = int(data[byte])
            assert code == code_of[ii, jj]
            pred = (code >> (2 * state)) & 3
            if state == MAT:
                partner[b, ii - 1] = jj - 1
                cnt += 1
            else:
                gap = int(_wrap(gap + (ge if pred == state else go)))
            if state != HOR:
                ii -= 1
            if state != VER:
                jj -= 1
            state = pred
        rows_m = np.nonzero(partner[b] >= 0)[0]
        total = int(seq[b, rows_m, partner[b, rows_m]].astype(np.int64).sum())
        scalars[:, b] = upper, gap, cnt, _wrap(total)
    return partner, scalars


@pytest.fixture
def resident_env(monkeypatch):
    """The JAX plan reads the variant switches at trace time."""
    for key in ("LARA_DP_GRID", "LARA_DCHUNK"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("LARA_DP_RESIDENT", "1")
    align_pssm_batch_pallas.clear_cache()
    yield
    align_pssm_batch_pallas.clear_cache()


@pytest.mark.parametrize("case", GRID_CASES)
def test_kres_model_matches_pallas_resident(case, resident_env):
    """The model's code store and walk give the partner map and the upper
    bound, gap score, line count and seq-score sum of the Pallas resident
    kernels, and of the port's own entry point."""
    import torch

    pssm, la, lb, seq, la_max, lb_max = _problem(case)
    partner, scalars = _kres_model(pssm, la, lb, seq, GO, GE)
    pal = align_pssm_batch_pallas(
        jnp.asarray(pssm), jnp.asarray(la), jnp.asarray(lb), GO, GE, la_max,
        lb_max, block_b=8, interpret=True, emit_lines=False,
        seq_scores=jnp.asarray(seq))
    t = torch.from_numpy
    port = gotoh_cuda.align_resident(t(pssm), t(la), t(lb), GO, GE, t(seq))
    np.testing.assert_array_equal(partner, np.asarray(pal.partner))
    np.testing.assert_array_equal(partner, port.partner.numpy())
    for row, name in enumerate(("upper", "gap_score", "n_lines",
                                "seq_part")):
        np.testing.assert_array_equal(scalars[row],
                                      np.asarray(getattr(pal, name)), name)
        np.testing.assert_array_equal(scalars[row],
                                      getattr(port, name).numpy(), name)


@pytest.mark.parametrize("mutant", ["even_pitch", "short_pitch",
                                    "walk_row_up", "walk_row_down"])
def test_kres_model_mutants_fail(mutant):
    """An even pitch puts two rows' stores in one bank, a pitch one word
    short lets a row's last word overwrite the next row's first cells, and
    a walk one row off reads another cell's byte: each check fails."""
    pssm, la, lb, seq, _la_max, lb_max = _problem(GRID_CASES[-2])
    pitch = gotoh_plan.resident_pitch(lb_max)
    kwargs = {"even_pitch": {"pitch": pitch + 1},
              "short_pitch": {"pitch": (lb_max + 31) // 4},
              "walk_row_up": {"walk_row": -1},
              "walk_row_down": {"walk_row": 1}}[mutant]
    with pytest.raises(AssertionError):
        _kres_model(pssm, la, lb, seq, GO, GE, **kwargs)


@pytest.mark.parametrize("la_max,lb_max,warps", [(96, 96, 4), (320, 320, 8),
                                                 (333, 150, 11)])
def test_resident_plan_fits_the_card(la_max, lb_max, warps):
    """At the main path's 96 x 96 and 320 x 320 and a ragged shape, the
    plan's warps and shared memory fit an H100's 232,448 bytes a block, one
    warp more would not, and the strip schedule of those warps finishes."""
    limit = gotoh_plan.H100_SMEM_OPTIN
    assert gotoh_plan.resident_warps(la_max, lb_max, limit) == warps
    assert gotoh_plan.resident_bytes(la_max, lb_max, warps) <= limit == 232448
    if warps < min(16, (la_max + 32) // 32):
        assert gotoh_plan.resident_bytes(la_max, lb_max, warps + 1) > limit
    assert gotoh_plan.schedule_safe(la_max, lb_max, warps)
    pitch = gotoh_plan.resident_pitch(lb_max)
    # the last word a lane stores is (lb + 31) // 4
    assert pitch % 2 == 1 and pitch > (lb_max + 31) // 4

"""How KI-head and KI-lines spread a lane over several CTAs (CPU).

On the card KI-head runs a lane in tiles with a halo of 2**steps - 1
entries on each side over a packed, loop-invariant run mask, and KI-lines
runs a lane as a thread-block cluster whose ranks own shares of the
entries, slots and queue columns (``csrc/iteration.cu``,
``lara_tpu_torch.solver.iteration_cuda``).  The kernels run only on the
card; these tests hold NumPy models of the two decompositions, made the
way the kernels decompose, against the plain versions
(``device_solver.head_plain``, ``lines_plain``) and the JAX package's
``_run_top`` / ``_same_segment_masks``; the packed mask against both
packages' masks, also after an entry reloads a new model; and the
wrappers' tile and cluster choosers.  Zero tolerance throughout.  ``tests/test_torch_cuda.py``
holds the kernels themselves on a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lara_tpu.solver import device_solver as jax_solver
from lara_tpu_torch.solver import device_solver, dispatch_graph
from lara_tpu_torch.solver import iteration_cuda
from lara_tpu_torch.types import INFINITY

from tests.test_torch_cuda import iteration_case, iteration_tensors
from tests.test_torch_dispatch_graph import RecordingGraph

CPU = torch.device("cpu")
NEG_INF = -int(INFINITY)
#: the H100's SMs
SMS = 132


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for key in ("LARA_CHUNK", "LARA_DP_GRID", "LARA_DP_RESIDENT"):
        monkeypatch.delenv(key, raising=False)
    dispatch_graph.release()
    yield
    dispatch_graph.release()


# ---- KI-head: the tiled scan -------------------------------------------


def _keys(p, idx):
    """The kernel's 64-bit queue-top keys: the profit biased to unsigned
    order above the complement of the index (larger key = the winner)."""
    hi = (p.astype(np.int64) & 0xFFFFFFFF) ^ 0x80000000
    lo = ~idx.astype(np.int64) & 0xFFFFFFFF
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


def _unkey(key):
    p = ((key >> np.uint64(32)).astype(np.int64) ^ 0x80000000)
    p = ((p + 2**31) % 2**32 - 2**31).astype(np.int32)
    idx = (~(key & np.uint64(0xFFFFFFFF)).astype(np.int64)) & 0xFFFFFFFF
    return p, ((idx + 2**31) % 2**32 - 2**31).astype(np.int32)


def tiled_run_top(masked, seg_mask, steps, tile, halo=None):
    """KI-head's scan as the kernel runs it: each tile of ``tile`` entries
    of a lane over its extended tile (``halo`` entries on each side,
    clipped to the lane; 2**steps - 1 by default), the forward and the
    backward passes side by side, a neighbour outside the extended tile
    taken as the fill; only the tile's own entries kept.  Returns
    (run_p, run_idx)."""
    b, d = masked.shape
    halo = 2 ** steps - 1 if halo is None else halo
    fill = _keys(np.array([NEG_INF]), np.array([d]))[0]
    run_p = np.zeros((b, d), np.int32)
    run_idx = np.zeros((b, d), np.int32)
    for k in range(b):
        keys = _keys(masked[k], np.arange(d))
        for own_lo in range(0, d, tile):
            own_hi = min(d, own_lo + tile)
            lo, hi = max(0, own_lo - halo), min(d, own_hi + halo)
            f = keys[lo:hi].copy()
            g = keys[lo:hi].copy()
            m = seg_mask[k, lo:hi]
            n = hi - lo
            for p in range(steps):
                s = 1 << p
                left = np.full(n, fill)
                right = np.full(n, fill)
                if s < n:
                    left[s:] = f[:n - s]
                    right[:n - s] = g[s:]
                f = np.maximum(f, np.where((m >> (2 * p)) & 1 == 1, left,
                                           fill))
                g = np.maximum(g, np.where((m >> (2 * p + 1)) & 1 == 1,
                                           right, fill))
            top = np.maximum(f, g)[own_lo - lo:own_hi - lo]
            run_p[k, own_lo:own_hi], run_idx[k, own_lo:own_hi] = _unkey(top)
    return run_p, run_idx


def _head_case(seed, d, hub, first_edge_zero=False):
    """A random ragged lane batch (``iteration_case``); with
    ``first_edge_zero`` each lane's first run is edge 0, which the padding
    after the valid entries (dual_l 0) then joins in the masks."""
    model, carry, partner = iteration_case(4, 24, 20, d, seed, hub=hub)
    if first_edge_zero:
        for k in range(len(model["dual_l"])):
            row = model["dual_l"][k]
            row[row == row[0]] = 0
    return model, carry, partner


def _masked(model, carry):
    return np.where(model["dvalid"], model["sscore"] + carry["dual"],
                    NEG_INF).astype(np.int32)


# (seed, D, hub, scan_steps, tile, first_edge_zero): depths 1, 2, 3 and
# full; tiles below, equal to and above the halo, down to one entry, and
# one tile per lane; runs of 25-60 entries across tile edges; padding that
# joins the first run; profits that tie (six interaction scores)
TILE_CASES = [
    (1, 160, 40, 1, 1, False), (2, 160, 40, 1, 7, False),
    (3, 160, 40, 2, 3, False), (4, 160, 40, 2, 5, True),
    (5, 200, 60, 3, 7, False), (6, 200, 60, 3, 20, True),
    (7, 200, 25, 4, 15, False), (8, 200, 25, 4, 16, False),
    (9, 300, 60, 5, 31, True), (10, 300, 60, 5, 77, False),
    (21, 256, 30, 0, 64, True), (19, 256, 30, 0, 256, True),
    (13, 100, 0, 0, 300, False), (14, 333, 50, 6, 40, True),
]


@pytest.mark.parametrize("seed,d,hub,scan_steps,tile,zero", TILE_CASES)
def test_tiled_head_scan_is_the_run_top(seed, d, hub, scan_steps, tile,
                                        zero):
    """Every tile of the tiled scan over its halo gives, at its own
    entries, ``head_plain``'s run top and the JAX ``_run_top`` over the JAX
    ``_same_segment_masks``: also where a run crosses tile edges, where
    2**steps does not cover a run, where the padding joins the first run,
    and for tiles narrower than the halo."""
    case = _head_case(seed, d, hub, zero)
    tm, tc, _ = iteration_tensors(case, CPU)
    st = device_solver._prepare(tm, 24, 20, scan_steps)
    steps = len(st.same_masks)
    head = device_solver.head_plain(tm, st, tc)
    masked = _masked(case[0], case[1])
    got_p, got_idx = tiled_run_top(masked, st.seg_mask.numpy(), steps, tile)
    np.testing.assert_array_equal(got_p, head.run_p.numpy())
    np.testing.assert_array_equal(got_idx, head.run_idx.numpy())
    jax_masks = jax_solver._same_segment_masks(
        jnp.asarray(case[0]["dual_l"]), steps)
    want_p, want_idx = jax_solver._run_top(
        jnp.asarray(masked),
        jnp.broadcast_to(jnp.arange(d, dtype=jnp.int32), masked.shape),
        jax_masks, np.int32(NEG_INF), np.int32(d))
    np.testing.assert_array_equal(got_p, np.asarray(want_p))
    np.testing.assert_array_equal(got_idx, np.asarray(want_idx))
    np.testing.assert_array_equal(
        head.is_top.numpy(), case[0]["dvalid"] & (masked == got_p))
    if zero and not scan_steps:
        # some padding entry's mask joins a valid entry of the first run
        valid = case[0]["dvalid"]
        joins = [(~valid[:, s:] & valid[:, :-s]
                  & ((st.seg_mask.numpy()[:, s:] >> (2 * k)) & 1 == 1)).any()
                 for k, s in enumerate(2 ** np.arange(steps)) if s < d]
        assert any(joins)


def test_tiled_head_scan_needs_the_whole_halo():
    """A halo of 2**steps - 2 entries, one short, gives another run top on
    some entry of the generated cases: the halo is not larger than it must
    be."""
    differs = 0
    for seed, d, hub, scan_steps, tile, zero in TILE_CASES:
        if not scan_steps:
            continue
        case = _head_case(seed, d, hub, zero)
        tm, _, _ = iteration_tensors(case, CPU)
        st = device_solver._prepare(tm, 24, 20, scan_steps)
        steps = len(st.same_masks)
        masked = _masked(case[0], case[1])
        mask = st.seg_mask.numpy()
        want = tiled_run_top(masked, mask, steps, tile)
        short = tiled_run_top(masked, mask, steps, tile, 2 ** steps - 2)
        differs += not (np.array_equal(short[0], want[0])
                        and np.array_equal(short[1], want[1]))
    assert differs >= 1


# ---- KI-head: the packed mask ------------------------------------------


@pytest.mark.parametrize("seed,d,hub,scan_steps",
                         [(21, 64, 0, 0), (22, 160, 40, 2), (23, 300, 60, 5),
                          (24, 1024, 30, 0)])
def test_packed_mask_is_both_packages_masks(seed, d, hub, scan_steps):
    """Bit 2k of ``seg_mask`` is ``same_masks[k][0]`` (the left neighbour
    2^k away in the run), bit 2k + 1 ``same_masks[k][1]``, in this package
    and in the JAX package; no bit above 2 * steps."""
    case = _head_case(seed, d, hub, first_edge_zero=seed % 2 == 0)
    tm, _, _ = iteration_tensors(case, CPU)
    st = device_solver._prepare(tm, 24, 20, scan_steps)
    steps = len(st.same_masks)
    packed = st.seg_mask.numpy()
    assert st.seg_mask.dtype == torch.int64
    jax_masks = jax_solver._same_segment_masks(
        jnp.asarray(case[0]["dual_l"]), steps)
    for k, ((r, l), (jr, jl)) in enumerate(zip(st.same_masks, jax_masks)):
        np.testing.assert_array_equal((packed >> (2 * k)) & 1, r.numpy())
        np.testing.assert_array_equal((packed >> (2 * k + 1)) & 1, l.numpy())
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(l.numpy(), np.asarray(jl))
    assert (packed >> (2 * steps) == 0).all()


def test_packed_mask_follows_spliced_models(monkeypatch):
    """A dispatch graph's entry keeps the packed mask as an invariant of its
    model: when the next dispatch of its key brings a new model (two lanes
    holding new pairs) and a fresh carry, as the next chunk of a bucket
    does, its KI-head reads the mask of the new model, in place."""
    monkeypatch.setattr(dispatch_graph, "Graph", RecordingGraph)
    seen = []
    real = device_solver.head_plain

    def spy(model, st, c):
        seen.append(st)
        return real(model, st, c)

    monkeypatch.setattr(device_solver, "head_plain", spy)
    case = iteration_case(4, 30, 26, 200, 31, hub=12)
    new_rows = iteration_case(4, 30, 26, 200, 32, hub=40)[0]
    model = iteration_tensors(case, CPU)[0]
    fresh = device_solver._init_carry(4, 200, 30, np.float32(1.0), 50, CPU)
    go, ge = -49152, -16384
    device_solver.solve_batch_chunk(model, fresh, go, ge, 30, 26, 3, 5, 5, 3)
    (entry,) = dispatch_graph._entries
    mask_before = entry.st.seg_mask
    old = mask_before.clone()
    lanes = [0, 2]
    model2 = device_solver.BatchModel(*(
        arr.index_copy(0, torch.tensor(lanes),
                       torch.from_numpy(new_rows[f])[lanes])
        for f, arr in zip(device_solver.BatchModel._fields, model)))
    carry2 = device_solver._init_carry(4, 200, 30, np.float32(1.0), 50, CPU)
    device_solver.solve_batch_chunk(model2, carry2, go, ge, 30, 26, 1, 5, 5,
                                    3)
    (entry,) = dispatch_graph._entries
    assert seen[-1] is entry.st and entry.st.seg_mask is mask_before
    want = device_solver._packed_mask(
        device_solver._same_segment_masks(model2.dual_l, 3))
    assert torch.equal(entry.st.seg_mask, want)
    assert not torch.equal(old[lanes], want[lanes])
    assert torch.equal(old[[1, 3]], want[[1, 3]])


# ---- KI-lines: the cluster split ---------------------------------------


def _in_lines(part, e, lb_max):
    a = e // lb_max
    ok = (e >= 0) & (a < len(part))
    return ok & (part[np.clip(a, 0, len(part) - 1)] == e - a * lb_max)


def cluster_lines(model, st, carry, head, partner, lb_max, cluster):
    """KI-lines as a cluster of ``cluster`` CTAs per lane runs it, rank by
    rank (numpy): each rank's own entries, slots and queue columns
    (``iteration_cuda.lines_split``); the reverse entry's pick from a
    gather of its inputs; each rank's partial sg_pos count and consistent
    sum, and its own slot marks, which the other ranks read after the
    cluster barrier (each adds up the partials, each slot's owner ORs the
    ranks' marks); K3's candidates tested before the barrier, ``live``
    applied after it."""
    f = {k: v.numpy() for k, v in model._asdict().items()}
    run_p, run_idx = head.run_p.numpy(), head.run_idx.numpy()
    is_top = head.is_top.numpy()
    dual = carry.dual.numpy()
    lq, mq, nc = st.lq.numpy(), st.mq.numpy(), st.nc_base.numpy()
    act = carry.lane_active.numpy()
    partner = partner.numpy()
    b, d = f["dual_l"].shape
    slots, cw = partner.shape[1], lq.shape[1]
    ne = f["seq_score"].shape[1]
    dper, sper, qper = iteration_cuda.lines_split(d, slots, cw, cluster)
    out = dict(slot_edge=np.zeros((b, slots), np.int32),
               sg=np.zeros((b, d), np.int32), count=np.zeros(b, np.int32),
               consistent_sum=np.zeros(b, np.int32),
               matched_cons_slot=np.zeros((b, slots), bool),
               cand_q=np.zeros((b, cw), bool))

    def own(rank, per, n):
        lo = min(n, rank * per)
        return lo, min(n, lo + per)

    def wrap(x):
        x %= 2**32
        return x - 2**32 if x >= 2**31 else x

    for k in range(b):
        part = partner[k]
        l_in = _in_lines(part, f["dual_l"][k], lb_max)
        pick = l_in & (run_p[k] >= 0) & is_top[k]
        marks = np.zeros((cluster, slots), bool)
        partials, cands = [], []
        for rank in range(cluster):
            lo, hi = own(rank, sper, slots)
            s = np.arange(lo, hi)
            out["slot_edge"][k, lo:hi] = np.where(part[lo:hi] >= 0,
                                                  s * lb_max + part[lo:hi],
                                                  ne)
            lo, hi = own(rank, qper, cw)
            cands.append((np.arange(lo, hi) < nc[k])
                         & _in_lines(part, lq[k, lo:hi], lb_max)
                         & _in_lines(part, mq[k, lo:hi], lb_max))
            lo, hi = own(rank, dper, d)
            pos, csum = 0, 0
            for i in range(lo, hi):
                r = f["rev"][k, i]
                p_rev = 0 <= r < d and bool(
                    _in_lines(part, f["dual_l"][k, r], lb_max)
                    and run_p[k, r] >= 0 and is_top[k, r])
                p = pick[i]
                out["sg"][k, i] = int(p and not p_rev) - int(p_rev and not p)
                pos += p and not p_rev
                profit = int(f["sscore"][k, i]) + int(dual[k, i])
                l, m = f["dual_l"][k, i], f["dual_m"][k, i]
                tis = profit < 0 or (profit == 0 and l < m)
                if f["dvalid"][k, i] and i == run_idx[k, i] and l_in[i] \
                        and not tis:
                    csum += int(f["sscore"][k, i])
                    marks[rank, l // lb_max] = True
                    if _in_lines(part, m, lb_max):
                        marks[rank, m // lb_max] = True
            partials.append((pos, csum))
        # ---- the cluster barrier: every rank reads the others' partials
        # and its slots' marks ----
        count = wrap(2 * sum(p for p, _ in partials))
        out["count"][k] = count
        out["consistent_sum"][k] = wrap(sum(c for _, c in partials))
        live = count > 0 and act[k]
        for rank in range(cluster):
            lo, hi = own(rank, sper, slots)
            out["matched_cons_slot"][k, lo:hi] = (part[lo:hi] >= 0) \
                & marks[:, lo:hi].any(0)
            lo, hi = own(rank, qper, cw)
            out["cand_q"][k, lo:hi] = live & cands[rank]
    return out


# (b, la_max, lb_max, d, seed, hub): D, the queue width D // 2 and the
# slots not multiples of 3 or 8; a 40-partner run; a lane batch of one
@pytest.mark.parametrize("cluster", [1, 2, 3, 8])
@pytest.mark.parametrize("b,la_max,lb_max,d,seed,hub",
                         [(3, 21, 17, 150, 41, 0), (2, 37, 30, 301, 42, 40),
                          (1, 13, 11, 45, 43, 5)])
def test_cluster_split_is_lines_plain(b, la_max, lb_max, d, seed, hub,
                                      cluster):
    """The cluster split of KI-lines, rank by rank, gives ``lines_plain``'s
    every output."""
    case = iteration_case(b, la_max, lb_max, d, seed, hub=hub)
    tm, tc, partner = iteration_tensors(case, CPU)
    st = device_solver._prepare(tm, la_max, lb_max, 0)
    head = device_solver.head_plain(tm, st, tc)
    want = device_solver.lines_plain(tm, st, tc, head, partner, lb_max)
    got = cluster_lines(tm, st, tc, head, partner, lb_max, cluster)
    for name in device_solver._Lines._fields:
        np.testing.assert_array_equal(got[name],
                                      getattr(want, name).numpy(),
                                      err_msg=name)
    assert (want.count > 0).any() and want.matched_cons_slot.any()


@pytest.mark.parametrize("cluster", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("d,slots,cw", [(1024, 96, 512), (3072, 1536, 1536),
                                        (301, 37, 150), (5, 3, 2)])
def test_lines_split_covers_every_entry_once(d, slots, cw, cluster):
    """The ranks' shares of entries, slots and queue columns cover each
    range once, in rank order."""
    dper, sper, qper = iteration_cuda.lines_split(d, slots, cw, cluster)
    for per, n in ((dper, d), (sper, slots), (qper, cw)):
        assert per * cluster >= n
        owned = np.concatenate([np.arange(min(n, r * per),
                                          min(n, r * per + per))
                                for r in range(cluster)])
        np.testing.assert_array_equal(owned, np.arange(n))


# ---- the choosers -------------------------------------------------------


# (b, d, steps): the tRNA, ~300 nt and 16S chunks at the depths their
# longest runs give (2**steps covers a run of up to 16 or 64 entries)
BENCH = [(128, 1024, 4), (32, 1024, 4), (32, 1024, 6), (32, 3072, 4),
         (32, 3072, 6)]


@pytest.mark.parametrize("b,d,steps", BENCH)
def test_head_grid_fills_the_sms_at_the_bench_shapes(b, d, steps):
    """At the bench chunks' shapes KI-head's tiles give every SM two CTAs,
    each tile at least twice its halo and the tiles covering the lane."""
    grid = iteration_cuda.head_grid(b, d, steps, SMS)
    assert grid.ctas >= 2 * SMS - b and grid.tiles > 1
    assert grid.tile >= 2 * grid.halo == 2 * (2 ** steps - 1)
    assert grid.tiles * grid.tile >= d > (grid.tiles - 1) * grid.tile
    assert grid.span == min(d, grid.tile + 2 * grid.halo)
    assert grid.ctas == b * grid.tiles


@pytest.mark.parametrize("b,d,steps", [(32, 3072, 12), (128, 1024, 10),
                                       (32, 1024, 9), (4, 200, 7)])
def test_head_grid_keeps_one_cta_per_lane_under_a_wide_halo(b, d, steps):
    """Where the halo is wider than half the lane (full depth, or nearly),
    KI-head runs one CTA per lane over the whole lane."""
    grid = iteration_cuda.head_grid(b, d, steps, SMS)
    assert (grid.tiles, grid.tile, grid.span, grid.ctas) == (1, d, d, b)


def test_head_grid_takes_a_fixed_tile():
    """A tile given is taken as it is, clipped to the lane."""
    assert iteration_cuda.head_grid(2, 100, 3, SMS, tile=7) == \
        iteration_cuda.HeadGrid(7, 7, 15, 21, 30)
    assert iteration_cuda.head_grid(2, 100, 3, SMS, tile=500).tiles == 1


@pytest.mark.parametrize("b,d,cluster", [(128, 1024, 1), (32, 1024, 1),
                                         (32, 3072, 6), (128, 3072, 2),
                                         (1, 8192, 8), (500, 3072, 1),
                                         (3, 1025, 3)])
def test_lines_grid_takes_clusters_for_long_lanes(b, d, cluster):
    """KI-lines runs one CTA per lane up to 1024 entries (the tRNA and
    ~300 nt chunks), and beyond that a cluster of 512 entries a CTA (the
    16S chunk: 6), at most 8 CTAs and two CTAs an SM."""
    grid = iteration_cuda.lines_grid(b, d, 1536, d // 2, SMS)
    assert grid.cluster == cluster
    assert grid.ctas == b * grid.cluster
    assert grid.dper * grid.cluster >= d


@pytest.mark.parametrize("b", [1, 2, 3, 16, 32, 40, 128, 132, 500])
@pytest.mark.parametrize("d", [64, 1024, 1025, 3072, 8192, 100000])
def test_lines_grid_never_takes_more_than_8(b, d):
    grid = iteration_cuda.lines_grid(b, d, 1536, 1536, SMS)
    assert 1 <= grid.cluster <= iteration_cuda.MAX_CLUSTER == 8
    assert grid.cluster == 1 or grid.ctas <= 2 * SMS


def test_lines_grid_refuses_clusters_above_8():
    with pytest.raises(ValueError, match="1 to 8"):
        iteration_cuda.lines_grid(4, 64, 8, 32, SMS, cluster=9)
    assert iteration_cuda.lines_grid(4, 64, 8, 32, SMS, cluster=3).cluster \
        == 3


def _tail_reach(grid, d, slots):
    """How often KI-tail's threads, as the kernel indexes them, touch each
    dual entry and each line slot of a lane: thread x its four from 4x,
    then every 4 * threads further, each of the four below the row's
    end."""
    reach = []
    for n in (d, slots):
        hits = np.zeros(n, np.int64)
        for x in range(grid.threads):
            for i in range(4 * x, n, 4 * grid.threads):
                hits[i:min(i + 4, n)] += 1
        reach.append(hits)
    return reach


@pytest.mark.parametrize("d,slots", [(1, 1), (3, 7), (4, 4), (64, 20),
                                     (300, 33), (1021, 33), (1024, 96),
                                     (1024, 320), (3072, 1536), (4097, 5),
                                     (5, 4097), (8192, 4100)])
def test_tail_grid_covers_every_entry_once(d, slots):
    """KI-tail's grid at any D and slots: one CTA per lane, whole warps of
    32 to 1024 threads with a quad each of the longer row up to 1024
    threads, and every entry and slot reached by exactly one thread."""
    grid = iteration_cuda.tail_grid(7, d, slots)
    assert grid.ctas == 7
    assert grid.threads % 32 == 0
    assert grid.threads == min(iteration_cuda.TAIL_MAX_THREADS,
                               max(32, -(-max(-(-d // 4), -(-slots // 4))
                                         // 32) * 32))
    for hits in _tail_reach(grid, d, slots):
        assert (hits == 1).all()


@pytest.mark.parametrize("d,slots,aligned,vec", [
    (1024, 96, True, True), (3072, 1536, True, True),
    (1024, 96, False, False), (1021, 96, True, False),
    (1024, 33, True, False), (2, 4, True, False), (4, 4, True, True)])
def test_tail_grid_loads_16_bytes_only_on_aligned_rows(d, slots, aligned,
                                                       vec):
    """16-byte loads where D and the slots are multiples of 4 and the rows
    16-byte aligned (every entry's row then starts on 16 bytes, and every
    thread's quad too); else the scalar path."""
    grid = iteration_cuda.tail_grid(2, d, slots, aligned)
    assert grid.vec is vec
    if grid.vec:
        assert (d * 4) % 16 == 0 and slots % 4 == 0

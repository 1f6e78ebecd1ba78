"""Operation and byte counts of K1 and K3 on hand-sized cases, the share
of the roofline, and the trace's reductions on hand-made events."""

import pytest

from gpubench import roofline
from gpubench.trace import Chunk, K1, Tracer, _idle_by_span, _merge, \
    kernel_family, short_name


def test_k1_counts_a_lanes_cells():
    # 2 x 3 cells: 13 operations and 5 bytes each, 20 bytes of the lane
    assert roofline.k1_call([(2, 3)]) == roofline.Work(78, 50)
    # a padding lane is a 1 x 1 problem
    assert roofline.k1_call([(2, 3), (1, 1)]) == roofline.Work(91, 75)
    w = roofline.k1_call([(1530, 1530)] * 32)
    assert w.ops == 13 * 32 * 1530 * 1530


def test_k3_counts_the_queue():
    # 10 directed duals: 5 candidates of 13 bytes, and the lane's score
    assert roofline.k3_call([10]) == roofline.Work(0, 5 * 13 + 4)
    assert roofline.k3_call([0, 0]) == roofline.Work(0, 8)


def test_the_share_takes_the_larger_bound():
    peak = roofline.peak_int_ops(132, 1980)
    assert peak == 132 * 64 * 2 * 1980e6
    # bytes bound: 3.35e9 bytes take 1 ms at 3.35 TB/s
    share, bound = roofline.share(roofline.Work(1.0, 3.35e9), 2e-3, 132,
                                  1980)
    assert bound == "bytes" and share == pytest.approx(50.0)
    share, bound = roofline.share(roofline.Work(peak * 1e-3, 0.0), 4e-3,
                                  132, 1980)
    assert bound == "ops" and share == pytest.approx(25.0)


def test_kernel_names():
    k1 = ("void (anonymous namespace)::dp_wave_kernel<false, false, false>"
          "(int const*, int*, int)")
    assert short_name(k1) == K1 and kernel_family(k1) == K1
    k3 = "(anonymous namespace)::matching_rounds_kernel<true>(int const*)"
    assert kernel_family(k3) == "matching_rounds_kernel"
    assert kernel_family("void at::native::reduce_kernel<512, 1>(int)") \
        == "at::native::reduce_kernel"


def test_union_and_gaps():
    busy, gaps = _merge([(0, 10, "a"), (5, 20, "b"), (30, 40, "c")], 0, 50)
    assert busy == pytest.approx(30e-9)
    assert gaps == [(20, 30), (40, 50)]


def test_idle_time_by_the_innermost_span():
    spans = [(0, 50, "gpubench.job"), (25, 45, "phase:x")]
    got = dict(_idle_by_span([(20, 30), (40, 50)], spans))
    assert got == pytest.approx({"gpubench.job": 10e-9, "phase:x": 10e-9})


def test_a_kernel_is_the_work_of_the_last_launch_before_it():
    import torch

    tracer = Tracer(torch.device("cpu"))
    big, small = Chunk([(72, 72)] * 2, [100, 50]), Chunk([(10, 10)], [8])
    tracer.launches = [(100, big), (200, big), (500, small)]
    device = [(50, 60, K1, ""), (110, 120, K1, ""), (210, 230, K1, ""),
              (510, 515, K1, ""), (520, 530, "other", "")]
    seen = tracer._seen(device, K1, lambda c: roofline.k1_call(c.lanes))
    assert seen.calls == 3  # the one before any launch is not placed
    assert seen.seconds == pytest.approx(35e-9)
    assert seen.work.ops == 2 * 13 * 2 * 72 * 72 + 13 * 100

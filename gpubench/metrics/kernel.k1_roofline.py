"""kernel.k1_roofline: K1's share of its roofline (``gpubench/roofline.py``)
over the window: the operations and bytes of the K1 calls
(``dp_wave_kernel<false, false, false>``) that the profiler saw, each from
the lanes of the chunk it ran for, against the profiler's time of those
calls, at the highest SM clock read beside the window.  Nothing where the
profiler saw no call or no clock was read."""

from gpubench import roofline


def read(window):
    t = window.trace
    if t is None or not t.k1.calls or not t.clocks_mhz:
        return None
    value, _ = roofline.share(t.k1.work, t.k1.seconds, t.sms,
                              max(t.clocks_mhz))
    return value

"""kernel.k3_roofline: K3's share of its roofline (``gpubench/roofline.py``,
bound by bytes) over the window: the bytes of the K3 calls
(``matching_rounds_kernel``) that the profiler saw, each from the lanes of
the chunk it ran for, against the profiler's time of those calls.  Nothing
where the profiler saw no call or no clock was read."""

from gpubench import roofline


def read(window):
    t = window.trace
    if t is None or not t.k3.calls or not t.clocks_mhz:
        return None
    value, _ = roofline.share(t.k3.work, t.k3.seconds, t.sms,
                              max(t.clocks_mhz))
    return value

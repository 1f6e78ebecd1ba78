"""device.idle_share: the share of the traced window in which nothing ran
on the card, in %: 1 - busy / window, busy being the union of the spans of
the dispatches' graphs (each from its first kernel, for its CUDA events'
time) and of every other device operation the profiler saw."""


def read(window):
    t = window.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)

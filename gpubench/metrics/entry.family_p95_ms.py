"""entry.family_p95_ms: the 95th percentile of a family job's wall
(``app.run`` until its library is written) over the traced window's jobs,
in ms, as ``family_p95_ms`` is taken in an untraced run; a per-layer
reading in the cells where the host's pace spreads that tail too widely
for an end-to-end bound."""

from gpubench.harness import p95


def read(window):
    if not window.jobs:
        return None
    return p95([1e3 * j.wall_s for j in window.jobs])

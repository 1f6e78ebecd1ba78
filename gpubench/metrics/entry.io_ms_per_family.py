"""entry.io_ms_per_family: the entry's own host work per family job, the
program's phases "read input" and "write results" (``app.py``), in ms, the
mean over the window's jobs."""


def read(window):
    if not window.jobs:
        return None
    return 1e3 * sum(j.phases.get("read input", 0.0)
                     + j.phases.get("write results", 0.0)
                     for j in window.jobs) / len(window.jobs)

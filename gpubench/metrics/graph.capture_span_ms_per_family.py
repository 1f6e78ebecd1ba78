"""graph.capture_span_ms_per_family: the program's own phase "graph
capture" (``solver/dispatch_graph.py``), the capture of an iteration and
the loop graph around it, summed over the window and divided by its jobs,
in ms: the in-program twin of ``graph.capture_ms_per_family``."""


def read(window):
    spans = sum(j.phases.get("graph capture", 0.0) for j in window.jobs)
    if not window.jobs or not spans:
        return None
    return 1e3 * spans / len(window.jobs)

"""graph.capture_ms_per_family: host time in
``dispatch_graph.CudaGraph.capture`` (the capture of an iteration and the
loop graph around it), summed over the window and divided by its jobs, in
ms."""


def read(window):
    if window.trace is None or not window.jobs:
        return None
    return 1e3 * sum(window.trace.capture_s) / len(window.jobs)

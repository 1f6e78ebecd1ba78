"""solver.launch_ms_per_family: the host's side of the solve's
dispatches, the program's phase "dispatch (host)" less the "graph
capture" and "graph warm-up" inside it (``solver/dispatch_graph.py``):
copies into the graph's buffers, the launch and the carry's clone, summed
over the window and divided by its jobs, in ms."""


def read(window):
    dispatch = sum(j.phases.get("dispatch (host)", 0.0) for j in window.jobs)
    if not window.jobs or not dispatch:
        return None
    inside = sum(j.phases.get("graph capture", 0.0)
                 + j.phases.get("graph warm-up", 0.0) for j in window.jobs)
    return 1e3 * (dispatch - inside) / len(window.jobs)

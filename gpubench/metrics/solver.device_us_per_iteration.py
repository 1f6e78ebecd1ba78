"""solver.device_us_per_iteration: device time of the fused solver's
dispatches (CUDA events around every ``CudaGraph.replay``) over the batch
iterations they ran (the settled launches of K3, one an iteration), in us.
Each batch iteration is one iteration of every lane of a chunk."""


def read(window):
    if window.trace is None or not window.iterations:
        return None
    return 1e6 * window.trace.replay_s / window.iterations

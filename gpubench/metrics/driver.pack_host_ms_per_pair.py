"""driver.pack_host_ms_per_pair: the host's packed buffer of a chunk's
models, the program's phase "model packing: host buffer" inside "model
packing (host)" (``solver/device_driver.py``), without the upload and
unpack that follow it, in ms per pair solved in the window."""


def read(window):
    pairs = sum(j.pairs for j in window.jobs)
    spans = sum(j.phases.get("model packing: host buffer", 0.0)
                for j in window.jobs)
    if not pairs or not spans:
        return None
    return 1e3 * spans / pairs

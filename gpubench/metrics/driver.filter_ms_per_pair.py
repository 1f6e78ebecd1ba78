"""driver.filter_ms_per_pair: the edge filter (K4 on the card, its upload
and download), the program's phase "edge filter (device)"
(``solver/device_driver.py``), in ms per pair solved in the window."""


def read(window):
    pairs = sum(j.pairs for j in window.jobs)
    if not pairs:
        return None
    return 1e3 * sum(j.phases.get("edge filter (device)", 0.0)
                     for j in window.jobs) / pairs

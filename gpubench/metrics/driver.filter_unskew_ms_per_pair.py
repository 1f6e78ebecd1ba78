"""driver.filter_unskew_ms_per_pair: the host's unpacking of the edge
filter's words, the program's phase "edge filter: unskew (host)" inside
"edge filter (device)" (``solver/device_driver.py``), in ms per pair
solved in the window."""


def read(window):
    pairs = sum(j.pairs for j in window.jobs)
    spans = sum(j.phases.get("edge filter: unskew (host)", 0.0)
                for j in window.jobs)
    if not pairs or not spans:
        return None
    return 1e3 * spans / pairs

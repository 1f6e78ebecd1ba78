"""driver.postprocess_ms_per_pair: the host's postprocessing of a solved
lane into its library columns, the program's phase "result postprocess
(host)" (``solver/device_driver.py``), in ms per pair solved in the
window."""


def read(window):
    pairs = sum(j.pairs for j in window.jobs)
    spans = sum(j.phases.get("result postprocess (host)", 0.0)
                for j in window.jobs)
    if not pairs or not spans:
        return None
    return 1e3 * spans / pairs

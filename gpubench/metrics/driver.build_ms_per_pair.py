"""driver.build_ms_per_pair: the driver's host interaction build, the
program's phase "interaction build (host)" (``solver/device_driver.py``),
in ms per pair solved in the window."""


def read(window):
    pairs = sum(j.pairs for j in window.jobs)
    if not pairs:
        return None
    return 1e3 * sum(j.phases.get("interaction build (host)", 0.0)
                     for j in window.jobs) / pairs

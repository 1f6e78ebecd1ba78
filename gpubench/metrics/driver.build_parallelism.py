"""driver.build_parallelism: the interaction build's pair spans, the
program's phase "interaction build: pair" on whichever thread built the
pair (``solver/interactions.py``), over the phase "interaction build
(host)" that waits for them (``solver/device_driver.py``), summed over the
window: the mean number of pairs being built at once, at most ``-j``."""


def read(window):
    pairs = sum(j.phases.get("interaction build: pair", 0.0)
                for j in window.jobs)
    build = sum(j.phases.get("interaction build (host)", 0.0)
                for j in window.jobs)
    if not pairs or not build:
        return None
    return pairs / build

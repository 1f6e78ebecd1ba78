"""driver.build_prelude_ms_per_pair: a pair's model build outside the
native call, the program's phase "interaction build: pair" less its
"interaction build: native call" (``solver/interactions.py``): the
Python and NumPy work that holds the interpreter's lock, in ms per pair
solved in the window."""


def read(window):
    pairs = sum(j.pairs for j in window.jobs)
    build = sum(j.phases.get("interaction build: pair", 0.0)
                for j in window.jobs)
    native = sum(j.phases.get("interaction build: native call", 0.0)
                 for j in window.jobs)
    if not pairs or not build or not native:
        return None
    return 1e3 * (build - native) / pairs

"""solver.device_us_per_iteration.card: the reading of
``solver.device_us_per_iteration.py`` in the cells whose end-to-end metric
besides set-up is the card's, ``solve_card_us_per_alignment``, because the
host's pace spreads ``alignments_per_s`` there too widely for its bound."""

from gpubench.harness import read_metric


def read(window):
    return read_metric("solver.device_us_per_iteration", window)

"""kernel.k1_ctas_per_pair.card: the reading of
``kernel.k1_ctas_per_pair.py`` in the cells whose end-to-end metric besides
set-up is the card's, ``solve_card_us_per_alignment``."""

from gpubench.harness import read_metric


def read(window):
    return read_metric("kernel.k1_ctas_per_pair", window)

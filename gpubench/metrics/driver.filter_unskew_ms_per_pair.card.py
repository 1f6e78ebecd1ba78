"""driver.filter_unskew_ms_per_pair.card: the reading of
``driver.filter_unskew_ms_per_pair.py`` in the cells whose end-to-end metric
besides set-up is the card's, ``solve_card_us_per_alignment``, because the
host's pace spreads ``alignments_per_s`` there too widely for its bound."""

from gpubench.harness import read_metric


def read(window):
    return read_metric("driver.filter_unskew_ms_per_pair", window)

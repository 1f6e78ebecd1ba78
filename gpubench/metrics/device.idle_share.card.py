"""device.idle_share.card: the reading of ``device.idle_share.py`` in the cells
whose end-to-end metric besides set-up is the card's,
``solve_card_us_per_alignment``, because the host's pace spreads
``alignments_per_s`` there too widely for its bound."""

from gpubench.harness import read_metric


def read(window):
    return read_metric("device.idle_share", window)

"""entry.alignments_per_s: the pairs of every family job completed in the
traced window over the window's wall (its start to the end of its last
job), as ``alignments_per_s`` is taken in an untraced run; a per-layer
reading in the cells where the host's pace spreads that rate too widely
for an end-to-end bound."""


def read(window):
    if not window.jobs or window.wall_s <= 0:
        return None
    return sum(j.pairs for j in window.jobs) / window.wall_s

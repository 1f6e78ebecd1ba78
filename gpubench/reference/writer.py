"""The T-Coffee library writer of ``lara::OutputLibrary``
(``reference/src/io.hpp:372-404``), the benchmark's frozen copy of the port's
``io/writers.py::OutputLibrary.print_lib``: a header with the sequence table,
one ``# i j`` block of 1-based ``pos1 pos2 weight`` rows per pair in the
canonical sort order of the result set, and a footer."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


def header(records: Sequence) -> str:
    """The library's lines before the first pair's block."""
    lines = ["! T-COFFEE_LIB_FORMAT_01", str(len(records))]
    lines += [f"{r.name} {len(r.sequence)} {r.sequence}" for r in records]
    return "\n".join(lines) + "\n"


FOOTER = "! SEQ_1_TO_N\n"


def block(seq_indices: Tuple[int, int],
          columns: Sequence[Tuple[int, int, int]]) -> str:
    """One pair's block: ``seq_indices`` ordered, 0-based."""
    i, j = seq_indices
    rows = [f"# {i + 1} {j + 1}"]
    rows += [f"{a + 1} {b + 1} {w}" for (a, b, w) in columns]
    return "\n".join(rows) + "\n"


def library(records: Sequence, results: Sequence) -> str:
    """The whole library of ``results`` (objects with ``seq_indices``,
    ``columns`` and ``score``), in the order of the reference's result set,
    a set sorted by (indices, columns, score) (``io.hpp:372``)."""
    entries = sorted({(tuple(r.seq_indices),
                       tuple(tuple(c) for c in r.columns), int(r.score))
                      for r in results})
    return (header(records) + "".join(block(ix, cols)
                                      for ix, cols, _ in entries) + FOOTER)


def split(text: str) -> Tuple[str, Dict[Tuple[int, int], List[str]], str]:
    """A library's text as (header, {0-based pair: [its blocks]}, footer);
    a pair's blocks in file order, so that a pair written twice shows."""
    head, footer = [], []
    blocks: Dict[Tuple[int, int], List[List[str]]] = {}
    current = None
    for line in text.splitlines(keepends=True):
        if footer or line.startswith("! SEQ_1_TO_N"):
            footer.append(line)
        elif line.startswith("# "):
            _, i, j = line.split()
            current = [line]
            blocks.setdefault((int(i) - 1, int(j) - 1), []).append(current)
        elif current is None:
            head.append(line)
        else:
            current.append(line)
    return ("".join(head),
            {k: ["".join(b) for b in v] for k, v in blocks.items()},
            "".join(footer))

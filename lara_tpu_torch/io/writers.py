"""Output writers: T-Coffee library, MAFFT pairs, aligned fasta.

Mirrors ``lara::OutputLibrary`` (``reference/src/io.hpp:352-496``):

* results are kept in a *set* keyed by ``(columns-structure, score)``; the
  canonical sort order makes the output deterministic regardless of the
  order in which pairwise solves finish (``io.hpp:372``, SURVEY §3.5),
* ``lib`` format: ``! T-COFFEE_LIB_FORMAT_01`` header, sequence table,
  ``# i j`` blocks with 1-based ``pos1 pos2 weight`` rows, ``! SEQ_1_TO_N``
  footer (``io.hpp:387-404``),
* ``pairs``/``fasta``: gapped strings reconstructed from the aligned columns
  (``io.hpp:406-455``); the pairs score is printed as ``score / 8192.f`` with
  C++ ``ostream`` default formatting (6 significant digits -> ``%g``).
"""

from __future__ import annotations

import io as _io
import sys
from typing import List, Sequence, Tuple

import numpy as np

from lara_tpu_torch.types import FACTOR2INT

#: One alignment result: ((seq_idx1, seq_idx2), [(pos1, pos2, weight), ...], score)
AlignmentEntry = Tuple[Tuple[int, int], Tuple[Tuple[int, int, int], ...], int]


class OutputLibrary:
    def __init__(self, records: Sequence, out_format: str = "lib") -> None:
        self.records = records
        self.format = out_format
        self._entries = set()

    def add_alignment(
        self,
        seq_indices: Tuple[int, int],
        columns: Sequence[Tuple[int, int, int]],
        score: int,
    ) -> None:
        """``addAlignment`` (``io.hpp:380-383``). ``seq_indices`` must already
        be ordered (smaller first) as ``getStructureLines`` guarantees."""
        self._entries.add((tuple(seq_indices), tuple(tuple(c) for c in columns), int(score)))

    @property
    def sorted_entries(self) -> List[AlignmentEntry]:
        return sorted(self._entries)

    # -- lib ---------------------------------------------------------------

    def print_lib(self, stream) -> None:
        stream.write("! T-COFFEE_LIB_FORMAT_01\n")
        stream.write(f"{len(self.records)}\n")
        for rec in self.records:
            stream.write(f"{rec.name} {len(rec.sequence)} {rec.sequence}\n")
        for (i, j), columns, _score in self.sorted_entries:
            stream.write(f"# {i + 1} {j + 1}\n")
            for pos1, pos2, weight in columns:
                stream.write(f"{pos1 + 1} {pos2 + 1} {weight}\n")
        stream.write("! SEQ_1_TO_N\n")

    # -- pairs / fasta -------------------------------------------------------

    def _gapped(self, entry: AlignmentEntry) -> Tuple[str, str]:
        """Rebuild the two gapped strings from aligned columns
        (``io.hpp:413-442``)."""
        (i, j), columns, _score = entry
        seq1 = self.records[i].sequence
        seq2 = self.records[j].sequence
        g1, g2 = [], []
        cur1 = cur2 = 0
        for pos1, pos2, _w in columns:
            while cur1 < pos1:
                g1.append(seq1[cur1])
                g2.append("-")
                cur1 += 1
            while cur2 < pos2:
                g1.append("-")
                g2.append(seq2[cur2])
                cur2 += 1
            g1.append(seq1[cur1])
            g2.append(seq2[cur2])
            cur1 += 1
            cur2 += 1
        while cur1 < len(seq1):
            g1.append(seq1[cur1])
            g2.append("-")
            cur1 += 1
        while cur2 < len(seq2):
            g1.append("-")
            g2.append(seq2[cur2])
            cur2 += 1
        return "".join(g1), "".join(g2)

    def print_alignments(self, stream) -> None:
        for entry in self.sorted_entries:
            (i, j), _columns, score = entry
            gapped1, gapped2 = self._gapped(entry)
            rec1, rec2 = self.records[i], self.records[j]
            if self.format == "pairs":
                score_float = np.float32(np.int32(score)) / FACTOR2INT
                stream.write(f">{rec1.name} && {rec2.name} (score {_cpp_g(score_float)})\n")
                stream.write(f"{gapped1}\n{gapped2}\n")
            else:  # fasta
                stream.write(f">{rec1.name}\n{gapped1}\n")
                stream.write(f">{rec2.name}\n{gapped2}\n")

    # -- dispatch -------------------------------------------------------------

    def print(self, target=None) -> None:
        """Write to a filename, a stream, or stdout (``io.hpp:457-489``)."""
        if target is None or target == "":
            self._print_stream(sys.stdout)
        elif isinstance(target, str):
            with open(target, "w", encoding="utf-8") as handle:
                self._print_stream(handle)
        else:
            self._print_stream(target)

    def _print_stream(self, stream) -> None:
        if self.format == "lib":
            self.print_lib(stream)
        else:
            self.print_alignments(stream)

    def to_string(self) -> str:
        buf = _io.StringIO()
        self._print_stream(buf)
        return buf.getvalue()


def _cpp_g(value: np.float32) -> str:
    """C++ ``ostream <<`` default float formatting == printf %g (6 sig digits)."""
    return f"{float(value):g}"


def write_ebpseq(records: Sequence, stream) -> None:
    """Write records in the lara-tpu ebpseq dialect (see readers docstring)."""
    for idx, _rec in enumerate(records, start=1):
        stream.write(f"## S{idx}: {_rec.name}\n")
    stream.write("## M1: base-pair probabilities\n")
    stream.write("## F1: fixed structure\n")
    for idx, rec in enumerate(records, start=1):
        cols = [f"S{idx}"]
        if rec.bpp_edges:
            cols.append("M1")
        if rec.fixed_edges:
            cols.append("F1")
        stream.write("# " + " ".join(cols) + "\n")
        bpp_by_pos: dict = {}
        for (i, j, p) in rec.bpp_edges:
            bpp_by_pos.setdefault(i, []).append((p, j))
            bpp_by_pos.setdefault(j, []).append((p, i))
        fixed_by_pos: dict = {}
        for (i, j, _w) in rec.fixed_edges:
            fixed_by_pos[i] = j
            fixed_by_pos[j] = i
        for pos, base in enumerate(rec.sequence):
            row = [str(pos + 1), base]
            if rec.bpp_edges:
                entries = bpp_by_pos.get(pos)
                if entries:
                    row.append(",".join(f"{p:g}/{q + 1}" for (p, q) in entries))
                else:
                    row.append("-")
            if rec.fixed_edges:
                row.append(str(fixed_by_pos.get(pos, -1) + 1))
            stream.write(" ".join(row) + "\n")

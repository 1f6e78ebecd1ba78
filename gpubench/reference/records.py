"""RNA records and the ebpseq reader, the benchmark's frozen copy of the
port's ``io/records.py`` (``RnaRecord``, ``normalize_rna5``) and of
``io/readers.py::read_ebpseq``: the reference reads the very input file
that the program reads."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

#: Minimum base-pair probability; below this no edge is created
#: (``io.hpp:206,313``).
MIN_PROB = 0.003


@dataclass
class RnaRecord:
    """One RNA sequence with its structure edges ``(i, j, weight)``, 0-based
    i < j; ``sequence`` is Rna5-normalised (``io.hpp:170,196``)."""

    name: str
    sequence: str
    fixed_edges: List[Tuple[int, int, float]] = field(default_factory=list)
    bpp_edges: List[Tuple[int, int, float]] = field(default_factory=list)
    record_id: int = 0

    def __post_init__(self) -> None:
        self.sequence = normalize_rna5(self.sequence)

    @property
    def structure_edges(self) -> List[Tuple[int, int, float]]:
        """bpp if present, else fixed (``lagrange.hpp:259-262``)."""
        return self.bpp_edges if self.bpp_edges else self.fixed_edges

    def __len__(self) -> int:
        return len(self.sequence)


_RNA5_MAP = {}
for _c in "ACGU":
    _RNA5_MAP[_c] = _c
    _RNA5_MAP[_c.lower()] = _c
_RNA5_MAP["T"] = "U"
_RNA5_MAP["t"] = "U"


def normalize_rna5(seq: str) -> str:
    """Uppercase, T->U, everything else (incl. IUPAC ambiguity) -> N."""
    return "".join(_RNA5_MAP.get(c, "N") for c in seq if not c.isspace())


def read_ebpseq(filename: str) -> List[RnaRecord]:
    """Extended bpseq (the lara-tpu dialect): ``## S<n>: name`` headers, a
    ``# S<n> [M<n>] [F<n>]`` column line per record, rows ``<pos> <base>
    [<prob>/<partner>,...] [<partner>]`` with 1-based positions.  Records
    with base-pair edges are used as read (``io.hpp:286-291``); the
    benchmark writes no other kind."""
    header_names: dict = {}
    records: List[RnaRecord] = []
    current = None
    columns: List[str] = []
    with open(filename, "r", encoding="utf-8") as handle:
        for line in handle:
            line = line.strip()
            if not line:
                continue
            if line.startswith("##"):
                body = line[2:].strip()
                if ":" in body:
                    tag, value = body.split(":", 1)
                    header_names[tag.strip()] = value.strip()
                continue
            if line.startswith("#"):
                columns = line[1:].split()
                current = RnaRecord(name=header_names.get(columns[0],
                                                          columns[0]),
                                    sequence="", record_id=len(records))
                records.append(current)
                continue
            if current is None:
                raise ValueError(f"{filename}: data row before record header")
            parts = line.split()
            pos = int(parts[0]) - 1
            current.sequence += parts[1]
            for col_tag, cell in zip(columns[1:], parts[2:]):
                if col_tag.startswith("M"):
                    if cell in ("-", "0"):
                        continue
                    for entry in cell.split(","):
                        prob_str, partner_str = entry.split("/")
                        partner = int(partner_str) - 1
                        if partner > pos:
                            current.bpp_edges.append((pos, partner,
                                                      float(prob_str)))
                elif col_tag.startswith("F"):
                    partner = int(cell) - 1
                    if partner > pos:
                        current.fixed_edges.append((pos, partner, 1.0))
    for record in records:
        record.__post_init__()
        record.bpp_edges.sort()
        record.fixed_edges.sort()
        if not record.bpp_edges and not record.fixed_edges:
            raise ValueError(f"{filename}: record {record.name} has no "
                             "structure; the benchmark writes edges for all")
    if len(records) < 2:
        raise ValueError(f"{filename}: fewer than two records")
    return records

"""Input-file parsers.

Covers the formats the reference accepts (``README.rst:89-99``; SeqAn
``RnaStructFileIn``/``SeqFileIn`` dispatch at ``io.hpp:135-199``):

* structured RNA: dot-bracket (.dbn), Vienna (.dbv), Stockholm (.sth),
  Connect (.ct), Bpseq (.bpseq), extended Bpseq (.ebpseq),
* plain sequence: Fasta/Fastq (and bare ``>``-records, ``io.hpp:178-199``),
* ViennaRNA dotplot PostScript files (``*_dp.ps``), parsed exactly like
  ``extractBppFromDotplot`` (``io.hpp:202-284``).

The ebpseq dialect: SeqAn 2.4's sources are not vendored in the reference
checkout (empty submodule), so lara-tpu documents its dialect explicitly:
header lines ``## S<n>: name``, ``## M<n>: method``, ``## F<n>: method``;
each record starts with a column line ``# S<n> [M<n>] [F<n>]`` followed by
rows ``<pos> <base> [<prob>/<partner>,...] [<partner>]`` with 1-based
positions.  :mod:`lara_tpu_torch.io.writers` emits the same dialect so fixtures
round-trip.
"""

from __future__ import annotations

import math
import os
import re
from typing import List, Tuple

from lara_tpu_torch.io.records import MIN_PROB, LaraInputError, RnaRecord

_OPEN = "([{<"
_CLOSE = ")]}>"


def _open_text(filename: str, errors: str = "strict"):
    """Open a text file, transparently decompressing ``.gz``/``.bz2``
    (the reference links zlib/bzip2 into SeqAn's streams,
    ``CMakeLists.txt:115-117``, so every input format accepts them)."""
    lower = filename.lower()
    if lower.endswith(".gz"):
        import gzip

        return gzip.open(filename, "rt", encoding="utf-8", errors=errors)
    if lower.endswith(".bz2"):
        import bz2

        return bz2.open(filename, "rt", encoding="utf-8", errors=errors)
    return open(filename, "r", encoding="utf-8", errors=errors)


def read_rna_file(filename: str) -> List[RnaRecord]:
    """Dispatch on file extension like SeqAn's file-format guessing;
    a trailing ``.gz``/``.bz2`` is stripped before format detection."""
    if not os.path.exists(filename):
        raise LaraInputError(f"The file {filename} cannot be opened.")
    base = filename
    if base.lower().endswith((".gz", ".bz2")):
        base = os.path.splitext(base)[0]
    ext = os.path.splitext(base)[1].lower()
    if ext in (".dbn", ".dbv"):
        return read_dot_bracket(filename)
    if ext == ".ct":
        return read_connect(filename)
    if ext == ".bpseq":
        return read_bpseq(filename)
    if ext == ".ebpseq":
        return read_ebpseq(filename)
    if ext in (".sth", ".stk", ".sto"):
        return read_stockholm(filename)
    if ext in (".fq", ".fastq"):
        return read_fastq(filename)
    if ext in (".embl",):
        return read_embl(filename)
    if ext in (".gb", ".gbk", ".genbank"):
        return read_genbank(filename)
    if ext in (".raw",):
        return read_raw(filename)
    # io.hpp:178-199 -- final fallback is Fasta
    return read_fasta(filename)


# ---------------------------------------------------------------------------
# dot-bracket / vienna
# ---------------------------------------------------------------------------

def parse_bracket_string(structure: str) -> List[Tuple[int, int, float]]:
    """Bracket string -> fixed edges (i, j, 1.0), i < j, 0-based.

    Supports nested bracket families ``()[]{}<>`` and pseudoknot letters
    ``Aa..Zz`` like SeqAn's dot-bracket reader.
    """
    stacks: dict = {}
    edges: List[Tuple[int, int, float]] = []
    for pos, char in enumerate(structure):
        if char in _OPEN:
            stacks.setdefault(char, []).append(pos)
        elif char in _CLOSE:
            opener = _OPEN[_CLOSE.index(char)]
            stack = stacks.get(opener)
            if not stack:
                raise LaraInputError(f"Unbalanced bracket '{char}' at position {pos + 1}")
            edges.append((stack.pop(), pos, 1.0))
        elif char.isalpha():
            if char.isupper():
                stacks.setdefault(char, []).append(pos)
            else:
                stack = stacks.get(char.upper())
                if not stack:
                    raise LaraInputError(f"Unbalanced bracket '{char}' at position {pos + 1}")
                edges.append((stack.pop(), pos, 1.0))
        # '.', ',', ':', '_' etc. -> unpaired
    for opener, stack in stacks.items():
        if stack:
            raise LaraInputError(f"Unbalanced bracket '{opener}' left open")
    return sorted(edges)


def read_dot_bracket(filename: str) -> List[RnaRecord]:
    """``>name`` / sequence / bracket-string records; energy suffix in
    parentheses after the bracket string is ignored."""
    records: List[RnaRecord] = []
    with _open_text(filename) as handle:
        lines = [ln.rstrip() for ln in handle if ln.strip()]
    idx = 0
    while idx < len(lines):
        if not lines[idx].startswith(">"):
            raise LaraInputError(f"{filename}: expected '>' header, got: {lines[idx]!r}")
        name = lines[idx][1:].strip()
        if idx + 1 >= len(lines):
            raise LaraInputError(f"{filename}: record '{name}' has no sequence")
        sequence = lines[idx + 1].strip()
        structure = ""
        consumed = 2
        if idx + 2 < len(lines) and not lines[idx + 2].startswith(">"):
            structure = lines[idx + 2].strip()
            # strip trailing energy annotation, e.g. "(((...))) (-7.50)"
            match = re.match(r"^(\S+)", structure)
            structure = match.group(1) if match else ""
            consumed = 3
        record = RnaRecord(name=name, sequence=sequence, record_id=len(records))
        if structure and len(structure) != len(record.sequence):
            raise LaraInputError(
                f"{filename}: structure length differs from sequence length for '{name}'"
            )
        if structure:
            record.fixed_edges = parse_bracket_string(structure)
        records.append(record)
        idx += consumed
    return records


# ---------------------------------------------------------------------------
# fasta / fastq
# ---------------------------------------------------------------------------

def read_fasta(filename: str) -> List[RnaRecord]:
    records: List[RnaRecord] = []
    name = None
    chunks: List[str] = []
    with _open_text(filename) as handle:
        for line in handle:
            line = line.rstrip()
            if line.startswith(">"):
                if name is not None:
                    records.append(RnaRecord(name=name, sequence="".join(chunks),
                                             record_id=len(records)))
                name = line[1:].strip()
                chunks = []
            elif line and name is not None:
                chunks.append(line)
            elif line:
                raise LaraInputError(f"{filename}: sequence data before first '>' header")
    if name is not None:
        records.append(RnaRecord(name=name, sequence="".join(chunks), record_id=len(records)))
    if not records:
        raise LaraInputError(f"{filename}: no fasta records found")
    return records


def read_fastq(filename: str) -> List[RnaRecord]:
    records: List[RnaRecord] = []
    with _open_text(filename) as handle:
        lines = [ln.rstrip() for ln in handle if ln.strip()]
    for idx in range(0, len(lines), 4):
        if not lines[idx].startswith("@"):
            raise LaraInputError(f"{filename}: malformed fastq at line {idx + 1}")
        records.append(RnaRecord(name=lines[idx][1:].strip(), sequence=lines[idx + 1],
                                 record_id=len(records)))
    return records


def read_embl(filename: str) -> List[RnaRecord]:
    """Minimal EMBL flat-file reader (``ID``/``SQ``/``//`` records) --
    SeqAn's ``SeqFileIn`` accepts this format (``io.hpp:178-199``)."""
    records: List[RnaRecord] = []
    name = None
    seq_parts: List[str] = []
    in_seq = False
    with _open_text(filename) as handle:
        for line in handle:
            if line.startswith("ID"):
                name = line[2:].strip().split(";")[0].strip()
                seq_parts = []
                in_seq = False
            elif line.startswith("SQ"):
                in_seq = True
            elif line.startswith("//"):
                if name is None:
                    raise LaraInputError(f"{filename}: EMBL record without ID line")
                records.append(RnaRecord(
                    name=name, sequence="".join(seq_parts).upper(),
                    record_id=len(records)))
                name, seq_parts, in_seq = None, [], False
            elif in_seq:
                seq_parts.append("".join(
                    c for c in line if c.isalpha()))
    if not records:
        raise LaraInputError(f"{filename}: no EMBL records found")
    return records


def read_genbank(filename: str) -> List[RnaRecord]:
    """Minimal GenBank reader (``LOCUS``/``ORIGIN``/``//``)."""
    records: List[RnaRecord] = []
    name = None
    seq_parts: List[str] = []
    in_seq = False
    with _open_text(filename) as handle:
        for line in handle:
            if line.startswith("LOCUS"):
                parts = line.split()
                name = parts[1] if len(parts) > 1 else f"record{len(records)}"
                seq_parts = []
                in_seq = False
            elif line.startswith("ORIGIN"):
                in_seq = True
            elif line.startswith("//"):
                if name is None:
                    raise LaraInputError(f"{filename}: GenBank record without LOCUS")
                records.append(RnaRecord(
                    name=name, sequence="".join(seq_parts).upper(),
                    record_id=len(records)))
                name, seq_parts, in_seq = None, [], False
            elif in_seq:
                seq_parts.append("".join(c for c in line if c.isalpha()))
    if not records:
        raise LaraInputError(f"{filename}: no GenBank records found")
    return records


def read_raw(filename: str) -> List[RnaRecord]:
    """Raw format: one bare sequence per line (SeqAn ``Raw``)."""
    records: List[RnaRecord] = []
    with _open_text(filename) as handle:
        for line in handle:
            seq = line.strip()
            if seq:
                records.append(RnaRecord(
                    name=f"sequence{len(records) + 1}", sequence=seq.upper(),
                    record_id=len(records)))
    if not records:
        raise LaraInputError(f"{filename}: no sequences found")
    return records


# ---------------------------------------------------------------------------
# connect (.ct)
# ---------------------------------------------------------------------------

def read_connect(filename: str) -> List[RnaRecord]:
    """CT format: header ``<N> [ENERGY = x] <name>``, then per-base rows
    ``idx base prev next pair idx2``.  Multiple records may be concatenated."""
    records: List[RnaRecord] = []
    with _open_text(filename) as handle:
        lines = [ln.rstrip() for ln in handle if ln.strip()]
    idx = 0
    while idx < len(lines):
        header = lines[idx].split()
        try:
            length = int(header[0])
        except (ValueError, IndexError) as exc:
            raise LaraInputError(f"{filename}: bad CT header: {lines[idx]!r}") from exc
        name = header[-1] if len(header) > 1 else f"ct_record_{len(records)}"
        seq_chars: List[str] = []
        edges: List[Tuple[int, int, float]] = []
        for row in lines[idx + 1 : idx + 1 + length]:
            parts = row.split()
            pos = int(parts[0])
            seq_chars.append(parts[1])
            pair = int(parts[4])
            if pair > pos:
                edges.append((pos - 1, pair - 1, 1.0))
        record = RnaRecord(name=name, sequence="".join(seq_chars), record_id=len(records))
        record.fixed_edges = sorted(edges)
        records.append(record)
        idx += 1 + length
    return records


# ---------------------------------------------------------------------------
# bpseq / ebpseq
# ---------------------------------------------------------------------------

def read_bpseq(filename: str) -> List[RnaRecord]:
    """BPSEQ: optional ``#`` comment header, rows ``pos base pair`` (1-based,
    pair 0 = unpaired)."""
    name = os.path.splitext(os.path.basename(filename))[0]
    seq_chars: List[str] = []
    edges: List[Tuple[int, int, float]] = []
    with _open_text(filename) as handle:
        for line in handle:
            line = line.strip()
            if not line:
                continue
            if line.startswith("#"):
                comment = line.lstrip("#").strip()
                if comment:
                    name = comment
                continue
            parts = line.split()
            pos, base, pair = int(parts[0]), parts[1], int(parts[2])
            seq_chars.append(base)
            if pair > pos:
                edges.append((pos - 1, pair - 1, 1.0))
    record = RnaRecord(name=name, sequence="".join(seq_chars))
    record.fixed_edges = sorted(edges)
    return [record]


def read_ebpseq(filename: str) -> List[RnaRecord]:
    """Extended bpseq (lara-tpu dialect, see module docstring).

    ``M`` columns carry comma-separated ``<prob>/<partner>`` entries (partner
    1-based); only entries with partner > pos create an edge so each pair is
    stored once.  ``F`` columns carry a single partner index (0 = unpaired).
    """
    header_names: dict = {}
    records: List[RnaRecord] = []
    current: RnaRecord = None  # type: ignore[assignment]
    columns: List[str] = []
    with _open_text(filename) as handle:
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
                seq_tag = columns[0]
                current = RnaRecord(
                    name=header_names.get(seq_tag, seq_tag),
                    sequence="",
                    record_id=len(records),
                )
                records.append(current)
                continue
            if current is None:
                raise LaraInputError(f"{filename}: data row before record header")
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
                            current.bpp_edges.append((pos, partner, float(prob_str)))
                elif col_tag.startswith("F"):
                    partner = int(cell) - 1
                    if partner > pos:
                        current.fixed_edges.append((pos, partner, 1.0))
    for record in records:
        # sequences were accumulated raw; re-normalise
        record.sequence = record.sequence  # already normalised char-wise below
        record.__post_init__()
        record.bpp_edges.sort()
        record.fixed_edges.sort()
    if not records:
        raise LaraInputError(f"{filename}: no ebpseq records found")
    return records


# ---------------------------------------------------------------------------
# stockholm
# ---------------------------------------------------------------------------

def read_stockholm(filename: str) -> List[RnaRecord]:
    """Stockholm 1.0: aligned sequences plus ``#=GC SS_cons`` consensus
    structure.  Each record gets the consensus pairs projected onto its own
    ungapped coordinates; pairs hitting a gap in that sequence are dropped
    (SeqAn sth reader behavior)."""
    seq_order: List[str] = []
    seqs: dict = {}
    ss_cons = ""
    with _open_text(filename) as handle:
        for line in handle:
            line = line.rstrip()
            if not line or line.startswith("# STOCKHOLM") or line == "//":
                continue
            if line.startswith("#=GC"):
                parts = line.split(None, 2)
                if len(parts) >= 3 and parts[1] == "SS_cons":
                    ss_cons += parts[2].strip()
                continue
            if line.startswith("#"):
                continue
            parts = line.split(None, 1)
            if len(parts) != 2:
                continue
            name, chunk = parts[0], parts[1].strip()
            if name not in seqs:
                seqs[name] = ""
                seq_order.append(name)
            seqs[name] += chunk
    if not seq_order:
        raise LaraInputError(f"{filename}: no stockholm sequences found")

    # Consensus pairs in alignment-column space. WUSS notation: treat <>, (),
    # [], {} and letters as pairs; -._,:~ as unpaired.
    cons_pairs: List[Tuple[int, int]] = []
    if ss_cons:
        cleaned = "".join(c if c in _OPEN + _CLOSE or c.isalpha() else "." for c in ss_cons)
        cons_pairs = [(i, j) for (i, j, _w) in parse_bracket_string(cleaned)]

    records: List[RnaRecord] = []
    gap_chars = set("-._~")
    for rid, name in enumerate(seq_order):
        aligned = seqs[name]
        col_to_pos = {}
        pos = 0
        for col, char in enumerate(aligned):
            if char not in gap_chars:
                col_to_pos[col] = pos
                pos += 1
        sequence = "".join(c for c in aligned if c not in gap_chars)
        record = RnaRecord(name=name, sequence=sequence, record_id=rid)
        edges = []
        for ci, cj in cons_pairs:
            if ci in col_to_pos and cj in col_to_pos:
                edges.append((col_to_pos[ci], col_to_pos[cj], 1.0))
        record.fixed_edges = sorted(edges)
        records.append(record)
    return records


# ---------------------------------------------------------------------------
# ViennaRNA dotplot (.ps)
# ---------------------------------------------------------------------------

def read_dotplot(filename: str) -> RnaRecord:
    """Parse an RNAfold ``*_dp.ps`` file (``io.hpp:202-284``).

    * sequence: lines after ``/sequence`` until a line containing ``)``;
      non-alphabetic characters are stripped; the ``)`` line itself is
      discarded entirely (reference quirk),
    * ``ubox`` rows ``i j p``: the dotplot stores sqrt(p); an edge
      ``log(p^2 / 0.003)`` is created iff ``p^2 > 0.003`` (``io.hpp:257-258``),
    * ``lbox`` rows: fixed-structure edge with weight 1.0 (``io.hpp:261-271``),
    * the record name is the basename stripped of ``.ps`` and ``_dp``
      (``io.hpp:277-278``),
    * if any bpp edge exists the fixed edges are dropped (only one graph is
      appended, ``io.hpp:279-282``).
    """
    if not os.path.exists(filename):
        raise LaraInputError(f"Cannot open dotplot file {filename}")
    sequence_chunks: List[str] = []
    bpp_edges: List[Tuple[int, int, float]] = []
    fixed_edges: List[Tuple[int, int, float]] = []
    with _open_text(filename, errors="replace") as handle:
        lines = iter(handle)
        for line in lines:
            if "/sequence" in line:
                for seq_line in lines:
                    if ")" in seq_line:
                        break
                    sequence_chunks.append("".join(c for c in seq_line if c.isalpha()))
                break
        for line in handle:
            if "ubox" in line:
                parsed = _parse_box_line(line)
                if parsed is not None:
                    i, j, prob = parsed
                    if prob * prob > MIN_PROB:
                        bpp_edges.append((i - 1, j - 1, math.log(prob * prob / MIN_PROB)))
            elif "lbox" in line:
                parsed = _parse_box_line(line)
                if parsed is not None:
                    i, j, _prob = parsed
                    fixed_edges.append((i - 1, j - 1, 1.0))
    name = os.path.basename(filename)
    if name.endswith(".ps"):
        name = name[: -len(".ps")]
    if name.endswith("_dp"):
        name = name[: -len("_dp")]
    record = RnaRecord(name=name, sequence="".join(sequence_chunks))
    if bpp_edges:
        record.bpp_edges = sorted(_canonical(bpp_edges))
    else:
        record.fixed_edges = sorted(_canonical(fixed_edges))
    return record


def _canonical(edges):
    return [(min(i, j), max(i, j), w) for (i, j, w) in edges]


def _parse_box_line(line: str):
    parts = line.split()
    try:
        return int(parts[0]), int(parts[1]), float(parts[2])
    except (ValueError, IndexError):
        return None

"""RNA records and the input-storage pipeline.

Mirrors the behavior of ``lara::InputStorage`` (``reference/src/io.hpp:71-339``):

* read the ``-i`` file, then the ``-r`` file (records appended in order),
* for every record read so far, "compute" the structure
  (``io.hpp:286-338``): records with a base-pair-probability graph are left
  alone; records with only a fixed structure get their edge weights multiplied
  by 10; records with neither require a structure-prediction engine,
* then append one record per ``-d`` dotplot file (``io.hpp:93-113``) -- note
  these are appended *after* the weight-boost pass, so a fixed-only dotplot
  record keeps weight 1.0 (reference behavior),
* finally require at least two sequences (``io.hpp:115-119``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

#: Minimum base-pair probability; below this no edge is created
#: (``io.hpp:206,313``, "taken from LISA > Lara").
MIN_PROB = 0.003
#: minimum predicted work (sum of len^2 over structure-less records) before
#: -j spreads the builtin prediction over worker processes
PARALLEL_PREDICT_MIN_WORK = 500_000


@dataclass
class RnaRecord:
    """One RNA sequence with optional structure annotation.

    ``sequence`` is stored Rna5-normalised (upper case, T->U, ambiguity
    codes->N) exactly as SeqAn's ``Rna5String`` conversion does
    (``io.hpp:170,196``), because output writers print the normalised
    sequence.

    ``fixed_edges`` / ``bpp_edges`` are undirected interaction edges
    ``(i, j, weight)`` with 0-based positions i < j.  ``bpp_edges`` carries
    base-pair probabilities (or log-odds of them, depending on scoring mode);
    ``fixed_edges`` carries fixed-structure weights.
    """

    name: str
    sequence: str
    fixed_edges: List[Tuple[int, int, float]] = field(default_factory=list)
    bpp_edges: List[Tuple[int, int, float]] = field(default_factory=list)
    record_id: int = 0

    def __post_init__(self) -> None:
        self.sequence = normalize_rna5(self.sequence)

    @property
    def structure_edges(self) -> List[Tuple[int, int, float]]:
        """The graph the solver consumes: bpp if present, else fixed
        (``lagrange.hpp:259-262``)."""
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


class LaraInputError(RuntimeError):
    """Raised for input conditions that make the reference exit with error."""


class StructurePredictionRequired(LaraInputError):
    """Record without any structure and no prediction engine configured
    (reference: exit(1), ``io.hpp:332-336``)."""


class InputStorage(list):
    """Ordered list of :class:`RnaRecord` after the full input pipeline."""

    def __init__(
        self,
        in_file: str = "",
        ref_file: str = "",
        dotplot_files: Optional[List[str]] = None,
        structure_scoring: int = 0,
        out_format: str = "lib",
        predict_structures: Optional[str] = None,
        threads: int = 1,
    ) -> None:
        super().__init__()
        from lara_tpu_torch.io import readers

        if in_file:
            self.extend(readers.read_rna_file(in_file))
        if ref_file:
            self.extend(readers.read_rna_file(ref_file))

        log_scoring = structure_scoring == 0  # ScoringMode::LOGARITHMIC
        # built-in structure prediction is per-record independent host
        # NumPy -- the reference's per-record pf_fold loop (io.hpp:88-89).
        # -j spreads it over worker PROCESSES (the sweep's many small
        # vector ops are GIL-bound, so threads measured slower; processes
        # measured 1.7x at 8x300nt and grow with family size).  Spawn
        # context: forking after the TPU runtime initialised is unsafe.
        # Only engages when the predicted work dwarfs the worker startup.
        need = [r for r in self
                if predict_structures in ("builtin", None)
                and not r.bpp_edges and not r.fixed_edges]
        work = sum(len(r.sequence) ** 2 for r in need)
        if threads > 1 and len(need) > 3 and work > PARALLEL_PREDICT_MIN_WORK:
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor

            ctx = multiprocessing.get_context("spawn")
            with ProcessPoolExecutor(
                    max_workers=min(threads, len(need)),
                    mp_context=ctx) as pool:
                results = list(pool.map(_predict_edges,
                                        [(r.sequence, log_scoring)
                                         for r in need]))
            for record, edges in zip(need, results):
                record.bpp_edges = edges
                if not edges:
                    raise StructurePredictionRequired(
                        f"Built-in structure prediction produced no base "
                        f"pairs for record '{record.name}'.")
        for record in self:
            _compute_structure(record, log_scoring, predict_structures)

        for filename in dotplot_files or []:
            record = readers.read_dotplot(filename)
            if not record.bpp_edges and not record.fixed_edges:
                raise LaraInputError(
                    f"The dotplot file {filename} does not contain any base pair "
                    "probabilities. Please make sure that you execute RNAfold with "
                    "-p option and specify the resulting _dp.ps file!"
                )
            self.append(record)

        if len(self) <= 1:
            raise LaraInputError("The given file(s) must contain at least two sequences.")
        self.warned_fasta = len(self) > 2 and out_format == "fasta"


def _predict_edges(args: Tuple[str, bool]) -> List[Tuple[int, int, float]]:
    """Worker-process body for parallel builtin prediction: sequence ->
    bpp edge list with exactly the filtering/weighting of the builtin
    branch of :func:`_compute_structure` (io.hpp:318-327 semantics)."""
    sequence, log_scoring = args
    from lara_tpu_torch.solver import bpp_predict

    probs = bpp_predict.basepair_probabilities(sequence)
    edges = []
    for (i, j), p in probs.items():
        if p > MIN_PROB:
            weight = math.log(p / MIN_PROB) if log_scoring else p
            edges.append((i, j, weight))
    return sorted(edges)


def _compute_structure(record: RnaRecord, log_scoring: bool, predict: Optional[str]) -> None:
    """Equivalent of ``computeStructure`` (``io.hpp:286-338``).

    The reference calls ViennaRNA ``pf_fold`` when a record has no structure
    at all; lara-tpu optionally uses its built-in TPU McCaskill-style
    predictor (``predict == 'builtin'``), and otherwise raises, mirroring the
    reference's ``exit(1)`` when ViennaRNA is unavailable.
    """
    if record.bpp_edges:
        return
    if record.fixed_edges:
        # only a fixed graph: increase the importance of the edges (io.hpp:292-296)
        record.fixed_edges = [(i, j, w * 10) for (i, j, w) in record.fixed_edges]
        return
    if predict == "builtin" or predict is None:
        from lara_tpu_torch.solver import bpp_predict

        probs = bpp_predict.basepair_probabilities(record.sequence)
        edges = []
        for (i, j), p in probs.items():
            if p > MIN_PROB:
                weight = math.log(p / MIN_PROB) if log_scoring else p
                edges.append((i, j, weight))
        record.bpp_edges = sorted(edges)
        if record.bpp_edges:
            return
        raise StructurePredictionRequired(
            f"Built-in structure prediction produced no base pairs for record "
            f"'{record.name}'."
        )
    raise StructurePredictionRequired(
        "Cannot compute a structure without a prediction engine "
        "(--predict none mirrors a ViennaRNA-less reference build). "
        "Provide structures/dotplots in the input, or use --predict builtin."
    )

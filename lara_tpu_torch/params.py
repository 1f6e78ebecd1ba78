"""Run parameters, mirroring the reference CLI surface.

Flag set, semantics and defaults follow ``reference/src/parameters.hpp``
(option table at ``:116-242``, value extraction at ``:249-329``):

-v/--verbose, -j/--threads, -i/--infile, -r/--reffile, -d/--dotplot (repeat),
-w/--write, -l/--libscore MIN MAX, -o/--outformat {lib,pairs,fasta},
-n/--numiter, -a/--maxnondecreasing, -f/--factor, -e/--epsilon,
-m/--matching, -u/--subopt, -b/--balance, -c/--seqscale,
-p/--probscoremode {0,1}, -x/--gapextend, -y/--gapopen, -s/--scorematrix.

Notes kept faithful to the reference:
* ``-e`` is accepted but never read by either solver driver (dead parameter
  in the reference; convergence is exact bound equality,
  ``subgradient_solver.hpp:286``),
* ``-j 0`` autodetects a worker count (``parameters.hpp:253-258``); on TPU
  ``threads`` configures the host-side pipeline width, device batching is
  controlled by ``batch``-related extras below,
* gap costs and the score matrix are converted to int32 fixed point at setup
  (``parameters.hpp:303-314``).

lara-tpu extensions (all optional, default off):
``--predict`` selects the structure predictor for structure-less records
(default ``builtin``, mirroring the reference built with ViennaRNA) where the
reference requires ViennaRNA; ``--backend {device,reference}`` selects the
batched TPU solver or the NumPy scalar mirror; ``--precise-bpp`` disables the
reference's int-truncation of contact probabilities.
"""

from __future__ import annotations

import argparse
import os
import sys
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from lara_tpu_torch.scoring.ribosum import RIBOSUM65N_FLOAT, load_score_matrix, to_fixed
from lara_tpu_torch.types import f2i
from lara_tpu_torch.utils import logging as _logging

VERSION = "0.1.0"
REFERENCE_VERSION = "2.0.1"  # parameters.hpp:109


@dataclass
class Parameters:
    # general
    verbose: int = 0
    threads: int = 1
    # input
    in_file: str = ""
    ref_file: str = ""
    dotplot_files: List[str] = field(default_factory=list)
    # output
    out_file: str = ""
    out_format: str = "lib"
    library_score_min: int = 0
    library_score_max: int = 0
    library_score_is_linear: bool = False
    # runtime / quality
    num_iterations: int = 500
    max_nondecr_iterations: int = 50
    step_size_factor: float = 1.0
    epsilon: float = 0.01  # accepted, unused (reference parity)
    matching: int = 5
    suboptimal_diff: float = 40.0
    # scoring
    balance: float = 1.0
    #: ``-b auto``: ignore ``balance`` and key the structural-score weight on
    #: each pair's measured sequence identity (edge_filter.hpp:156-157 --
    #: the quantity the reference computes there for ``-c``).  The mapping
    #: lives in :func:`effective_balance`; calibration in benchmark/RESULTS.md.
    balance_auto: bool = False
    sequence_scale: float = 0.0
    structure_scoring: int = 0  # 0 LOGARITHMIC, 1 SCALE
    gap_extend: float = -2.0
    gap_open: float = -6.0
    score_matrix_file: str = ""
    # lara-tpu extensions
    predict: Optional[str] = "builtin"
    backend: str = "device"
    precise_bpp: bool = False
    msa_file: str = ""
    prewarm: bool = False

    # derived (filled in __post_init__)
    score_matrix: np.ndarray = None  # type: ignore[assignment]
    gap_open_int: np.int32 = None  # type: ignore[assignment]
    gap_extend_int: np.int32 = None  # type: ignore[assignment]

    def __post_init__(self) -> None:
        if self.threads == 0:
            self.threads = os.cpu_count() or 1
        self.gap_open_int = f2i(self.gap_open)
        self.gap_extend_int = f2i(self.gap_extend)
        if self.score_matrix is None:
            matrix_float = (
                load_score_matrix(self.score_matrix_file)
                if self.score_matrix_file
                else RIBOSUM65N_FLOAT
            )
            self.score_matrix = to_fixed(matrix_float)
        _logging.set_verbosity(self.verbose)


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="lara-tpu",
        description="Lagrangian Relaxed Alignment for RNA structures (TPU-native)",
    )
    parser.add_argument("--version", action="version", version=f"lara-tpu {VERSION}")
    parser.add_argument("-v", "--verbose", type=int, default=0, choices=range(0, 4),
                        help="0: no additional outputs, 1: program steps with run time, "
                             "2: developer infos, 3: per-iteration output.")
    parser.add_argument("-j", "--threads", type=int, default=1,
                        help="Host worker count; 0 autodetects.")
    parser.add_argument("-i", "--infile", default="",
                        help="Path to the input file (format from extension).")
    parser.add_argument("-r", "--reffile", default="",
                        help="Path to the reference input file.")
    parser.add_argument("-d", "--dotplot", action="append", default=[],
                        help="RNAfold -p dotplot file (*_dp.ps); repeatable.")
    parser.add_argument("-w", "--write", default="",
                        help="Path to the output file. Default: stdout.")
    parser.add_argument("-l", "--libscore", nargs=2, type=int, metavar=("MIN", "MAX"),
                        default=None,
                        help="Score range for the T-Coffee library. "
                             "Default: 500 1000 (binary).")
    parser.add_argument("-o", "--outformat", default="lib",
                        choices=("lib", "pairs", "fasta"),
                        help="Output format.")
    parser.add_argument("-n", "--numiter", type=int, default=500,
                        help="The number of iterations.")
    parser.add_argument("-a", "--maxnondecreasing", type=int, default=50,
                        help="The number of non-decreasing iterations.")
    parser.add_argument("-f", "--factor", type=float, default=1.0,
                        help="Step size factor.")
    parser.add_argument("-e", "--epsilon", type=float, default=0.01,
                        help="Accepted for compatibility (unused, as in the reference).")
    parser.add_argument("-m", "--matching", type=int, default=5,
                        help="Lookahead for greedy matching. 0 selects the exact "
                             "maximum-weighted-matching backend.")
    parser.add_argument("-u", "--subopt", type=float, default=40.0,
                        help="Suboptimality threshold for alignment-edge filtering.")
    parser.add_argument("-b", "--balance", default="1.0",
                        help="Impact factor of the structural score (float), "
                             "or 'auto' to key it on each pair's measured "
                             "sequence identity (recommended for diverged "
                             "families; see benchmark/RESULTS.md).")
    parser.add_argument("-c", "--seqscale", type=float, default=0.0,
                        help="Impact of alignment score dependent on sequence similarity.")
    parser.add_argument("-p", "--probscoremode", type=int, default=0, choices=(0, 1),
                        help="Base pair probability scoring: LOGARITHMIC (0) or SCALE (1).")
    parser.add_argument("-x", "--gapextend", type=float, default=-2.0,
                        help="Gap extend costs.")
    parser.add_argument("-y", "--gapopen", type=float, default=-6.0,
                        help="Gap open costs.")
    parser.add_argument("-s", "--scorematrix", default="",
                        help="Score matrix file. Default: Ribosum65N.")
    # lara-tpu extensions
    parser.add_argument("--predict", default="builtin",
                        choices=("builtin", "none"),
                        help="Structure prediction engine for records without "
                             "structure.  Default 'builtin' (McCaskill "
                             "base-pair probabilities) mirrors the reference "
                             "built with ViennaRNA (io.hpp:286-338); 'none' "
                             "mirrors a ViennaRNA-less build (error on "
                             "structure-less input, io.hpp:332-336).")
    parser.add_argument("--backend", default="device", choices=("device", "reference"),
                        help="device: batched TPU solver (default); "
                             "reference: NumPy scalar mirror of the C++ driver.")
    parser.add_argument("--precise-bpp", action="store_true",
                        help="Keep fractional base-pair probabilities instead of the "
                             "reference's int-truncation of contact weights.")
    parser.add_argument("--msa", default="", metavar="FILE",
                        help="Additionally assemble a multiple alignment from the "
                             "pairwise library (native t_coffee -lib equivalent) and "
                             "write it as aligned fasta to FILE.")
    parser.add_argument("--prewarm", action="store_true",
                        help="Run the full solve for the given input but write no "
                             "output: compiles every program for this input's shape "
                             "classes into the persistent compilation cache, so "
                             "subsequent real runs start warm.")
    return parser


def parse_args(argv=None) -> Parameters:
    args = build_arg_parser().parse_args(argv)
    if not args.infile and not args.dotplot:
        build_arg_parser().print_usage(sys.stderr)
        raise SystemExit(1)
    libscore = args.libscore
    return Parameters(
        verbose=args.verbose,
        threads=args.threads,
        in_file=args.infile,
        ref_file=args.reffile,
        dotplot_files=list(args.dotplot),
        out_file=args.write,
        out_format=args.outformat,
        library_score_min=libscore[0] if libscore else 0,
        library_score_max=libscore[1] if libscore else 0,
        library_score_is_linear=libscore is not None,
        num_iterations=args.numiter,
        max_nondecr_iterations=args.maxnondecreasing,
        step_size_factor=args.factor,
        epsilon=args.epsilon,
        matching=args.matching,
        suboptimal_diff=args.subopt,
        balance=1.0 if str(args.balance).lower() == "auto" else float(args.balance),
        balance_auto=str(args.balance).lower() == "auto",
        sequence_scale=args.seqscale,
        structure_scoring=args.probscoremode,
        gap_extend=args.gapextend,
        gap_open=args.gapopen,
        score_matrix_file=args.scorematrix,
        predict=args.predict,
        backend=args.backend,
        precise_bpp=args.precise_bpp,
        prewarm=args.prewarm,
        msa_file=args.msa,
    )

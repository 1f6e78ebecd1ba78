"""Time the driver's edge filter phase in several checkouts, in turns.

    python3 edge_filter_ab.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout of this repository (for example a
``git archive`` of the parent commit unpacked beside this one); each runs
in a process of its own, with its own imports and kernel build, in the
order given, on one NVIDIA GPU.  For each of the bench's tRNA (120 pairs of
~72 nt), ~300 nt (28 pairs) and 16S (28 pairs of 1530 nt) families
(``lara_tpu_torch.workloads``) the process runs
``device_driver._filter_and_build`` on the whole family as one chunk, as
the driver does: once to warm up, then ``--reps`` times, and reports the
mean "edge filter (device)" phase (upload, filter, download, unskew on the
host) and the mean "interaction build (host)" phase.  Prints one JSON line
per checkout, the card's name and power limit, and exits non-zero without
a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

PHASES = ("edge filter (device)", "interaction build (host)")


def time_filter(dev, reps: int) -> dict:
    """{family: {phase: mean seconds}} for this process's checkout."""
    import torch

    from lara_tpu_torch import _build
    from lara_tpu_torch.app import enumerate_pairs
    from lara_tpu_torch.params import Parameters
    from lara_tpu_torch.solver import device_driver, interactions
    from lara_tpu_torch.utils import timing
    from lara_tpu_torch.workloads import make_family, make_long_family

    if dev.type == "cuda":
        _build.library()
    interactions._native_build()
    params = Parameters(in_file="<edge filter>")
    families = {
        "trna-72nt": make_family(n=16),
        "rrna-300nt": make_long_family(n=8, length=300, seed=31,
                                       mutations=12),
        "16S-1530nt": make_long_family(n=8, length=1530, seed=47),
    }
    out = {}
    for name, records in families.items():
        pairs = enumerate_pairs(records)
        pad = device_driver._pad_dim(max(len(r.sequence) for r in records))
        device_driver._filter_and_build(records, pairs, params, pad, pad, dev)
        timing.reset()
        for _ in range(reps):
            device_driver._filter_and_build(records, pairs, params, pad, pad,
                                            dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        phases = timing.snapshot()
        out[name] = {k: phases[k] / reps for k in PHASES}
    return out


def _child(root: str, reps: int) -> int:
    # measure the checkout at ``root``, not the one holding this script
    sys.path[0] = root
    import torch

    if not torch.cuda.is_available():
        print("edge_filter_ab: no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps({"root": root, "reps": reps, "seconds": time_filter(
        torch.device("cuda", 0), reps)}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+", help="checkout roots, run in order")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return _child(args.roots[0], args.reps)
    for root in args.roots:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             "--reps", str(args.reps), os.path.abspath(root)],
            cwd=root, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

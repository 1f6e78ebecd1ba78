"""Time the port's solve, model packing and hybrid device step in several
checkouts, in turns.

    python3 loop_exit_ab.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout of this repository (for example a
``git archive`` of the parent commit unpacked beside this one); each runs
in a process of its own, with its own imports and kernel build, in the
order given, on one NVIDIA GPU.  Each process runs ``lara_tpu_torch.app.run``
on the card, once to warm up and then ``--reps`` times, on:

* the bench's tRNA family (``make_family(n=16)``, 120 pairs of ~72 nt)
  with every record's base-pair edges cleared as it is read, the
  structure-free family of ``benchmark/PROFILE.md:208-212``: every lane is
  done in its first iteration;
* the tRNA family itself, and the 16S family (``make_long_family(n=8,
  length=1530, seed=47)``, 28 pairs in one 1536x1536 chunk);
* the hybrid backend at ``-m 0`` on the tRNA family and at ``-m 12`` under
  ``LARA_DP_RESIDENT=1`` on the ~300 nt family (``make_long_family(n=8,
  length=300, seed=31, mutations=12)``), once each after the warm-up.

For each it reports the mean wall, the "subgradient solve (device)",
"model packing (host)" and "hybrid device step" phases, the seconds of the
run's dispatch-graph captures (the phase "graph capture", 0 where the run
captured none or the checkout has no such phase), the batched hybrid turns, and the pairs'
mean and largest iterations.  Prints one JSON
line per checkout, the card's name and power limit, and exits non-zero
without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

PHASES = ("subgradient solve (device)", "model packing (host)",
          "hybrid device step")


def _clear(store):
    for record in store:
        record.bpp_edges, record.fixed_edges = [], []


def time_runs(dev, reps: int) -> dict:
    """{family: {measure: mean}} for this process's checkout."""
    import numpy as np
    import torch

    from lara_tpu_torch import _build, app
    from lara_tpu_torch.io.writers import write_ebpseq
    from lara_tpu_torch.params import Parameters
    from lara_tpu_torch.solver import hybrid_driver
    from lara_tpu_torch.utils import timing
    from lara_tpu_torch.workloads import make_family, make_long_family

    _build.library()
    trna = make_family(n=16)
    rrna = make_long_family(n=8, length=300, seed=31, mutations=12)
    long16 = make_long_family(n=8, length=1530, seed=47)
    # (label, records, matching, environment, edit of the records read,
    #  runs after the warm-up)
    cases = [("trna-72nt-structure-free", trna, 5, {}, _clear, reps),
             ("trna-72nt", trna, 5, {}, None, reps),
             ("16S-1530nt-batch28", long16, 5, {}, None, reps),
             ("trna-72nt -m 0", trna, 0, {}, None, 1),
             ("rrna-300nt -m 12 LARA_DP_RESIDENT=1", rrna, 12,
              {"LARA_DP_RESIDENT": "1"}, None, 1)]
    out = {}
    real_load = app.load_input
    with tempfile.TemporaryDirectory() as tmp:
        for label, records, matching, env, edit, runs in cases:
            path = os.path.join(tmp, "family.ebpseq")
            with open(path, "w") as handle:
                write_ebpseq(records, handle)
            params = Parameters(in_file=path, matching=matching,
                                out_file=os.path.join(tmp, "out.lib"))
            if edit is not None:
                def load(params, edit=edit):
                    store = real_load(params)
                    edit(store)
                    return store
                app.load_input = load
            os.environ.update(env)
            try:
                sums = dict.fromkeys(PHASES + ("wall", "capture", "turns"),
                                     0.0)
                for k in range(runs + 1):
                    hybrid_driver.turns = 0
                    start = time.perf_counter()
                    run = app.run(params, dev)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - start
                    if k == 0:
                        continue  # the warm-up
                    phases = timing.snapshot()
                    for name in PHASES:
                        sums[name] += phases.get(name, 0.0)
                    sums["wall"] += wall
                    sums["capture"] += phases.get("graph capture", 0.0)
                    sums["turns"] += hybrid_driver.turns
            finally:
                app.load_input = real_load
                for key in env:
                    del os.environ[key]
            iters = [r.iterations for r in run.results]
            out[label] = {k: v / runs for k, v in sums.items()} | {
                "runs": runs, "mean_iterations": float(np.mean(iters)),
                "max_iterations": int(max(iters))}
    return out


def _child(root: str, reps: int) -> int:
    # measure the checkout at ``root``, not the one holding this script
    sys.path[0] = root
    import torch

    if not torch.cuda.is_available():
        print("loop_exit_ab: no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps({"root": root, "reps": reps, "torch": torch.__version__,
                      "runs": time_runs(torch.device("cuda", 0), reps)}))
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

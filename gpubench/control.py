"""The readings of the output check's limits, on the card:

    python3 gpubench/control.py --workload <name> --seed <n> [--seconds 10]

runs the cell's traffic for a short window, then judges the window's
sampled pairs twice against the reference: the program's answers (the
lower reading, 0 on a sound run) and the control's, the reference with its
float32 subgradient step in bfloat16 put in the program's place (the
``control`` module of the cell's reference package; the upper reading).
It prints one JSON line of both.  The benchmark's own runs never run the
control.
"""

import time

T0 = time.monotonic()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv) -> int:
    import argparse

    import torch

    from gpubench import harness

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    args = parser.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("the control's readings are taken on the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = harness.run(cell, args.seed, args.seconds, False, device, T0,
                      control=True)
    checks = out["checks"]
    print(json.dumps({"workload": cell.name, "seed": args.seed,
                      "jobs": out["attempted"],
                      "pairs_compared": checks["pairs_compared"],
                      "program_pairs_differing":
                          checks["pairs_differing"]["value"],
                      "control_pairs_differing":
                          checks["control_pairs_differing"]["value"],
                      "correct": out["correct"],
                      "phases_s": out["phases_s"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

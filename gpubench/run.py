"""Run one cell of the benchmark once:

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(or ``python -m gpubench.run ...``) from the root of a checkout, on a
machine with the cell's CUDA devices.  The last line of standard output is
the result's JSON object; the numbers the output check compared, each
beside its limit, are the last lines of standard error.
"""

import time

T0 = time.monotonic()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


if __name__ == "__main__":
    from gpubench import harness

    sys.exit(harness.main(sys.argv[1:], T0))

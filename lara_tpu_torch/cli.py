"""Command line entry point (``python -m lara_tpu_torch`` / ``lara-tpu-torch``):
the ``lara-tpu`` flags, solved by the PyTorch port."""

from __future__ import annotations

import sys

from lara_tpu.io.records import LaraInputError
from lara_tpu.native import NativeBuildError
from lara_tpu.params import parse_args


def main(argv=None) -> int:
    try:
        params = parse_args(argv)
    except SystemExit as exc:
        return int(exc.code or 0)
    try:
        from lara_tpu_torch.app import run

        run(params)
    except (LaraInputError, NativeBuildError) as exc:
        print(f"ERROR: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

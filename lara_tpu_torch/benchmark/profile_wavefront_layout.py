"""The cost of one dependent wavefront step in three layouts, on the card.

Counterpart of ``benchmark/profile_wavefront_layout.py``: a chain of
``reps x 64`` dependent wavefront-shaped steps (roll + max + where, the
forward DP's inner dependency) over an int32 ``[rows, cols]`` array, timed
by the slope over the step count inside one kernel call, so that the
launch cost cancels:

* ``[1, 1664]``: one row (the B=1 16S layout);
* ``[8, 256]``: the same elements packed into eight rows, column 0 of each
  row carrying the last column of the row above (the packed layout's
  cross-row cost);
* ``[8, 1664]``: eight independent rows (B=8).

:func:`chain` launches KB (``csrc/wavefront_chain.cu``) on a CUDA tensor
and runs :func:`chain_plain` on a CPU tensor.  Run on the card::

    python -m lara_tpu_torch.benchmark.profile_wavefront_layout

``LARA_PLATFORM=cpu`` times the plain version on the CPU instead (a CPU
time, not the card's); ``--lo/--hi/--reps`` set the two trip counts and the
calls per point (the source's 400, 3600 and 3).
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

from lara_tpu_torch import _build
from lara_tpu_torch._device import resolve_device

#: dependent steps per block (the TPU kernel's unrolled ``BLOCK``)
BLOCK = 64

#: (label, rows, cols, carry) of the source's three layouts
LAYOUTS = (
    ("[1, 1664] row layout (current B=1)", 1, 1664, False),
    ("[8, 256] sublane-packed (+carry ops)", 8, 256, True),
    ("[8, 1664] batched rows (B=8)", 8, 1664, False),
)


def chain_plain(x: torch.Tensor, reps: int, carry: bool) -> torch.Tensor:
    """The plain version: ``reps`` blocks of :data:`BLOCK` dependent steps
    over int32 ``x [rows, cols]`` (int32 adds wrap), returning ``m + h``."""
    rows, cols = x.shape
    col = torch.arange(cols, device=x.device)[None, :].expand(rows, cols)
    first = col == 0
    m = x.clone()
    h = x + 1
    for _ in range(reps):
        for t in range(BLOCK):
            ms = torch.where(first, -5, torch.roll(m, 1, dims=1))
            if carry:
                last = torch.roll(m[:, -1:], 1, dims=0)
                ms = torch.where(first, last, ms)
            best = torch.maximum(ms, h)
            m_new = best + (t & 3)
            h = torch.maximum(h + 1, m - 2)
            m = torch.where(col == t % cols, -7, m_new)
    return m + h


def chain(x: torch.Tensor, reps: int, carry: bool) -> torch.Tensor:
    """:func:`chain_plain`'s function: KB on the card for a CUDA ``x``
    (raises where the launcher refuses the shape), the plain version for a
    CPU ``x``."""
    if not x.is_cuda:
        return chain_plain(x, reps, carry)
    rows, cols = x.shape
    _build.require(x, "x", torch.int32, (rows, cols), x.device)
    if reps < 0:
        raise ValueError(f"reps must be >= 0, got {reps}")
    out = torch.empty_like(x)
    rc = _build.library().lara_wavefront_chain(
        x.data_ptr(), out.data_ptr(), rows, cols, int(bool(carry)), int(reps),
        _build.stream_of(x))
    _build.check(rc, "wavefront_chain")
    _build.count("wavefront_chain")
    return out


def _call_seconds(fn, x: torch.Tensor) -> float:
    """Seconds of one call of ``fn`` on ``x``: CUDA events on the card, the
    host clock on the CPU."""
    if x.is_cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    start = time.perf_counter()
    fn()
    return time.perf_counter() - start


def slope(rows: int, cols: int, carry: bool, lo: int = 400, hi: int = 3600,
          reps: int = 3, device: torch.device | None = None) -> float:
    """Seconds per dependent step: ``(t(hi) - t(lo)) / ((hi - lo) * 64)``,
    where ``t(n)`` is the least time of ``reps`` calls at ``n`` blocks after
    one warm-up call, on ``x = ones([rows, cols])``."""
    if hi <= lo:
        raise ValueError(f"need hi > lo, got lo={lo}, hi={hi}")
    device = device if device is not None else resolve_device()
    x = torch.ones((rows, cols), dtype=torch.int32, device=device)

    def t(n: int) -> float:
        chain(x, n, carry)  # warm
        return min(_call_seconds(lambda: chain(x, n, carry), x)
                   for _ in range(reps))

    return (t(hi) - t(lo)) / ((hi - lo) * BLOCK)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main(argv=None) -> dict:
    """Print the seconds per step of each layout in us, then the device:
    the card's ``nvidia-smi`` name and power limit, or ``cpu``.  Returns
    {label: seconds per step}."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--lo", type=int, default=400)
    parser.add_argument("--hi", type=int, default=3600)
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args(argv)
    device = resolve_device()
    where = "" if device.type == "cuda" else " (plain version on the CPU)"
    result = {}
    for label, rows, cols, carry in LAYOUTS:
        per = slope(rows, cols, carry, args.lo, args.hi, args.reps, device)
        result[label] = per
        print(f"{label}: {per * 1e6:.4f} us/step{where}", flush=True)
    print(card_line() if device.type == "cuda" else "device: cpu", flush=True)
    return result


if __name__ == "__main__":
    main()

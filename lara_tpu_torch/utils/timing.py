"""Phase timers, and a ``torch.profiler`` trace of a region under
``LARA_PROFILE=<dir>``.

The phase timers are the JAX package's (``lara_tpu/utils/timing.py``,
the reference's phase accounting, ``subgradient_solver.hpp:199-203,335-351``):
host-side buckets of wall time per phase, logged at verbosity >= 1.  Their
accumulation takes a lock, so the driver's solver and download threads may
time phases beside the main thread.  :func:`maybe_trace` is the counterpart
of the JAX package's, which traces with ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import OrderedDict
from typing import Iterator

import torch

from lara_tpu_torch.utils.logging import log

_BUCKETS: "OrderedDict[str, float]" = OrderedDict()
_COUNTS: "OrderedDict[str, int]" = OrderedDict()
_LOCK = threading.Lock()


def reset() -> None:
    with _LOCK:
        _BUCKETS.clear()
        _COUNTS.clear()


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Accumulate wall time into the named bucket (thread-safe)."""
    start = time.monotonic()
    try:
        yield
    finally:
        elapsed = time.monotonic() - start
        with _LOCK:
            _BUCKETS[name] = _BUCKETS.get(name, 0.0) + elapsed
            _COUNTS[name] = _COUNTS.get(name, 0) + 1


def snapshot() -> "OrderedDict[str, float]":
    """Copy of the accumulated phase buckets (seconds)."""
    with _LOCK:
        return OrderedDict(_BUCKETS)


def report() -> None:
    """Log the accumulated phase table at verbosity 1 (the reference's
    'Alignment time / Matching time / Update time' block)."""
    with _LOCK:
        rows = [(n, s, _COUNTS[n]) for n, s in _BUCKETS.items()]
    if not rows:
        return
    log(1, "Phase timings:")
    for name, seconds, count in rows:
        log(1, f"  {name:<28s} {seconds:8.3f} s  (x{count})")


@contextlib.contextmanager
def maybe_trace() -> Iterator[None]:
    """Trace the region with CPU activity, and CUDA activity where CUDA is
    present, when ``LARA_PROFILE`` names a directory; the Chrome trace
    (``chrome://tracing``, Perfetto) is written into that directory."""
    trace_dir = os.environ.get("LARA_PROFILE")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(
        trace_dir, f"lara_tpu_torch.{time.strftime('%Y%m%d-%H%M%S')}."
                   f"{os.getpid()}.trace.json")
    prof.export_chrome_trace(path)
    log(1, f"profiler trace written to {path}")

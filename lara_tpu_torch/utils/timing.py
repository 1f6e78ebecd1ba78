"""A ``torch.profiler`` trace of a region, under ``LARA_PROFILE=<dir>``.

Counterpart of :func:`lara_tpu.utils.timing.maybe_trace`, which traces with
``jax.profiler``.  The phase timers themselves are the JAX package's
(:mod:`lara_tpu.utils.timing`, which imports no JAX): their accumulation
takes a lock, so the driver's solver and download threads may time phases
beside the main thread.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch

from lara_tpu.utils import log


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

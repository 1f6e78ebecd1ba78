"""The traced run (``--trace 1``): the benchmark's own spans and counters
around calls into the program's layers, a ``torch.profiler`` trace of the
window, and their reduction to what the per-layer readers read.

Wrappers, installed for the traced window only and removed after it
(:class:`ReplayClock` installs the replay's alone in an untraced window):

* ``timing.phase`` (the program's phase buckets) also opens a profiler
  range ``phase:<name>``, so that the device's idle time can be named by
  the phase the host was in;
* ``dispatch_graph.CudaGraph.capture``: a host span (and a range
  ``gpubench.capture``);
* ``dispatch_graph.CudaGraph.replay``: CUDA events before and after each
  launch of a dispatch's graph, on the launching stream, and the host
  clock at the launch;
* ``device_driver._run_solve``: the real lengths and dual counts of the
  chunk's lanes, which the roofline counts read;
* ``dispatch_graph._Entry.warm_up``: the host clock at the eager iteration
  the program runs before a key's first capture.

The profiler does not see every kernel inside a dispatch's WHILE node (at
tRNA's widths about half of them), but it sees each dispatch's first
kernel, the loop exit's.  So a dispatch's span on the device runs from
that kernel's start for the CUDA events' time of the dispatch, and the
device is busy in the union of those spans and of every other operation
the profiler saw.  A kernel the profiler saw is the work of the chunk
whose launch (a replay or a warm-up) came last before the kernel started:
the solve waits for a chunk's results before it launches the next chunk.
So K1's and K3's shares count the work of the calls the profiler saw
against their time.

The profiler records CPU and CUDA activity; its raw events are read
directly (``kineto_results.events()``), without building the profiler's
event tree.  A thread samples ``nvidia-smi`` every two seconds of the
window for the SM clock, the power limit and the draw.
"""

from __future__ import annotations

import bisect
import contextlib
import subprocess
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

import torch

from gpubench import roofline

#: K1, the forward DP of an iteration (the edge filter's sweep is
#: ``dp_wave_kernel<true, ...>``)
K1 = "dp_wave_kernel<false, false, false>"
K3 = "matching_rounds_kernel"
LOOP_EXIT = "loop_exit_kernel"
#: the kernels a fused dispatch's graph runs
GRAPH_KERNELS = (K1, "dp_walk_kernel", K3, "iteration_head_kernel",
                 "iteration_lines_kernel", "iteration_tail_kernel",
                 LOOP_EXIT)


def short_name(name: str) -> str:
    """A device operation's name without its return type, anonymous
    namespace and argument list."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(", 1)[0].strip()


def kernel_family(name: str) -> str:
    """``matching_rounds_kernel<true>`` -> ``matching_rounds_kernel``;
    K1's instance keeps its template arguments."""
    short = short_name(name)
    if short.startswith("dp_wave_kernel"):
        return short
    return short.split("<", 1)[0]


class Chunk(NamedTuple):
    lanes: list   # (la, lb) of every lane, padding lanes 1 x 1
    duals: list   # directed duals of every lane


class Seen(NamedTuple):
    """The calls of one kernel that the profiler saw and could place."""

    calls: int
    seconds: float
    work: roofline.Work


class Summary(NamedTuple):
    window_s: float
    busy_s: float
    coverage: float           # graph kernels seen / dispatches' event time
    placed: bool              # every dispatch placed on the device's clock
    device_ops: list          # [[name, seconds]] top 10
    idle_gaps: list           # [[host span, seconds]] top 10
    kernel_n: Dict[str, int]
    replay_s: float
    capture_s: List[float]
    k1: Seen
    k3: Seen
    clocks_mhz: List[float]
    sms: int
    power_limit_w: Optional[float]


class Tracer:
    """Install the wrappers, trace the window, reduce it."""

    def __init__(self, device: torch.device):
        self.device = device
        self._patches = []
        self._local = threading.local()
        self.capture_s: List[float] = []
        self.replays = []
        self.launches = []   # (host ns, Chunk) of every replay and warm-up
        self.samples = []
        self._stop = threading.Event()
        self._sampler = None
        self._prof = None
        self._t0_ns = self._t1_ns = 0

    # -- wrappers ------------------------------------------------------

    def _patch(self, owner, name, wrapper):
        original = getattr(owner, name)
        self._patches.append((owner, name, original))
        setattr(owner, name, wrapper(original))

    def _launched(self):
        chunk = getattr(self._local, "chunk", None)
        if chunk is not None:
            self.launches.append((time.time_ns(), chunk))

    def _install(self):
        from lara_tpu_torch.solver import device_driver, dispatch_graph
        from lara_tpu_torch.utils import timing

        tracer = self

        def phase(original):
            @contextlib.contextmanager
            def wrapped(name):
                with torch.profiler.record_function(f"phase:{name}"):
                    with original(name):
                        yield
            return wrapped

        def capture(original):
            def wrapped(graph, *args, **kwargs):
                start = time.perf_counter()
                with torch.profiler.record_function("gpubench.capture"):
                    result = original(graph, *args, **kwargs)
                tracer.capture_s.append(time.perf_counter() - start)
                return result
            return wrapped

        def replay(original):
            return _timed(original, tracer.device, tracer.replays,
                          tracer._launched)

        def run_solve(original):
            def wrapped(prep, params):
                n = int(prep.batch.seq_score.shape[0])
                pad = n - len(prep.models)
                tracer._local.chunk = Chunk(
                    [(m.la, m.lb) for m in prep.models] + [(1, 1)] * pad,
                    [len(m.dual_l) for m in prep.models] + [0] * pad)
                try:
                    return original(prep, params)
                finally:
                    tracer._local.chunk = None
            return wrapped

        def warm_up(original):
            def wrapped(entry):
                tracer._launched()
                return original(entry)
            return wrapped

        self._patch(timing, "phase", phase)
        self._patch(dispatch_graph.CudaGraph, "capture", capture)
        self._patch(dispatch_graph.CudaGraph, "replay", replay)
        self._patch(device_driver, "_run_solve", run_solve)
        self._patch(dispatch_graph._Entry, "warm_up", warm_up)

    def _uninstall(self):
        while self._patches:
            owner, name, original = self._patches.pop()
            setattr(owner, name, original)

    # -- nvidia-smi ----------------------------------------------------

    def _sample(self):
        while True:
            try:
                out = subprocess.run(
                    ["nvidia-smi", "--query-gpu=clocks.sm,power.limit,"
                     "power.draw", "--format=csv,noheader,nounits"],
                    capture_output=True, text=True, timeout=20).stdout
                first = out.strip().splitlines()[0].split(",")
                self.samples.append([float(x) for x in first])
            except (OSError, subprocess.SubprocessError, IndexError,
                    ValueError):
                pass
            if self._stop.wait(2.0):
                return

    # -- the window ----------------------------------------------------

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._install()
        self._sampler = threading.Thread(target=self._sample, daemon=True)
        self._sampler.start()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        self._t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize(self.device)
        self._t1_ns = time.time_ns()
        try:
            self._prof.stop()
        finally:
            self._stop.set()
            self._sampler.join()
            self._uninstall()
        return False

    def summary(self) -> Summary:
        events = self._prof.profiler.kineto_results.events()
        t0, t1 = self._t0_ns, self._t1_ns
        cuda = torch.autograd.DeviceType.CUDA
        # a range of record_function shows on the device's timeline too,
        # under the name it has on the host; no kernel or copy has a host
        # event's name
        host_names = {e.name() for e in events if e.device_type() != cuda}
        device, spans = [], []
        for e in events:
            name = e.name()
            if e.device_type() == cuda:
                s, d = e.start_ns(), e.duration_ns()
                if name not in host_names and d > 0 and s < t1 \
                        and s + d > t0:
                    device.append((max(s, t0), min(s + d, t1),
                                   kernel_family(name), name))
            elif name.startswith(("gpubench.", "phase:")):
                spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                              name))
        device.sort()
        by_name = defaultdict(float)
        kernel_n = defaultdict(int)
        graph_s = 0.0
        for s, e, fam, name in device:
            by_name[short_name(name)[:120]] += (e - s) / 1e9
            kernel_n[fam] += 1
            if fam in GRAPH_KERNELS:
                graph_s += (e - s) / 1e9
        spans_ms = [b.elapsed_time(e) for b, e in self.replays]
        replay_s = sum(spans_ms) / 1e3
        exits = [s for s, _, fam, _ in device if fam == LOOP_EXIT]
        placed = len(exits) == len(spans_ms)
        if placed:
            busy = [(s, e, f) for s, e, f, _ in device
                    if f not in GRAPH_KERNELS]
            busy += [(s, min(t1, s + int(ms * 1e6)), LOOP_EXIT)
                     for s, ms in zip(exits, spans_ms)]
            busy.sort()
        else:
            busy = [(s, e, f) for s, e, f, _ in device]
        union, gaps = _merge(busy, t0, t1)
        window_s = (t1 - t0) / 1e9
        return Summary(
            window_s=window_s, busy_s=union,
            coverage=graph_s / replay_s if replay_s > 0 else 0.0,
            placed=placed,
            device_ops=sorted(([k, v] for k, v in by_name.items()),
                              key=lambda kv: -kv[1])[:10],
            idle_gaps=_idle_by_span(gaps, spans),
            kernel_n=dict(kernel_n), replay_s=replay_s,
            capture_s=list(self.capture_s),
            k1=self._seen(device, K1, lambda c: roofline.k1_call(c.lanes)),
            k3=self._seen(device, K3, lambda c: roofline.k3_call(c.duals)),
            clocks_mhz=[s[0] for s in self.samples],
            sms=torch.cuda.get_device_properties(
                self.device).multi_processor_count,
            power_limit_w=self.samples[0][1] if self.samples else None)

    def _seen(self, device, family: str, work_of) -> Seen:
        """The calls of ``family`` the profiler saw after a launch of the
        window, each the work of its launch's chunk."""
        times = [t for t, _ in self.launches]
        calls, seconds, ops, nbytes = 0, 0.0, 0.0, 0.0
        cache = {}
        for s, e, fam, _ in device:
            if fam != family:
                continue
            k = bisect.bisect_right(times, s) - 1
            if k < 0:
                continue
            chunk = self.launches[k][1]
            if id(chunk) not in cache:
                cache[id(chunk)] = work_of(chunk)
            work = cache[id(chunk)]
            calls += 1
            seconds += (e - s) / 1e9
            ops += work.ops
            nbytes += work.bytes
        return Seen(calls, seconds, roofline.Work(ops, nbytes))


class ReplayClock:
    """The untraced run's one wrapper: CUDA events before and after each
    launch of a dispatch's graph (``dispatch_graph.CudaGraph.replay``), as
    in :class:`Tracer`, with no profiler.  ``seconds()``, after the
    device has synchronised, is the card's time in the window's
    dispatches."""

    def __init__(self, device: torch.device):
        self.device = device
        self.replays = []
        self._original = None

    def __enter__(self):
        from lara_tpu_torch.solver import dispatch_graph

        self._original = dispatch_graph.CudaGraph.replay
        dispatch_graph.CudaGraph.replay = _timed(self._original, self.device,
                                                 self.replays)
        return self

    def __exit__(self, *exc):
        from lara_tpu_torch.solver import dispatch_graph

        dispatch_graph.CudaGraph.replay = self._original
        return False

    def seconds(self) -> float:
        return sum(b.elapsed_time(e) for b, e in self.replays) / 1e3


def _timed(replay, device: torch.device, replays: list,
           launched=lambda: None):
    """``replay`` with a CUDA event before and after each launch on the
    launching stream; each pair is appended to ``replays``, and
    ``launched`` is called before the launch."""
    def wrapped(graph):
        stream = torch.cuda.current_stream(device)
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        launched()
        begin.record(stream)
        replay(graph)
        end.record(stream)
        replays.append((begin, end))
    return wrapped


def _merge(intervals, t0: int, t1: int):
    """(seconds covered by the union of ``intervals``, sorted by start and
    clipped to [t0, t1], and the idle gaps of [t0, t1] as (start, end)
    ns)."""
    covered = 0
    gaps = []
    end = t0
    for s, e, *_ in intervals:
        if s > end:
            gaps.append((end, s))
        if e > end:
            covered += e - max(s, end)
            end = e
    if t1 > end:
        gaps.append((end, t1))
    return covered / 1e9, gaps


def _idle_by_span(gaps, spans) -> list:
    """Idle seconds of ``gaps`` by the innermost host span open at the
    time, the ten largest: [[span, seconds]]."""
    points = []
    for s, e, name in spans:
        points.append((s, 1, name))
        points.append((e, -1, name))
    for s, e in gaps:
        points.append((s, 2, None))
        points.append((e, -2, None))
    points.sort(key=lambda p: (p[0], p[1] > 0))
    stack: List[str] = []
    idle = 0
    last = None
    acc = defaultdict(float)
    for t, kind, name in points:
        if idle > 0 and last is not None and t > last:
            acc[stack[-1] if stack else "(outside the harness's spans)"] \
                += (t - last) / 1e9
        last = t
        if kind == 1:
            stack.append(name)
        elif kind == -1:
            for k in range(len(stack) - 1, -1, -1):
                if stack[k] == name:
                    del stack[k]
                    break
        elif kind == 2:
            idle += 1
        else:
            idle -= 1
    return sorted(([k, v] for k, v in acc.items()),
                  key=lambda kv: -kv[1])[:10]

"""Each dispatch of the fused solver on the card as a CUDA graph.

Counterpart of the JAX package's compiled dispatch: there
``solve_batch_chunk`` is one ``jax.jit`` program with static shape
arguments and a donated carry, its whole loop one ``jax.lax.while_loop``
whose ``cond`` is ``(steps_done < max_steps) & jnp.any(c.lane_active)``
(``lara_tpu/solver/device_solver.py:301-307``, ``:629-634``).  Here one
iteration (:func:`lara_tpu_torch.solver.device_solver._iteration`) is
captured once per static configuration, and a dispatch is one launch of a
graph that loops over it on the card: the loop exit's kernel and a WHILE
node around the captured iteration (``csrc/loop_exit.cu``).  The kernel
evaluates ``cond`` before the first iteration, and the iteration's last
kernel, KI-tail, before every later one (its copy in the WHILE node sets
the node's condition once every lane is written), each against a count of
the iterations left that the host sets to ``max_steps``.  So a dispatch
runs exactly the iterations of the JAX loop, no kernel but the body's runs
in the loop, and a dispatch after the last lane is done costs the launch
and the kernel alone.

* **Key** (:func:`key_of`): the jit's static arguments, the device, B, D,
  NE, ``la_max``, ``lb_max``, ``max_nondecr``, ``lookahead``,
  ``scan_steps`` and the DP plan (:class:`lara_tpu_torch.ops.gotoh_plan.
  Plan`), plus ``go`` and ``ge``, which the kernels take as arguments.
* **Entry** (:class:`_Entry`): static copies of the model, of its loop
  invariants (:class:`~lara_tpu_torch.solver.device_solver._Static`, the
  PSSM grid among them) and of the carry, and the graph, whose captured
  iteration reads the static carry and writes its successor back into it
  (on the card KI-head and KI-tail write it in place: no copy).  One
  entry serves one dispatch at a time: a second caller of the same key (a
  second shard on the same card) gets an entry of its own.
* **A dispatch** (:func:`run`): copy the model (and then its invariants)
  and the carry into the entry, each only where it is not what the entry
  last held (the same tensor objects, unmodified since, by their version
  counters; a write through a raw pointer would not be seen, and no
  caller makes one); on the entry's first use capture, after one eager
  iteration on scratch copies of the carry where this process has not
  yet run the key (it warms the lazy caches: the kernel library, the
  border codes, the shared-memory opt-in; it changes nothing); set the
  iterations left to ``max_steps``; launch the graph once; return a clone
  of the carry, which no later dispatch overwrites.  No host
  synchronisation on the way.  The host's side of a dispatch is the
  phase "dispatch (host)", and within it the phases "graph warm-up" and
  "graph capture" (:mod:`lara_tpu_torch.utils.timing`).
* **Launch counts**: the capture runs under
  :func:`lara_tpu_torch._build.recording`; the loop exit counts the
  iterations it lets run on the card, and
  :func:`lara_tpu_torch._build.add_counted` adds the recorded launches
  that many times without waiting (:func:`lara_tpu_torch._build.settle`,
  which :func:`release` calls, makes them final); each launch of the
  graph counts the loop exit's kernel once.
* **Streams**: the capture runs on a side stream of the entry in
  thread-local mode (``torch.cuda.graph`` would synchronise the card and
  empty the allocator's caches under the pipeline's and the shards' other
  threads), one capture at a time; the side stream waits for the caller's
  stream before it, the caller's waits for the side stream after.  The
  WHILE node's body is that capture, cloned into it, so no second capture
  runs.
  Each use of an entry waits for its last use, which may have been on
  another thread's stream.
* **Memory**: the graph's temporaries live in its private pool.  A
  dispatch of a new key drops the idle entries of every other key on its
  card: ``device_driver`` solves each (``la_max``, ``lb_max``) bucket
  once, in order, on one solver thread, so no later chunk asks for them
  again.  Idle entries of the same key stay, for the next dispatch of the
  bucket or a second shard.  :func:`release` drops every idle entry
  (``device_driver`` calls it when its solve ends).  Dropping an entry
  waits for its last use first.

A failed capture, loop graph or launch raises; nothing falls back to the
eager loop.  On the CPU, :data:`Graph` does not apply and
``solve_batch_chunk`` runs its eager loop; the CPU tests put a stand-in in
:data:`Graph` that records the captured callable and, on each replay,
runs it as the loop on the card does.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
import weakref
from typing import List, NamedTuple

import torch

from lara_tpu_torch import _build
from lara_tpu_torch.ops import gotoh_cuda, gotoh_plan
from lara_tpu_torch.solver import device_solver
from lara_tpu_torch.utils import timing


class CudaGraph:
    """One CUDA graph of a callable on ``device``, captured on a side
    stream in thread-local mode into a private memory pool of its own."""

    _capture_lock = threading.Lock()

    @staticmethod
    def applies(device: torch.device) -> bool:
        return device.type == "cuda"

    def __init__(self, device: torch.device):
        self._device = device
        self._side = torch.cuda.Stream(device)
        self._graph = None
        self._loop = None  # (graph, executable graph) of the loop exit
        self._done = None  # event recorded after the last use

    @contextlib.contextmanager
    def use(self):
        """One use of the entry on the caller's current stream: it waits
        for the last use, and marks its own end."""
        stream = torch.cuda.current_stream(self._device)
        if self._done is not None:
            stream.wait_event(self._done)
        yield
        self._done = torch.cuda.Event()
        self._done.record(stream)

    def capture(self, fn, active=None, counters=None) -> None:
        """Capture ``fn``.  With ``active`` (a [B] bool tensor) and
        ``counters`` (four int32: iterations left, iterations run, and
        KI-tail's ticket, a 64-bit word, the last three zero), both on the
        card for the life of the graph, a replay runs ``fn`` while
        ``active.any()`` and iterations are left, taking one from the first
        counter and adding one to the second for each run
        (``csrc/loop_exit.cu``): ``fn`` must launch KI-tail exactly once,
        with ``active`` its ``lane_active`` out, and KI-tail evaluates that
        after each run (a ``fn`` without exactly one KI-tail raises)."""
        guarded = active is not None
        if guarded and (counters.dtype != torch.int32
                        or counters.numel() != 4 or not counters.is_cuda):
            raise ValueError("the loop's counters are four int32 on the "
                             "card")
        graph = torch.cuda.CUDAGraph(keep_graph=guarded)
        caller = torch.cuda.current_stream(self._device)
        with self._capture_lock:
            self._side.wait_stream(caller)
            with torch.cuda.stream(self._side):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    fn()
                except BaseException:
                    with contextlib.suppress(Exception):
                        graph.capture_end()
                    raise
                graph.capture_end()
            caller.wait_stream(self._side)
        if guarded:
            lib = _build.library()
            loop, exe = ctypes.c_void_p(), ctypes.c_void_p()
            _build.check(lib.lara_loop_graph(
                graph.raw_cuda_graph(), active.data_ptr(), active.numel(),
                counters.data_ptr(), ctypes.byref(loop), ctypes.byref(exe)),
                "loop_exit")
            self._loop = (loop, exe)
        self._graph = graph

    def replay(self) -> None:
        if self._loop is None:
            self._graph.replay()
            return
        _build.count("loop_exit")
        _build.check(_build.library().lara_loop_graph_launch(
            self._loop[1], torch.cuda.current_stream(self._device)
            .cuda_stream), "loop_exit")

    def close(self) -> None:
        """Wait for the last use; then the graphs and the pool may go."""
        if self._done is not None:
            self._done.synchronize()
        if self._loop is not None:
            loop, self._loop = self._loop, None
            _build.check(_build.library().lara_loop_graph_free(*loop),
                         "loop_exit")
        self._graph = None


#: the graph class of every entry (the CPU tests put a stand-in here)
Graph = CudaGraph


class Key(NamedTuple):
    device: torch.device
    b: int
    d: int
    ne: int
    la_max: int
    lb_max: int
    max_nondecr: int
    lookahead: int
    scan_steps: int
    plan: gotoh_plan.Plan
    go: int
    ge: int


def key_of(model: device_solver.BatchModel, go: int, ge: int, la_max: int,
           lb_max: int, max_nondecr: int, lookahead: int,
           scan_steps: int) -> Key:
    b, ne = model.seq_score.shape
    dev = model.seq_score.device
    return Key(dev, b, model.dual_l.shape[1], ne, la_max, lb_max,
               int(max_nondecr), int(lookahead), int(scan_steps),
               gotoh_cuda.plan_for(la_max, lb_max, dev,
                                   gotoh_plan.fused_dchunk(la_max, lb_max)),
               int(go), int(ge))


#: the invariants that depend on the model (``pssm``: the PSSM grid whose
#: run-start cells each iteration rewrites; ``seg_mask``: KI-head's packed
#: run masks); the others (iota_d, iota_cw, slot_base, plan) depend on the
#: key only
_MODEL_INVARIANTS = ("seg_mask", "start_dst", "lq", "mq", "wq", "nc_base",
                     "pssm")


def _seen(tensors) -> list:
    return [(weakref.ref(t), t._version) for t in tensors]


def _unchanged(seen, tensors) -> bool:
    """Whether ``tensors`` are the very tensors of ``seen``, unmodified."""
    return all(ref() is t and version == t._version
               for (ref, version), t in zip(seen, tensors))


def _copy_into(dst, src) -> None:
    for d, s in zip(dst, src):
        if d is not s:
            d.copy_(s)


class _Entry:
    """Static model, invariants and carry of one key, and their graph."""

    def __init__(self, key: Key, model, carry):
        self.key = key
        self.busy = True
        self.graph = Graph(key.device)
        self.model = device_solver.BatchModel(*(t.clone() for t in model))
        self.st = device_solver._prepare(self.model, key.la_max,
                                         key.lb_max, key.scan_steps)
        self.carry = device_solver._Carry(*(t.clone() for t in carry))
        self.model_seen = _seen(model)
        self.carry_seen = _seen(carry)
        # iterations left in the dispatch, iterations run, KI-tail's 64-bit
        # ticket (loop_exit.cu); run() re-arms all four before each dispatch
        self.counters = torch.zeros(4, dtype=torch.int32,
                                    device=self.carry.lane_active.device)
        self.per_body = None  # launches of one iteration in the loop

    def load(self, model, carry) -> None:
        if not _unchanged(self.model_seen, model):
            _copy_into(self.model, model)
            new = device_solver._prepare(self.model, self.key.la_max,
                                         self.key.lb_max, self.key.scan_steps)
            for (r, l), (new_r, new_l) in zip(self.st.same_masks,
                                              new.same_masks):
                r.copy_(new_r)
                l.copy_(new_l)
            _copy_into((getattr(self.st, f) for f in _MODEL_INVARIANTS),
                       (getattr(new, f) for f in _MODEL_INVARIANTS))
            self.model_seen = _seen(model)
        if not _unchanged(self.carry_seen, carry):
            _copy_into(self.carry, carry)

    def _iteration(self, carry, out=None) -> device_solver._Carry:
        k = self.key
        return device_solver._iteration(
            self.model, self.st, carry, k.go, k.ge, k.la_max, k.lb_max,
            k.max_nondecr, k.lookahead, out)

    def step(self) -> None:
        """One iteration from the static carry back into it: on the card
        KI-head and KI-tail write it in place, with no copy."""
        self._iteration(self.carry, out=self.carry)

    def warm_up(self) -> None:
        """One iteration on scratch copies of the carry, its launches not
        counted, where this process has not run the key yet: it warms the
        lazy caches before the capture and changes nothing the dispatch
        reads, so the dispatch runs only the iterations ``cond`` lets
        through.  (It writes the run-start cells of the static PSSM grid;
        every iteration rewrites all of them before the DP reads it.)"""
        with _lock:
            if self.key in _warm:
                return
        with timing.phase("graph warm-up"), _build.recording():
            self._iteration(device_solver._Carry(*(t.clone()
                                                   for t in self.carry)))
        with _lock:
            _warm.add(self.key)

    def capture(self) -> None:
        # the iteration ends in KI-tail, which evaluates the loop's exit
        with timing.phase("graph capture"), _build.recording() as record:
            self.graph.capture(self.step, self.carry.lane_active,
                               self.counters)
        self.per_body = record

    def carry_out(self) -> device_solver._Carry:
        out = device_solver._Carry(*(t.clone() for t in self.carry))
        self.carry_seen = _seen(out)
        return out


_lock = threading.Lock()
_entries: List[_Entry] = []
_warm = set()  # the keys this process has run an iteration of


def _acquire(key: Key, model, carry) -> _Entry:
    """An idle entry of ``key``, or a new one; the idle entries of other
    keys on the same card are dropped first."""
    with _lock:
        stale = [e for e in _entries if not e.busy and e.key != key
                 and e.key.device == key.device]
        for e in stale:
            _entries.remove(e)
        entry = next((e for e in _entries if e.key == key and not e.busy),
                     None)
        if entry is not None:
            entry.busy = True
    for e in stale:
        e.graph.close()
    if entry is None:
        entry = _Entry(key, model, carry)
        with _lock:
            _entries.append(entry)
    return entry


def _give_back(entry: _Entry, ok: bool) -> None:
    """Mark ``entry`` idle, or drop it after a failed dispatch."""
    with _lock:
        entry.busy = False
        if not ok:
            _entries.remove(entry)
    if not ok:
        entry.graph.close()


def release() -> None:
    """Settle the launch counts of the dispatches run so far, and drop
    every idle entry, and with it its graph's private pool."""
    _build.settle()
    with _lock:
        idle = [e for e in _entries if not e.busy]
        for e in idle:
            _entries.remove(e)
    for e in idle:
        e.graph.close()


def run(model: device_solver.BatchModel, carry: device_solver._Carry,
        key: Key, steps: int) -> device_solver._Carry:
    """Up to ``steps`` iterations from ``carry``, in one launch of the
    entry's graph; a carry of the caller's own (not the entry's) comes
    back."""
    if steps <= 0:
        return carry
    with timing.phase("dispatch (host)"):
        entry = _acquire(key, model, carry)
        ok = False
        try:
            with entry.graph.use():
                entry.load(model, carry)
                if entry.per_body is None:
                    entry.warm_up()
                    entry.capture()
                entry.counters[0].fill_(steps)
                entry.counters[1:].zero_()  # bodies run, KI-tail's ticket
                entry.graph.replay()
                _build.add_counted(entry.per_body, entry.counters[1])
                out = entry.carry_out()
            ok = True
        finally:
            _give_back(entry, ok)
        return out

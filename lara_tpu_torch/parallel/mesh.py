"""Several devices and several hosts: data parallelism over pairs.

Counterpart of :mod:`lara_tpu.parallel.mesh`, with the same function names.
The reference's only parallelism is threads and SIMD lanes over independent
pairwise problems (SURVEY §2); nothing is communicated during a solve, so:

* the lanes of a :class:`~lara_tpu_torch.solver.device_solver.BatchModel`
  are cut into contiguous equal blocks, one per device (the JAX package's
  ``P("pairs")``), and each block is solved on its device by its own thread
  with its own dispatch loop: a device whose lanes converge stops early, as
  each JAX device runs its own ``while_loop``, and nothing is synchronised
  across devices until the results are joined in lane order;
* several hosts each solve a strided share of the pairs
  (:func:`process_pair_shard`), and :func:`gather_results` all-gathers the
  per-pair results over ``torch.distributed`` with gloo, so that every host
  merges them into the canonically sorted library (the reference's
  determinism guarantee, ``io.hpp:372``).

The gather runs over gloo, not NCCL: its payload is host data, as JAX's
``process_allgather`` payload is, and NCCL refuses two ranks on one card.
"""

from __future__ import annotations

import contextlib
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from lara_tpu_torch._device import resolve_device
from lara_tpu_torch.solver import device_solver


def distributed_init() -> bool:
    """Join the process group when a coordinator is configured: the JAX
    package's variables, ``JAX_COORDINATOR_ADDRESS`` (or
    ``COORDINATOR_ADDRESS``), ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``;
    ``LARA_NO_DISTRIBUTED`` turns it off.  Returns whether there is more
    than one process.  Torch cannot discover a cluster as
    ``jax.distributed`` does, so a coordinator without the process count or
    the process id raises ``ValueError``."""
    if os.environ.get("LARA_NO_DISTRIBUTED"):
        return False
    coordinator = os.environ.get("JAX_COORDINATOR_ADDRESS") \
        or os.environ.get("COORDINATOR_ADDRESS")
    if not coordinator:
        return False
    count = os.environ.get("JAX_NUM_PROCESSES")
    process_id = os.environ.get("JAX_PROCESS_ID")
    if not count or not process_id:
        raise ValueError(
            f"coordinator {coordinator} is set but JAX_NUM_PROCESSES="
            f"{count!r} and JAX_PROCESS_ID={process_id!r}: the PyTorch port "
            "needs both")
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}", world_size=int(count),
        rank=int(process_id))
    return torch.distributed.get_world_size() > 1


def distributed_shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if _joined():
        torch.distributed.destroy_process_group()


def _joined() -> bool:
    return torch.distributed.is_available() \
        and torch.distributed.is_initialized()


def process_pair_shard(pairs, process_id: Optional[int] = None,
                       process_count: Optional[int] = None):
    """This host's share of the all-pairs work list, strided so that every
    host gets a mix of long and short pairs from the length-sorted list.
    The defaults are this process's rank and the world size (0 and 1
    outside a process group)."""
    if process_id is None:
        process_id = torch.distributed.get_rank() if _joined() else 0
    if process_count is None:
        process_count = torch.distributed.get_world_size() if _joined() \
            else 1
    return [p for k, p in enumerate(pairs) if k % process_count == process_id]


def gather_results(local_entries):
    """Every host's per-pair entries, on every host.  ``local_entries`` is a
    list of (ia, ib, score, columns) tuples with ragged column lists; each
    host packs its entries into one int32 payload of rows ``[len, ia, ib,
    score, ncol, (p1, p2, w)...]`` padded with -1, and two gloo all-gathers
    on CPU tensors carry first the ``[rows, row length]`` dims, then the
    payloads padded to the global maximum.  A host with no entries still
    joins both."""
    world = torch.distributed.get_world_size() if _joined() else 1
    if world == 1:
        return list(local_entries)
    rows = [[ia, ib, int(score), len(columns)]
            + [v for col in columns for v in col]
            for (ia, ib, score, columns) in local_entries]
    max_len = max((len(r) for r in rows), default=4)
    dims = [torch.zeros(2, dtype=torch.int32) for _ in range(world)]
    torch.distributed.all_gather(
        dims, torch.tensor([len(rows), max_len], dtype=torch.int32))
    dims = torch.stack(dims).numpy()
    g_rows, g_len = int(dims[:, 0].max()), int(dims[:, 1].max())
    if g_rows == 0:
        return []
    payload = np.full((g_rows, g_len + 1), -1, np.int32)
    for r, row in enumerate(rows):
        payload[r, 0] = len(row)
        payload[r, 1:1 + len(row)] = row
    gathered = [torch.empty((g_rows, g_len + 1), dtype=torch.int32)
                for _ in range(world)]
    torch.distributed.all_gather(gathered, torch.from_numpy(payload))
    out = []
    for block in gathered:
        for row in block.numpy():
            n = int(row[0])
            if n < 4:
                continue
            vals = row[1:1 + n]
            ia, ib, score, ncol = (int(v) for v in vals[:4])
            cols = [tuple(int(x) for x in vals[4 + 3 * c:7 + 3 * c])
                    for c in range(ncol)]
            out.append((ia, ib, score, cols))
    return out


def pair_devices(devices: Optional[Sequence[torch.device]] = None
                 ) -> List[torch.device]:
    """This process's devices, over which a batch's lanes are split: by
    default every visible card by index, ``cuda:0`` to ``cuda:n-1`` (the
    counterpart of ``jax.local_devices()``), or ``[cpu]`` under
    ``LARA_PLATFORM=cpu``.  Local, not global, on purpose: each host solves
    its own shard of the pairs, and the hosts meet once, in
    :func:`gather_results`.  ``devices`` may name one device several times
    (one card split into several shards, or the CPU in the tests)."""
    if devices is not None:
        return list(devices)
    first = resolve_device()
    if first.type == "cpu":
        return [first]
    return [torch.device("cuda", k) for k in range(torch.cuda.device_count())]


def pad_batch(model: device_solver.BatchModel, pad: int
              ) -> device_solver.BatchModel:
    """Append ``pad`` trivial lanes: 1x1 problems with no duals, which
    converge in one iteration.  Their ``rev`` and ``qrank`` rows are the
    identity, which keeps every ``rev`` row an involution."""
    def ext(t, fill=0):
        block = torch.full((pad,) + tuple(t.shape[1:]), fill, dtype=t.dtype,
                           device=t.device)
        return torch.cat([t, block])

    d = model.qrank.shape[1]
    identity = torch.arange(d, dtype=torch.int32,
                            device=model.qrank.device).expand(pad, d)
    return device_solver.BatchModel(
        seq_score=ext(model.seq_score),
        active=ext(model.active, False),
        dual_l=ext(model.dual_l),
        dual_m=ext(model.dual_m),
        sscore=ext(model.sscore),
        rev=torch.cat([model.rev, identity]),
        dvalid=ext(model.dvalid, False),
        qrank=torch.cat([model.qrank, identity]),
        la=ext(model.la, 1),
        lb=ext(model.lb, 1),
    )


def solve_batch_sharded(model: device_solver.BatchModel, go, ge, step0,
                        la_max: int, lb_max: int, num_iterations: int,
                        max_nondecr: int, lookahead: int,
                        devices: Sequence[torch.device], scan_steps: int = 0
                        ) -> device_solver.BatchResult:
    """Solve ``model`` with its lanes split over ``devices``: padded to a
    multiple of their count, cut into contiguous equal blocks, each block
    copied to its device and solved by
    :func:`~lara_tpu_torch.solver.device_solver.solve_batch` on a thread of
    its own (under ``torch.cuda.device`` and on a stream of its own, which
    first waits for the model's upload).  The results are joined in lane
    order on ``devices[0]``, without the padding, after each shard's
    stream is done: ``solve_batch`` returns before its last dispatches
    end (it reads each flag one dispatch late)."""
    devices = list(devices)
    n_dev = len(devices)
    b = model.seq_score.shape[0]
    pad = (-b) % n_dev
    if pad:
        model = pad_batch(model, pad)
    per = (b + pad) // n_dev
    home = model.seq_score.device
    ready = None
    if home.type == "cuda":
        # the model was written on the caller's current stream
        ready = torch.cuda.Event()
        ready.record()

    def solve(k: int):
        """(the shard's result, an event after its last launch or None)"""
        dev = devices[k]
        with _shard_stream(dev, ready):
            block = device_solver.BatchModel(*(
                t[k * per:(k + 1) * per].to(dev, copy=True) for t in model))
            result = device_solver.solve_batch(
                block, go, ge, step0, la_max, lb_max, num_iterations,
                max_nondecr, lookahead, scan_steps=scan_steps)
            done = None
            if ready is not None:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(dev))
            return result, done

    with ThreadPoolExecutor(max_workers=n_dev) as pool:
        solved = list(pool.map(solve, range(n_dev)))
    parts = [result for result, _ in solved]
    for k, (_, done) in enumerate(solved):
        if done is not None:
            for dev in {devices[0], devices[k]}:
                torch.cuda.current_stream(dev).wait_event(done)
    fields = []
    for tensors in zip(*parts):
        for t in tensors:
            if t.is_cuda:
                # made on its shard's stream, read here on this thread's:
                # its block must not be reused before that read
                t.record_stream(torch.cuda.current_stream(t.device))
        fields.append(torch.cat([t.to(devices[0]) for t in tensors])[:b])
    return device_solver.BatchResult(*fields)


@contextlib.contextmanager
def _shard_stream(dev: torch.device, ready):
    """With a card's event ``ready``: ``dev`` as the thread's current card
    and a stream of its own, which first waits for ``ready``.  Nothing on
    the CPU."""
    if ready is None:
        yield
        return
    stream = torch.cuda.Stream(dev)
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        stream.wait_event(ready)
        yield

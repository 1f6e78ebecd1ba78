"""Build, bind and count the port's CUDA kernels.

Every ``csrc/*.cu`` compiles with ``nvcc`` (sm_90a), one process per source
started together, and the objects link into one shared library with a
plain C interface under ``_build/``, at first use and again whenever a
source (``*.cu`` or ``*.cuh``) is newer than the library (the scheme of
:func:`lara_tpu_torch.native.shared_library`).  ``ctypes`` binds it:
pointers and the CUDA stream go over as ``c_void_p``, every entry point
returns its ``cudaGetLastError()``, and :func:`check` raises on anything
but 0.  A failed build raises; nothing falls back to another path.

``launches`` counts kernel launches per kernel: each wrapper calls
:func:`count` where it launches its kernel, and nowhere else (the driver's
pipeline launches from a worker thread, so the count takes a lock).  A
CUDA graph runs its kernels without the wrappers: its capture runs them
under :func:`recording`, which takes this thread's counts out of
``launches`` into a record, and every replay adds that record back with
:func:`add` (:mod:`lara_tpu_torch.solver.dispatch_graph`).  So
``launches`` says how often each kernel ran, replays included.  Where a
graph loops over its capture on the card (a fused dispatch's WHILE node),
the iterations run are a count on the card: :func:`add_counted` copies it
to the host without waiting, and :func:`settle` adds the record that many
times once the copy has landed.

``clusters`` counts the launches of K1's clustered kernels (K1, K1-grid,
K4's sweep) by their CTAs per pair, ``(kernel name, CTAs) -> launches``,
through the same records and replays: :func:`count` with a cluster size
counts both.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
LIBRARY = os.path.join(BUILD_DIR, "libkernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC"]

#: kernel launches per kernel since the last :func:`reset_launches`
launches = {"gotoh_dp": 0, "gotoh_tb": 0, "matching_rounds": 0,
            "gotoh_grid_dp": 0, "gotoh_grid_tb": 0, "gotoh_resident": 0,
            "edge_sweep": 0, "edge_pack": 0, "wavefront_chain": 0,
            "loop_exit": 0, "iteration_head": 0, "iteration_lines": 0,
            "iteration_tail": 0}
#: launches of the clustered kernels by CTAs per pair, (name, CTAs) ->
#: launches, since the last :func:`reset_launches`
clusters = {}

_lock = threading.Lock()
_count_lock = threading.Lock()
_unsettled = []  # (event, pinned count, record) of add_counted
_local = threading.local()  # .record: this thread's recording() dict
_lib = None
_build_seconds = 0.0


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def reset_launches() -> None:
    with _count_lock:
        _unsettled.clear()
        clusters.clear()
        for name in launches:
            launches[name] = 0


def _tally(key, n: int) -> None:
    """Add ``n`` launches under ``key``: a kernel name, or a (name, CTAs
    per pair) of :data:`clusters`.  The caller holds ``_count_lock``."""
    if isinstance(key, tuple):
        clusters[key] = clusters.get(key, 0) + n
    else:
        launches[key] += n


def count(name: str, cluster: int = 0) -> None:
    """Add one launch of kernel ``name``, and with ``cluster`` one in
    :data:`clusters` at that many CTAs per pair (inside :func:`recording`
    on this thread, to its record instead)."""
    keys = (name, (name, cluster)) if cluster else (name,)
    record = getattr(_local, "record", None)
    if record is not None:
        for key in keys:
            record[key] = record.get(key, 0) + 1
        return
    with _count_lock:
        for key in keys:
            _tally(key, 1)


@contextlib.contextmanager
def recording():
    """A dict that gets this thread's launch counts inside the block, in
    place of ``launches``: a graph capture launches nothing."""
    outer = getattr(_local, "record", None)
    _local.record = record = {}
    try:
        yield record
    finally:
        _local.record = outer


def add(counts, times: int) -> None:
    """Add ``counts`` (a record of :func:`recording`: kernel name, or
    (name, CTAs per pair), -> launches) ``times`` times: the launches of a
    graph's replays."""
    with _count_lock:
        for key, n in counts.items():
            _tally(key, n * times)


def add_counted(counts, times) -> None:
    """Add ``counts`` ``times`` times, where ``times`` is an int32 scalar
    tensor: at once from the CPU; from the card, by a copy into pinned
    memory behind an event on the current stream, added at the next
    :func:`settle`, so that counting never waits for the card.  The
    counts whose copies have landed are added first, so that their
    pinned buffers go back to the allocator's cache."""
    import torch

    if not times.is_cuda:
        add(counts, int(times))
        return
    _settle(wait=False)
    host = torch.empty((), dtype=times.dtype, pin_memory=True)
    host.copy_(times, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(times.device))
    with _count_lock:
        _unsettled.append((done, host, counts))


def settle() -> None:
    """Wait for the counts of :func:`add_counted` and add them."""
    _settle(wait=True)


def _settle(wait: bool) -> None:
    with _count_lock:
        pending = [u for u in _unsettled if wait or u[0].query()]
        for u in pending:
            _unsettled.remove(u)
    for done, host, counts in pending:
        done.synchronize()
        add(counts, int(host))


def build_seconds() -> float:
    """Wall time the last build in this process took (0 if the library was
    already up to date)."""
    return _build_seconds


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            f"nvcc not found under {home}/bin or on PATH; the CUDA kernels "
            "need the CUDA toolkit")
    return found


def _run_all(cmds) -> None:
    """Run the ``nvcc`` commands ``cmds`` all at once; raise if any fails.
    No process outlives the call."""
    procs = []
    try:
        for cmd in cmds:
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        for cmd, proc in procs:
            _out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise KernelBuildError(
                    f"nvcc failed ({' '.join(cmd)}):\n{err[-4000:]}")
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise KernelBuildError(f"cannot run nvcc: {exc}") from exc
    finally:
        for _cmd, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _build(sources) -> None:
    global _build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    objects = [f"{tmp}.{os.path.basename(src)}.o" for src in sources]
    start = time.monotonic()
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                  for src, obj in zip(sources, objects)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objects]])
        os.replace(tmp, LIBRARY)
    finally:
        for obj in objects:
            if os.path.exists(obj):
                os.remove(obj)
    _build_seconds = time.monotonic() - start


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
        headers = glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
        if not os.path.exists(LIBRARY) or any(
                os.path.getmtime(src) > os.path.getmtime(LIBRARY)
                for src in sources + headers):
            _build(sources)
        lib = ctypes.CDLL(LIBRARY)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.lara_gotoh_dp.restype = i32
        lib.lara_gotoh_dp.argtypes = [
            ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr, ptr, ptr]
        lib.lara_wave_clusters.restype = i32
        lib.lara_wave_clusters.argtypes = [i32, i32, i32,
                                           ctypes.POINTER(i32)]
        lib.lara_gotoh_tb.restype = i32
        lib.lara_gotoh_tb.argtypes = [
            ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr, ptr, ptr]
        lib.lara_matching_rounds.restype = i32
        lib.lara_matching_rounds.argtypes = [
            ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr, ptr,
            ptr, ptr]
        lib.lara_gotoh_grid_dp.restype = i32
        lib.lara_gotoh_grid_dp.argtypes = [
            ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr, ptr, ptr]
        lib.lara_gotoh_grid_tb.restype = i32
        lib.lara_gotoh_grid_tb.argtypes = [
            ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr, ptr,
            ptr]
        lib.lara_gotoh_resident.restype = i32
        lib.lara_gotoh_resident.argtypes = [
            ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr, ptr,
            ptr]
        lib.lara_edge_sweep.restype = i32
        lib.lara_edge_sweep.argtypes = [
            ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr, ptr,
            ptr]
        lib.lara_edge_pack.restype = i32
        lib.lara_edge_pack.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr, ptr]
        lib.lara_wavefront_chain.restype = i32
        lib.lara_wavefront_chain.argtypes = [ptr, ptr, i32, i32, i32, i32, ptr]
        lib.lara_loop_graph.restype = i32
        lib.lara_loop_graph.argtypes = [
            ptr, ptr, i32, ptr, ctypes.POINTER(ptr), ctypes.POINTER(ptr)]
        lib.lara_loop_graph_launch.restype = i32
        lib.lara_loop_graph_launch.argtypes = [ptr, ptr]
        lib.lara_loop_graph_free.restype = i32
        lib.lara_loop_graph_free.argtypes = [ptr, ptr]
        lib.lara_iteration_head.restype = i32
        lib.lara_iteration_head.argtypes = [ptr] * 9 + [i32] * 7 + [ptr] * 6
        lib.lara_iteration_lines.restype = i32
        lib.lara_iteration_lines.argtypes = [ptr] * 14 + [i32] * 10 + [ptr] * 7
        lib.lara_iteration_tail.restype = i32
        lib.lara_iteration_tail.argtypes = [ctypes.POINTER(ptr)] \
            + [i32] * 7 + [ptr]
        lib.lara_smem_optin.restype = i32
        lib.lara_smem_optin.argtypes = [i32, ctypes.POINTER(i32)]
        lib.lara_cuda_error_string.restype = ctypes.c_char_p
        lib.lara_cuda_error_string.argtypes = [i32]
        _lib = lib
        return lib


def require(t, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``, and ``device`` is the calling thread's current card: the
    kernels read raw pointers, and the launchers work against the current
    card (its stream, its shared-memory limits)."""
    import torch

    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} "
            f"on {t.device} (contiguous={t.is_contiguous()})")
    current = torch.cuda.current_device()
    if t.device.index != current:
        raise ValueError(
            f"{name}: the tensor is on {t.device} but this thread's current "
            f"card is cuda:{current}; launch under torch.cuda.device"
            f"({t.device})")


def stream_of(t) -> int:
    """The handle of the current CUDA stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize does not report it)."""
    if rc != 0:
        text = library().lara_cuda_error_string(rc).decode()
        raise KernelLaunchError(f"{name}: CUDA error {rc} ({text})")

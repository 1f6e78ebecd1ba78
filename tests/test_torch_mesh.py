"""The port's several devices and several hosts, on the CPU.

``lara_tpu_torch.parallel.mesh`` against ``lara_tpu.parallel.mesh`` with
zero tolerance: the strided host shard, the padded batch, and the sharded
solve on ``[cpu] * k`` (the counterpart of ``tests/conftest.py``'s 8
virtual devices) against the port's one-device solve and JAX's sharded
solve; the CLI over 8 devices against JAX's CLI and the scalar mirror; the
split rule under the device floor; and real gloo process groups of two and
three ``python -m lara_tpu_torch`` processes, which must write the bytes
of one process, with process 0 alone writing.
"""

import os
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from lara_tpu import cli as jax_cli
from lara_tpu.parallel import mesh as jax_mesh
from lara_tpu.solver import device_solver as jax_solver
from lara_tpu_torch import app, convert
from lara_tpu_torch.io.records import InputStorage
from lara_tpu_torch.parallel import mesh
from lara_tpu_torch.params import Parameters
from lara_tpu_torch.solver import device_driver, device_solver
from lara_tpu_torch.utils import logging as port_logging

from tests.test_device_solver import write_family
from tests.test_torch_driver import _random_model, spy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
#: the variables of a multi-host launch, cleared around every test
HOST_VARS = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
             "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "LARA_NO_DISTRIBUTED")
#: the longest any one process of these tests may run
PROCESS_TIMEOUT = 120


@pytest.fixture(autouse=True)
def single_host(monkeypatch):
    for key in HOST_VARS + ("LARA_SPLIT_SINGLE",):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("LARA_PLATFORM", "cpu")
    yield
    port_logging.set_verbosity(0)


@pytest.mark.parametrize("process_count", [1, 2, 3, 4, 5])
def test_process_pair_shard_equals_jax(process_count):
    """0-7 pairs over 1-5 processes: the same strided shards as JAX, empty
    and ragged ones included, disjoint and complete."""
    for n in range(8):
        pairs = [(k, k + 1) for k in range(n)]
        shards = [mesh.process_pair_shard(pairs, pid, process_count)
                  for pid in range(process_count)]
        assert shards == [jax_mesh.process_pair_shard(pairs, pid,
                                                      process_count)
                          for pid in range(process_count)]
        assert sorted(p for s in shards for p in s) == pairs
    # outside a process group: rank 0 of 1, the whole list
    assert mesh.process_pair_shard([(0, 1), (0, 2)]) == [(0, 1), (0, 2)]


@pytest.mark.parametrize("pad", [1, 5])
def test_pad_batch_equals_jax(pad):
    rng = np.random.default_rng(3 + pad)
    model = _random_model(rng, 3, 6, 5, 7)
    got = mesh.pad_batch(convert.model_to_torch(model, CPU), pad)
    want = jax_mesh.pad_batch(jax_solver.BatchModel(*model), pad)
    for name, g, w in zip(device_solver.BatchModel._fields, got, want):
        assert g.numpy().dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    for row in got.rev.numpy():  # every row an involution
        np.testing.assert_array_equal(row[row], np.arange(len(row)))


def _family_batch(tmp_path, n, seed):
    """The numpy BatchModel rows of every pair of a ``write_family`` family
    (one 32x32 bucket, one row per pair, no padding) and its scan depth."""
    path = write_family(tmp_path, n=n, seed=seed)
    store = InputStorage(in_file=path)
    params = Parameters(in_file=path)
    pairs = app.enumerate_pairs(store)
    models, _ = device_driver._filter_and_build(store, pairs, params, 32, 32,
                                                CPU)
    dcap = device_driver._chunk_dcap(models)
    return (device_driver._model_rows(models, 32, 32, dcap),
            device_driver._scan_steps(models, dcap))


@pytest.mark.parametrize("n_records,k", [(5, 2), (5, 3), (5, 8), (3, 8)],
                         ids=["10-lanes-2", "10-lanes-3", "10-lanes-8",
                              "3-lanes-8"])
def test_sharded_solve_equals_one_device_and_jax(tmp_path, n_records, k):
    """10 lanes over 2, 3 and 8 devices (3 and 8 pad the batch), and 3
    lanes over 8 (most devices solve only padding): every field of the
    result equals the one-device solve and JAX's sharded solve."""
    rows, scan_steps = _family_batch(tmp_path, n_records, 7)
    args = (-6 * 8192, -2 * 8192, np.float32(1.0), 32, 32, 40, 5, 5)
    model = convert.model_to_torch(rows, CPU)
    one = device_solver.solve_batch(model, *args, scan_steps=scan_steps)
    sharded = mesh.solve_batch_sharded(model, *args, [CPU] * k,
                                       scan_steps=scan_steps)
    want = jax_mesh.solve_batch_sharded(
        jax_solver.BatchModel(*rows), *args,
        mesh=jax_mesh.pair_mesh(jax.devices()[:k]), scan_steps=scan_steps)
    for name, g, o, w in zip(device_solver.BatchResult._fields, sharded, one,
                             want):
        assert g.shape[0] == rows.la.shape[0], name
        np.testing.assert_array_equal(g.numpy(), o.numpy(), err_msg=name)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("n_records", [5, 3], ids=["10-pairs", "3-pairs"])
def test_cli_8_devices_equals_jax_and_mirror(tmp_path, monkeypatch,
                                             n_records):
    """``app.run`` over 8 CPU devices writes the bytes of JAX's CLI, which
    runs sharded on 8 virtual devices, and of the scalar mirror; with 3
    pairs the sharded batch pads both lanes and devices."""
    path = write_family(tmp_path, n=n_records, seed=7 if n_records == 5
                        else 11)
    shards = []
    spy(monkeypatch, mesh, "solve_batch_sharded",
        lambda model, *rest: shards.append(
            (model.la.shape[0], len(rest[-1]))))
    port_lib = tmp_path / "port.lib"
    app.run(Parameters(in_file=path, num_iterations=40,
                       out_file=str(port_lib)), devices=[CPU] * 8)
    assert shards == [(16 if n_records == 5 else 8, 8)]
    for backend in ("device", "reference"):
        lib = tmp_path / f"{backend}.lib"
        assert jax_cli.main(["-i", path, "-n", "40", "-w", str(lib),
                             "--backend", backend]) == 0
        assert port_lib.read_text() == lib.read_text(), backend


def test_one_device_does_not_shard(tmp_path, monkeypatch):
    path = write_family(tmp_path, n=4, seed=3)
    shards = []
    spy(monkeypatch, mesh, "solve_batch_sharded",
        lambda *args: shards.append(args))
    run = app.run(Parameters(in_file=path, num_iterations=20))
    assert not shards and len(run.results) == 6


def test_split_skips_where_the_device_floor_costs_more(monkeypatch):
    """LARA_SPLIT_SINGLE=1 over several devices: each half is floored at
    the device count, and the split is skipped where both halves together
    pad to more lanes than the unsplit chunk."""
    monkeypatch.setenv("LARA_SPLIT_SINGLE", "1")

    def halves(n, n_dev):
        plan = device_driver._split_single(
            [device_driver._Task(96, 96, list(range(n)))], n_dev)
        return [len(t.pairs) for t in plan]

    assert device_driver._padded_batch(6, 8) == 8
    assert device_driver._padded_batch(1, 8) == 1
    assert device_driver._padded_batch(3, 8) == 8
    assert halves(6, 8) == [6]      # 8 lanes unsplit, 8 + 8 split
    assert halves(16, 8) == [8, 8]  # 16 lanes either way
    assert halves(28, 8) == [14, 14]
    assert halves(28, 32) == [28]   # 32 lanes unsplit, 32 + 32 split
    assert halves(28, 1) == [14, 14]
    assert halves(9, 2) == [9]      # 5 + 4 pad to 8 + 4


def test_distributed_init_reads_the_jax_variables(monkeypatch):
    assert mesh.distributed_init() is False
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    with pytest.raises(ValueError, match="JAX_NUM_PROCESSES"):
        mesh.distributed_init()
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="JAX_PROCESS_ID"):
        mesh.distributed_init()
    monkeypatch.setenv("LARA_NO_DISTRIBUTED", "1")
    assert mesh.distributed_init() is False
    assert not torch.distributed.is_initialized()
    entries = [(0, 1, 7, [(0, 0, 500)])]
    assert mesh.gather_results(entries) == entries


def test_coordinator_without_count_runs_single_host(tmp_path, monkeypatch,
                                                    capsys):
    """A coordinator without ``JAX_NUM_PROCESSES``: torch cannot discover
    the cluster, so the run logs why and solves every pair as one host."""
    path = write_family(tmp_path, n=4, seed=3)
    single = tmp_path / "single.lib"
    app.run(Parameters(in_file=path, num_iterations=20,
                       out_file=str(single)))
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("JAX_PROCESS_ID", "0")
    lib = tmp_path / "multi.lib"
    run = app.run(Parameters(in_file=path, num_iterations=20, verbose=1,
                             out_file=str(lib)))
    err = capsys.readouterr().err
    assert "torch.distributed unavailable" in err
    assert "JAX_NUM_PROCESSES" in err and "host shard" not in err
    assert len(run.results) == 6 and lib.read_text() == single.read_text()


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in HOST_VARS}
    env.update(LARA_PLATFORM="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    env.update(extra)
    return env


def _cli(family, lib, verbose="0"):
    return [sys.executable, "-m", "lara_tpu_torch", "-i", str(family), "-n",
            "20", "-v", verbose, "-w", str(lib)]


def _run_hosts(family, lib, n_proc):
    """``python -m lara_tpu_torch`` as ``n_proc`` processes of one gloo
    group on this host: [(returncode, stderr)] in rank order.  A process
    still running after ``PROCESS_TIMEOUT`` seconds is killed with its
    process group, and so are the others."""
    port = _free_port()
    procs = [subprocess.Popen(
        _cli(family, lib, "1"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True,
        env=_env(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                 JAX_NUM_PROCESSES=str(n_proc), JAX_PROCESS_ID=str(pid)))
        for pid in range(n_proc)]
    try:
        outs = []
        for proc in procs:
            err = proc.communicate(timeout=PROCESS_TIMEOUT)[1]
            outs.append((proc.returncode, err))
        return outs
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()


def _single_host(family, lib):
    proc = subprocess.run(_cli(family, lib), env=_env(LARA_NO_DISTRIBUTED="1"),
                          capture_output=True, text=True,
                          timeout=PROCESS_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return lib.read_text()


def test_two_process_run_matches_single_process(tmp_path):
    """Two gloo processes (the JAX package's ``tests/test_distributed.py``
    case): each solves 3 of the 6 pairs, and process 0 alone writes the
    bytes of one process."""
    family = write_family(tmp_path, n=4, seed=3)
    single = _single_host(family, tmp_path / "single.lib")
    lib = tmp_path / "multi.lib"
    outs = _run_hosts(family, lib, 2)
    for rc, err in outs:
        assert rc == 0, err[-2000:]
        assert "host shard: 3/6 pairs" in err, err[-2000:]
    assert "non-zero host: process 0 writes the library" in outs[1][1]
    assert "non-zero host" not in outs[0][1]
    assert lib.read_text() == single


def test_three_process_empty_shards(tmp_path):
    """One pair over three processes: two hosts have empty shards and still
    join both gathers; process 0 writes the bytes of one process."""
    family = tmp_path / "pair.dbn"
    family.write_text(
        ">a\nGGGCGCAAGCCUUAAGGCGCCC\n(((((((......)))))))..\n"
        ">b\nGGGCGCAAGCCUUCAGGCGCCC\n(((((((......)))))))..\n")
    single = _single_host(family, tmp_path / "single.lib")
    lib = tmp_path / "multi.lib"
    outs = _run_hosts(family, lib, 3)
    for rc, err in outs:
        assert rc == 0, err[-2000:]
    errs = [err for _, err in outs]
    assert sum("host shard: 0/1 pairs" in e for e in errs) == 2
    assert "host shard: 1/1 pairs" in errs[0]
    assert lib.read_text() == single

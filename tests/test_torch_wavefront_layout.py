"""KB, the wavefront-layout microbenchmark, vs. the JAX source.

``lara_tpu_torch.benchmark.profile_wavefront_layout.chain_plain`` is held,
exactly, against the Pallas kernel of ``benchmark/profile_wavefront_layout.py``
(``make_chain``, nested in that script's ``main``: its source is taken out
with ``ast`` and run in interpret mode on the CPU) at the script's three
layouts and at values near ``INT32_MAX``, where the adds wrap.  A numpy
model of the CUDA kernel's thread mapping (``csrc/wavefront_chain.cu``: a
warp per row, a run of ``cols / 32`` columns per lane, the run's first
element by a shuffle from the lane before, the carry through shared memory)
is held against the plain version, and mutants of it fail.  The command
line runs under ``LARA_PLATFORM=cpu``, and the SASS report's parser
(``lara_tpu_torch.benchmark.sass_report``) reads a made-up listing.  ``tests/test_torch_cuda.py`` holds
the kernel against the plain version on a card.
"""

import ast
import functools
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lara_tpu_torch.benchmark import profile_wavefront_layout as kb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "benchmark", "profile_wavefront_layout.py")
KERNEL = os.path.join(REPO, "lara_tpu_torch", "csrc",
                      "wavefront_chain.cu")
INT32_MAX = 2**31 - 1


@functools.lru_cache(maxsize=None)
def _jax_make_chain():
    """The source's ``make_chain``, with ``pl.pallas_call`` in interpret
    mode: its ``BLOCK`` assignment and the nested function, taken out of
    ``main`` with ``ast`` and run in a namespace of their own."""
    with open(SOURCE) as handle:
        tree = ast.parse(handle.read(), SOURCE)
    main = next(node for node in tree.body
                if isinstance(node, ast.FunctionDef) and node.name == "main")
    body = [node for node in main.body
            if (isinstance(node, ast.Assign)
                and [t.id for t in node.targets] == ["BLOCK"])
            or (isinstance(node, ast.FunctionDef)
                and node.name == "make_chain")]
    assert len(body) == 2, "BLOCK and make_chain moved in the source"
    module = ast.Module(body=body, type_ignores=[])
    interpret = types.SimpleNamespace(
        **{name: getattr(pl, name) for name in dir(pl)
           if not name.startswith("_")})
    interpret.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    namespace = {"jax": jax, "jnp": jnp, "pl": interpret, "pltpu": pltpu,
                 "I32": jnp.int32}
    exec(compile(module, SOURCE, "exec"), namespace)
    assert namespace["BLOCK"] == kb.BLOCK
    return namespace["make_chain"]


def _jax_chain(x, reps, carry):
    rows, cols = x.shape
    f = _jax_make_chain()(rows, cols, carry)
    return np.asarray(f(jnp.array([[reps]], jnp.int32), jnp.asarray(x)))


# (rows, cols, carry, reps, seed): the source's three layouts, then the
# packed one near INT32_MAX (seed None), where h + 1 and best + (t & 3) wrap
CASES = [(1, 1664, False, 1, 1), (8, 256, True, 2, 2),
         (8, 1664, False, 1, 3), (8, 256, True, 1, None)]


def _input(rows, cols, seed):
    if seed is None:
        rng = np.random.default_rng(99)
        return (INT32_MAX - rng.integers(0, 300, (rows, cols))).astype(
            np.int32)
    rng = np.random.default_rng(seed)
    return rng.integers(-1000, 1000, (rows, cols)).astype(np.int32)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[:4]}")
def test_chain_plain_matches_the_jax_source(case):
    rows, cols, carry, reps, seed = case
    x = _input(rows, cols, seed)
    want = _jax_chain(x, reps, carry)
    got = kb.chain_plain(torch.from_numpy(x), reps, carry)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if seed is None:  # the wrap happened
        assert (want < 0).any() and (x > 0).all()


def _model(x, reps, carry, mutant=None):
    """The kernel's thread mapping in numpy: warp r on row r, lane l on the
    run of columns [l * run, l * run + run) in m[r, l] and h[r, l], the
    elements updated from the last down; the run's first element takes
    lane l-1's last by a shuffle (lane 0: -5, or with carry row r-1's last
    column from the shared buffer of this step's parity, row 0 taking row
    rows-1's).  Asserts where each shifted value comes from.  ``mutant``:
    "no_row_wrap" (row 0 takes -5), "new_m" (h from the new m),
    "ascending" (elements updated from the first up), "no_lane0" (lane 0
    keeps the shuffle's own value)."""
    rows, cols = x.shape
    assert cols % 32 == 0
    run = cols // 32
    wrap = np.int64(2**32)

    def w(v):
        return (np.asarray(v, np.int64) + 2**31) % wrap - 2**31

    m = x.astype(np.int64).reshape(rows, 32, run)
    h = w(m + 1)
    col = np.arange(cols).reshape(32, run)
    # the column each element holds, and the row/column each value came from
    src_col = np.broadcast_to(col, (rows, 32, run))
    assert np.array_equal(src_col.reshape(rows, cols)[0], np.arange(cols))
    buf = np.zeros((2, rows), np.int64)
    for _ in range(reps):
        for t in range(kb.BLOCK):
            # __shfl_up_sync(m[run-1], 1): lane l gets lane l-1's; lane 0
            # its own
            first = np.concatenate([m[:, :1, run - 1], m[:, :-1, run - 1]],
                                   axis=1)
            first_col = np.concatenate(
                [src_col[:, :1, run - 1], src_col[:, :-1, run - 1]], axis=1)
            assert np.all(first_col[:, 1:] == col[1:, 0] - 1)
            if carry:
                buf[t & 1] = m[:, 31, run - 1]
                up = np.arange(rows) - 1
                if mutant != "no_row_wrap":
                    up %= rows
                    assert np.array_equal(buf[t & 1][up],
                                          m[(np.arange(rows) - 1) % rows,
                                            31, run - 1])
                    lane0 = buf[t & 1][up]
                else:
                    lane0 = np.where(up >= 0, buf[t & 1][np.maximum(up, 0)],
                                     -5)
            else:
                lane0 = np.full(rows, -5, np.int64)
            if mutant != "no_lane0":
                first[:, 0] = lane0
            add = t & 3
            ct = t % cols
            order = range(run) if mutant == "ascending" \
                else range(run - 1, -1, -1)
            for e in order:
                ms = m[:, :, e - 1] if e > 0 else first
                best = np.maximum(ms, h[:, :, e])
                mn = np.where(col[:, e] == ct, -7, w(best + add))
                old = mn if mutant == "new_m" else m[:, :, e]
                h[:, :, e] = np.maximum(w(h[:, :, e] + 1), w(old - 2))
                m[:, :, e] = mn
    return w(m + h).reshape(rows, cols).astype(np.int32)


@pytest.mark.parametrize("rows,cols,carry", [(1, 1664, False),
                                             (8, 256, True),
                                             (8, 1664, False),
                                             (3, 64, True), (1, 32, True)])
def test_thread_model_matches_plain(rows, cols, carry):
    x = _input(rows, cols, rows * cols)
    want = kb.chain_plain(torch.from_numpy(x), 2, carry).numpy()
    np.testing.assert_array_equal(_model(x, 2, carry), want)
    near = _input(rows, cols, None)
    np.testing.assert_array_equal(
        _model(near, 1, carry),
        kb.chain_plain(torch.from_numpy(near), 1, carry).numpy())


@pytest.mark.parametrize("mutant,carry", [
    ("no_row_wrap", True), ("new_m", False), ("new_m", True),
    ("ascending", False), ("no_lane0", False), ("no_lane0", True)])
def test_thread_model_mutants_fail(mutant, carry):
    rows, cols = (8, 256) if carry else (1, 1664)
    x = _input(rows, cols, 5)
    want = kb.chain_plain(torch.from_numpy(x), 1, carry).numpy()
    assert not np.array_equal(_model(x, 1, carry, mutant), want)


def test_chain_wrapper_runs_plain_on_the_cpu():
    x = torch.from_numpy(_input(8, 256, 7))
    np.testing.assert_array_equal(kb.chain(x, 2, True).numpy(),
                                  kb.chain_plain(x, 2, True).numpy())
    np.testing.assert_array_equal(kb.chain(x, 0, False).numpy(),
                                  (2 * x + 1).numpy())


def test_block_and_run_lengths_match_the_kernel():
    """The kernel's block is the module's; it is built for the runs of the
    three layouts (52 and 8 columns a lane)."""
    with open(KERNEL) as handle:
        src = handle.read()
    assert int(re.search(r"constexpr int kBlock = (\d+);", src).group(1)) \
        == kb.BLOCK
    runs = {int(r) for r in re.findall(r"case (\d+): return launch<", src)}
    assert {cols // 32 for _l, _r, cols, _c in kb.LAYOUTS} == runs



_SASS = """
\t\tFunction : _Z6kernelILi8EEvPi
        /*0000*/                   S2R R0, SR_TID.X ;         /* 0x0 */
                                                               /* 0x0 */
        /*0010*/                   VIADD R1, R0, 0x1 ;        /* 0x0 */
        /*0020*/                   VIMNMX R2, R1, R0, !PT ;   /* 0x0 */
        /*0030*/              @!P0 BRA 0x50 ;                 /* 0x0 */
        /*0040*/                   STL [R1+0x4], R2 ;         /* 0x0 */
        /*0050*/               @P1 BRA 0x10 ;                 /* 0x0 */
        /*0060*/                   EXIT ;                     /* 0x0 */
        /*0070*/                   BRA 0x70;                  /* 0x0 */
\t\tFunction : _Z6kernelILi52EEvPi
        /*0000*/                   LDL R3, [R1] ;             /* 0x0 */
        /*0010*/                   EXIT ;                     /* 0x0 */
"""


def test_sass_report_counts_loops_and_spills():
    """``lara_tpu_torch.benchmark.sass_report`` on a made-up listing: a
    branch back to an earlier address closes a loop over the instructions
    between them (a forward branch does not), predicates and modifiers are
    dropped from opcodes, and LDL/STL count per kernel."""
    from lara_tpu_torch.benchmark.sass_report import report

    got = report(_SASS)
    assert list(got) == ["_Z6kernelILi8EEvPi", "_Z6kernelILi52EEvPi"]
    first = got["_Z6kernelILi8EEvPi"]
    assert first["instructions"] == 8 and first["spills"] == 1
    assert first["loops"] == [
        (0x10, 0x50, 5, {"VIADD": 1, "VIMNMX": 1, "BRA": 2, "STL": 1}),
        (0x70, 0x70, 1, {"BRA": 1})]
    assert got["_Z6kernelILi52EEvPi"] == {"instructions": 2, "spills": 1,
                                          "loops": []}


def test_cli_on_the_cpu():
    """``python -m lara_tpu_torch.benchmark.profile_wavefront_layout`` at
    tiny trip counts under ``LARA_PLATFORM=cpu``: one line per layout, then
    the device; without CUDA and without ``LARA_PLATFORM=cpu`` it fails."""
    cmd = [sys.executable, "-m",
           "lara_tpu_torch.benchmark.profile_wavefront_layout", "--lo", "1",
           "--hi", "2", "--reps", "1"]
    env = dict(os.environ, LARA_PLATFORM="cpu")
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert [line.split(":")[0] for line in lines[:3]] == \
        [label for label, *_ in kb.LAYOUTS]
    assert all(re.search(r": -?[0-9.]+ us/step \(plain version on the "
                         r"CPU\)$", line) for line in lines[:3])
    assert lines[3:] == ["device: cpu"]
    env.pop("LARA_PLATFORM")
    if not torch.cuda.is_available():
        proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode != 0
        assert "needs CUDA" in proc.stderr

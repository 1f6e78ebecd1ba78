"""The PyTorch port end to end on the CPU (``LARA_PLATFORM=cpu``).

The port's driver and CLI must write the same library bytes as the JAX
device backend and the scalar mirror: on the ``write_family`` families of
``tests/test_device_solver.py`` in binary, ``-l`` linear and ``-b auto``
modes, and on the golden configs of ``tests/test_golden_configs.py``
(frozen mirror output that the JAX device backend is locked to).  The
host-matching modes must reach the hybrid backend.  The port must not load JAX and must not fall back to the CPU
when CUDA is missing.  The driver's scheduling knobs are held in
``tests/test_torch_driver.py``.
"""

import os
import subprocess
import sys

import pytest
import torch

from lara_tpu_torch import _device, app
from lara_tpu_torch.io.records import InputStorage
from lara_tpu_torch.io.writers import OutputLibrary
from lara_tpu_torch.params import Parameters
from lara_tpu_torch.solver import device_driver

from tests.test_device_solver import run_backend, write_family

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_port(path, **kw):
    params = Parameters(in_file=path, **kw)
    store = InputStorage(in_file=path)
    lib = OutputLibrary(store, params.out_format)
    pairs = app.enumerate_pairs(store)
    for res in device_driver.solve_all(store, pairs, params,
                                       [torch.device("cpu")]):
        lib.add_alignment(res.seq_indices, res.columns, res.score)
    return lib.to_string()


@pytest.mark.parametrize("mode,kw", [
    ("binary", dict(num_iterations=60)),
    ("linear", dict(num_iterations=60, library_score_min=0,
                    library_score_max=100, library_score_is_linear=True)),
    ("balance-auto", dict(num_iterations=60, balance_auto=True)),
])
def test_family_matches_jax_and_mirror(tmp_path, mode, kw):
    path = write_family(tmp_path, n=4, seed={"binary": 0, "linear": 5,
                                             "balance-auto": 21}[mode])
    port = run_port(path, **kw)
    assert port == run_backend(path, "reference", **kw)
    assert port == run_backend(path, "device", **kw)


def write_conflicting(tmp_path):
    path = tmp_path / "conflict.dbn"
    path.write_text(
        ">x\nGGGAAAGGGAAACCCAAACCC\n(((...(((...)))...)))\n"
        ">y\nGGGAAAGGGAAACCCAAACCC\n(((...)))...(((...)))\n"
        ">z\nGGGAAAGGGAAACCCAAACC\n((....((....))....))\n"
    )
    return str(path)


def test_conflicting_structures_match_mirror(tmp_path):
    path = write_conflicting(tmp_path)
    port = run_port(path, num_iterations=80)
    assert port == run_backend(path, "reference", num_iterations=80)


def test_chunked_batches_match_one_batch(tmp_path, monkeypatch):
    """LARA_MAX_BATCH cuts one bucket into several chunks (and padded
    batch widths), and -j builds the models on threads; the bytes stay the
    same."""
    path = write_family(tmp_path, n=5, seed=41)
    whole = run_port(path, num_iterations=50)
    monkeypatch.setenv("LARA_MAX_BATCH", "3")
    assert run_port(path, num_iterations=50, threads=3) == whole


def test_length_buckets_match_mirror(tmp_path):
    """Two length classes make two buckets (32x32 and 64x64 pads)."""
    short = "GGGCGCAAGCCUUAAGGCGCCC"
    long_ = short + "AAGGCUUAGC" + short
    hairpin = "(((((((......)))))))"
    records = [("s0", short, hairpin + ".."),
               ("s1", short[:-1] + "A", hairpin + ".."),
               ("l0", long_, hairpin + "." * 12 + hairpin + ".."),
               ("l1", long_[:-3] + "GCC", "." * len(long_))]
    path = tmp_path / "mixed.dbn"
    path.write_text("".join(f">{name}\n{seq}\n{st}\n"
                            for name, seq, st in records))
    port = run_port(str(path), num_iterations=40)
    assert port == run_backend(str(path), "reference", num_iterations=40)


@pytest.mark.parametrize("in_name,golden,extra", [
    ("cfg1_pair.dbn", "cfg1.lib", {}),
    ("cfg2_bpp.ebpseq", "cfg2.lib", {"num_iterations": 100}),
    ("cfg3_family.sth", "cfg3.lib", {"num_iterations": 50}),
])
def test_golden_configs(in_name, golden, extra, tmp_path, monkeypatch):
    monkeypatch.setenv("LARA_PLATFORM", "cpu")
    out = tmp_path / "out.lib"
    run = app.run(Parameters(in_file=os.path.join(GOLDEN, in_name),
                             out_file=str(out), **extra))
    with open(os.path.join(GOLDEN, golden)) as handle:
        assert out.read_text() == handle.read()
    if golden == "cfg1.lib":
        # cfg5: the same solve in the pairs output format
        pairs = OutputLibrary(run.library.records, "pairs")
        for res in run.results:
            pairs.add_alignment(res.seq_indices, res.columns, res.score)
        with open(os.path.join(GOLDEN, "cfg5.pairs")) as handle:
            assert pairs.to_string() == handle.read()


def test_cli_runs_without_jax(tmp_path):
    """The port's CLI (with --msa, and on the hybrid backend with -m 0)
    never imports JAX, nor anything of the JAX package."""
    path = tmp_path / "two.dbn"
    path.write_text(">h1\nGGGGAAAACCCC\n((((....))))\n"
                    ">h2\nGGGCAAAAGCCC\n(((.(...))))\n")
    out, msa = tmp_path / "out.lib", tmp_path / "msa.fa"
    exact = tmp_path / "exact.lib"
    code = (
        "import sys\n"
        "from lara_tpu_torch.cli import main\n"
        f"rc = main(['-i', {str(path)!r}, '-w', {str(out)!r}, "
        f"'--msa', {str(msa)!r}])\n"
        "assert rc == 0, rc\n"
        f"rc = main(['-i', {str(path)!r}, '-w', {str(exact)!r}, '-m', '0'])\n"
        "assert rc == 0, rc\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not [m for m in sys.modules if m == 'lara_tpu'\n"
        "            or m.startswith('lara_tpu.')], 'lara_tpu was imported'\n"
    )
    env = dict(os.environ, LARA_PLATFORM="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert out.read_text().startswith("! T-COFFEE_LIB_FORMAT_01")
    assert msa.read_text().count(">") == 2
    assert exact.read_text() == run_backend(str(path), "reference",
                                            matching=0)


def test_cli_reference_backend_matches_golden(tmp_path):
    out = tmp_path / "out.lib"
    from lara_tpu_torch.cli import main

    assert main(["-i", os.path.join(GOLDEN, "cfg1_pair.dbn"), "-w", str(out),
                 "--backend", "reference"]) == 0
    with open(os.path.join(GOLDEN, "cfg1.lib")) as handle:
        assert out.read_text() == handle.read()


def test_default_device_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.delenv("LARA_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        _device.resolve_device()
    path = write_family(tmp_path, n=2, seed=1)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        app.run(Parameters(in_file=path))
    monkeypatch.setenv("LARA_PLATFORM", "gpu")
    with pytest.raises(RuntimeError, match="needs CUDA"):
        _device.resolve_device()
    monkeypatch.setenv("LARA_PLATFORM", "tpu")
    with pytest.raises(ValueError):
        _device.resolve_device()
    monkeypatch.setenv("LARA_PLATFORM", "cpu")
    assert _device.resolve_device() == torch.device("cpu")


def test_kernel_build_failure_raises(tmp_path, monkeypatch):
    """No nvcc, or an nvcc that fails: the build raises."""
    from lara_tpu_torch import _build

    build = tmp_path / "build"
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(build))
    monkeypatch.setattr(_build, "LIBRARY", str(build / "libkernels.so"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.library()
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\necho 'sm_90a: no such target' >&2\nexit 1\n")
    nvcc.chmod(0o755)
    with pytest.raises(_build.KernelBuildError, match="no such target"):
        _build.library()
    assert not build.joinpath("libkernels.so").exists()


@pytest.mark.parametrize("kw,env", [
    ({"matching": 0, "num_iterations": 80}, {}),
    ({"matching": 9, "num_iterations": 80}, {}),
    ({"num_iterations": 80}, {"LARA_SOLVER": "hybrid"}),
])
def test_host_matching_modes_route_to_hybrid(tmp_path, monkeypatch, kw, env):
    """Exact matching, lookahead beyond 8 and LARA_SOLVER=hybrid run on the
    hybrid backend and write the scalar mirror's library bytes."""
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    from lara_tpu_torch.solver import hybrid_driver

    buckets = []
    solve_bucket = hybrid_driver._solve_bucket

    def spy(*args):
        buckets.append(args[3:5])
        return solve_bucket(*args)

    monkeypatch.setattr(hybrid_driver, "_solve_bucket", spy)
    path = write_conflicting(tmp_path)
    port = run_port(path, **kw)
    assert buckets, "the hybrid backend was not used"
    assert port == run_backend(path, "reference", **kw)

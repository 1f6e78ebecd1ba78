"""The port stands alone: it imports nothing of the JAX package.

``lara_tpu_torch`` carries its own copies of the JAX-free host modules
(parameters, input and output, scoring, interaction models, the scalar
mirror, the native libraries, the MSA, the structure predictor) and
``chip_smoke.py`` its own workloads (``lara_tpu_torch.workloads``).  An
AST scan of every port module (its ``benchmark`` subpackage included) and
``chip_smoke.py`` finds no import of ``jax``,
``lara_tpu``, ``bench`` or the repository's ``benchmark`` folder; a
subprocess that imports
every port module and runs the CLI on every path loads neither JAX nor
``lara_tpu``; and the
copies give what the originals give on the same inputs, with zero
tolerance.

The port's tests compare against the JAX package's native libraries, which
that package builds in place on first use, with no lock across processes:
test workers that build one library at once can load a half-written file
or see g++ fail.  So this module, which every worker imports while it
collects the tests, first builds all four of them once (:func:`build_jax_native`,
under a file lock, each into a temporary file renamed into place), before
any test runs; the JAX package then finds them up to date.
"""

import ast
import dataclasses
import fcntl
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "lara_tpu_torch")
JAX_NATIVE = os.path.join(REPO, "lara_tpu", "native")
#: the JAX package's native libraries, each with the sources it links
#: (``lara_tpu/native/{blossom,lagrange,baseline}.py``,
#: ``lara_tpu/solver/interactions.py``)
JAX_LIBRARIES = {"blossom": (), "lagrange_host": ("blossom",),
                 "baseline": ("lagrange_host", "blossom"),
                 "model_build": ()}


def _stale_jax_libraries():
    """{target: sources} of the JAX libraries missing or older than a
    source: the test of ``lara_tpu.native.shared_library``."""
    stale = {}
    for name, extra in JAX_LIBRARIES.items():
        sources = [os.path.join(JAX_NATIVE, "src", f"{n}.cpp")
                   for n in (name, *extra)]
        target = os.path.join(JAX_NATIVE, "lib", f"lib{name}.so")
        if not os.path.exists(target) or any(
                os.path.getmtime(target) < os.path.getmtime(src)
                for src in sources):
            stale[target] = sources
    return stale


def build_jax_native():
    """Build the JAX package's native libraries that are missing or stale,
    with the g++ command of ``lara_tpu.native.shared_library``, all at once
    under an exclusive lock on a file in the temporary directory, each into
    a temporary file renamed into place, so that no process ever loads a
    partial library.  Returns None when all four are up to date, or why
    they cannot be built (no g++); raises if g++ fails."""
    if not _stale_jax_libraries():
        return None
    if shutil.which("g++") is None:
        return "g++ is not on PATH"
    lock = os.path.join(tempfile.gettempdir(), "lara_tpu_native_build.lock")
    with open(lock, "a") as handle:
        fcntl.flock(handle, fcntl.LOCK_EX)
        try:
            stale = _stale_jax_libraries()  # another process may have built
            os.makedirs(os.path.join(JAX_NATIVE, "lib"), exist_ok=True)
            procs = []
            for target, sources in stale.items():
                tmp = f"{target}.{os.getpid()}.tmp"
                procs.append((target, tmp, subprocess.Popen(
                    ["g++", "-std=c++17", "-O2", "-fPIC", "-shared", "-o",
                     tmp, *sources], stderr=subprocess.PIPE, text=True)))
            failed = []
            for target, tmp, proc in procs:
                err = proc.communicate(timeout=300)[1]
                if proc.returncode == 0:
                    os.replace(tmp, target)
                else:
                    failed.append(f"{target}: {err[-2000:]}")
                    if os.path.exists(tmp):
                        os.remove(tmp)
        finally:
            fcntl.flock(handle, fcntl.LOCK_UN)
    if failed:
        raise RuntimeError("g++ failed for " + "\n".join(failed))
    return None


try:
    _JAX_NATIVE_MISSING, _JAX_NATIVE_ERROR = build_jax_native(), None
except (OSError, RuntimeError, subprocess.TimeoutExpired) as exc:
    _JAX_NATIVE_MISSING, _JAX_NATIVE_ERROR = None, exc


def jax_native_or_skip():
    """For a test that needs the JAX package's native libraries: skip when
    there is no g++ (and say so), fail when their build failed."""
    if _JAX_NATIVE_MISSING:
        pytest.skip(f"the JAX package's native libraries: "
                    f"{_JAX_NATIVE_MISSING}")
    if _JAX_NATIVE_ERROR is not None:
        raise _JAX_NATIVE_ERROR


def _port_files():
    files = []
    for root, dirs, names in os.walk(PORT):
        dirs[:] = sorted(d for d in dirs if not d.startswith(("_build",
                                                               "__")))
        files += [os.path.join(root, n) for n in sorted(names)
                  if n.endswith(".py")]
    return files


PORT_FILES = _port_files()


def _module_names():
    """Every port module but ``__main__``, which runs the CLI."""
    names = []
    for path in PORT_FILES:
        if path.endswith("__main__.py"):
            continue
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        names.append(rel[:-len(".__init__")] if rel.endswith(".__init__")
                     else rel)
    return names


def port_params(params):
    """The port's ``Parameters`` with every field of the JAX package's
    ``params`` (the derived fields are recomputed the same way)."""
    from lara_tpu_torch.params import Parameters

    return Parameters(**{f.name: getattr(params, f.name)
                         for f in dataclasses.fields(params)})


#: top-level names the port may not import: JAX, the JAX package, the
#: bench script and the repository's benchmark folder (whose scripts import
#: the JAX package; the port's own is ``lara_tpu_torch.benchmark``)
FOREIGN = ("jax", "lara_tpu", "bench", "benchmark")


def _foreign_imports(path):
    """Imports of :data:`FOREIGN` names (the exact package or a submodule:
    not ``lara_tpu_torch``, nor ``lara_tpu_torch.benchmark``) in the source
    at ``path``."""
    with open(path) as handle:
        tree = ast.parse(handle.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in FOREIGN:
                bad.append((node.lineno, name))
    return bad


@pytest.mark.parametrize(
    "path", PORT_FILES + [os.path.join(REPO, "chip_smoke.py")],
    ids=lambda p: os.path.relpath(p, REPO))
def test_no_import_of_the_jax_package(path):
    assert _foreign_imports(path) == []


def test_the_scan_finds_foreign_imports(tmp_path):
    src = tmp_path / "mod.py"
    src.write_text("import lara_tpu\nfrom lara_tpu.params import P\n"
                   "import lara_tpu_torch\nfrom lara_tpu_torch import app\n"
                   "def f():\n    import bench\n"
                   "    from lara_tpu import msa\n"
                   "import benchmark.profile_wavefront_layout\n"
                   "from lara_tpu_torch.benchmark import "
                   "profile_wavefront_layout\n"
                   "from benchmark import pipeline\nimport jax.numpy\n"
                   "from . import benchmark\n")
    assert sorted(_foreign_imports(str(src))) == [
        (1, "lara_tpu"), (2, "lara_tpu.params"), (6, "bench"),
        (7, "lara_tpu"), (8, "benchmark.profile_wavefront_layout"),
        (10, "benchmark"), (11, "jax.numpy")]


def test_cli_paths_load_neither_jax_nor_lara_tpu(tmp_path):
    """Every port module imports, and ``python -m lara_tpu_torch`` runs on
    the CPU under -m 5, -m 0, --backend reference, --msa and
    --predict builtin (a fasta without structures), and
    ``python -m lara_tpu_torch.evaluate`` scores the MSA, in one process
    that then holds neither ``jax`` nor any ``lara_tpu`` module."""
    dbn = tmp_path / "two.dbn"
    dbn.write_text(">h1\nGGGGAAAACCCC\n((((....))))\n"
                   ">h2\nGGGCAAAAGCCC\n(((.(...))))\n")
    fasta = tmp_path / "two.fa"
    fasta.write_text(">a\nGGGCGCAAGCCUUAAGGCGCCC\n"
                     ">b\nGGGCGAAAGCCUUAGGGCGCCC\n")
    runs = [["-i", str(dbn)], ["-i", str(dbn), "-m", "0"],
            ["-i", str(dbn), "--backend", "reference"],
            ["-i", str(dbn), "--msa", str(tmp_path / "msa.fa")],
            ["-i", str(fasta), "--predict", "builtin"]]
    code = (
        "import importlib, runpy, sys\n"
        f"for name in {_module_names()!r}:\n"
        "    importlib.import_module(name)\n"
        f"for k, args in enumerate({runs!r}):\n"
        f"    sys.argv = ['lara-tpu-torch', *args, '-w', {str(tmp_path)!r} + f'/out{{k}}.lib']\n"
        "    try:\n"
        "        runpy.run_module('lara_tpu_torch', run_name='__main__')\n"
        "    except SystemExit as exc:\n"
        "        assert exc.code in (0, None), (args, exc.code)\n"
        f"msa = {str(tmp_path / 'msa.fa')!r}\n"
        "sys.argv = ['evaluate', 'sps', msa, msa]\n"
        "try:\n"
        "    runpy.run_module('lara_tpu_torch.evaluate', run_name='__main__')\n"
        "except SystemExit as exc:\n"
        "    assert exc.code in (0, None), exc.code\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'lara_tpu', "
        "'bench', 'benchmark') or m.startswith(('jax.', 'lara_tpu.', "
        "'benchmark.')))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, LARA_PLATFORM="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    for k in range(len(runs)):
        text = (tmp_path / f"out{k}.lib").read_text()
        assert text.startswith("! T-COFFEE_LIB_FORMAT_01"), k
    assert (tmp_path / "msa.fa").read_text().count(">") == 2
    assert proc.stdout.splitlines()[-1] == "1.0000"


ARGVS = [
    ["-i", "x.fa"],
    ["-i", "x.fa", "-m", "0", "-n", "77", "-a", "9", "-f", "0.5"],
    ["-i", "x.fa", "-l", "0", "100", "-o", "pairs", "-j", "3"],
    ["-i", "x.fa", "-b", "auto", "-y", "-8", "-x", "-1.5", "-c", "2",
     "-u", "10", "-e", "0.5", "-p", "1"],
    ["-i", "x.fa", "--backend", "reference", "--predict", "none",
     "-v", "2"],
]


def _params_fields(params):
    return [np.asarray(v).tolist() if isinstance(v, np.ndarray) else v
            for v in dataclasses.astuple(params)]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a[2:]) or "-")
def test_parameters_parse_as_the_originals(argv):
    from lara_tpu import params as jax_params
    from lara_tpu_torch import params as port

    try:
        want = jax_params.parse_args(argv)
    except SystemExit:
        with pytest.raises(SystemExit):
            port.parse_args(argv)
        return
    got = port.parse_args(argv)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    assert _params_fields(got) == _params_fields(want)
    assert _params_fields(port_params(want)) == _params_fields(want)


def _records(records):
    return [dataclasses.astuple(r) for r in records]


@pytest.mark.parametrize("name,kw", [
    ("make_family", dict(n=3)),
    ("make_family", dict(n=2, length=60, seed=3)),
    ("make_long_family", dict(n=2, length=200, seed=31, mutations=12)),
    ("make_long_family", dict(n=3, length=400)),
])
def test_workloads_equal_bench(name, kw):
    import bench
    from lara_tpu_torch import workloads

    assert _records(getattr(workloads, name)(**kw)) == \
        _records(getattr(bench, name)(**kw))


def test_full_depth_ok_equals_bench():
    import bench
    from lara_tpu_torch import workloads
    from lara_tpu_torch.solver.reference_driver import PairResult

    res = PairResult(seq_indices=(0, 1), columns=[(0, 0, 500)], score=3,
                     iterations=9, best_upper=4, best_lower=3)
    for args in [([(0, 0, 500)], 3, 4, 9), ([(0, 0, 500)], 3, 4, 8),
                 ([(0, 1, 500)], 3, 4, 9), ([(0, 0, 500)], 2, 4, 9)]:
        assert workloads.full_depth_ok(res, *args) == \
            bench._full_depth_ok(res, *args)


@pytest.mark.parametrize("sequence", [
    "GGGCGCAAGCCUUAAGGCGCCC",
    "GCGGAUUUAGCUCAGUUGGGAGAGCGCCAGACUGAAGAUCUGGAGGUCCUGUGUUCGAUCCACAGAAUUCGC",
    "ACGUNACGUAAAACGUUUUGCAUGCAUGC",
])
def test_bpp_predict_equals_the_original(sequence):
    from lara_tpu.solver import bpp_predict as jax_bpp
    from lara_tpu_torch.solver import bpp_predict

    assert bpp_predict.basepair_probabilities(sequence) == \
        jax_bpp.basepair_probabilities(sequence)


def test_native_baseline_equals_the_original():
    """The port's native build (its own sources, its own build directory)
    solves one pair as the JAX package's does."""
    from lara_tpu.io.records import RnaRecord as JaxRecord
    from lara_tpu.native import baseline as jax_baseline
    from lara_tpu.params import Parameters
    from lara_tpu_torch.io.records import RnaRecord
    from lara_tpu_torch.native import _LIB_DIR, NativeBuildError
    from lara_tpu_torch.native import baseline

    jax_native_or_skip()
    pair = [("a", "GGGAAAGGGAAACCCAAACCC", [(0, 20, 3.0), (6, 14, 2.0)]),
            ("b", "GGGAAAGGGAAACCCAAACC", [(0, 19, 3.0), (1, 18, 1.0)])]
    params = Parameters(in_file="<test>", num_iterations=40)
    want = jax_baseline.solve_pair(
        *(JaxRecord(name=n, sequence=s, fixed_edges=e)
          for n, s, e in pair), params, (0, 1))
    try:
        got = baseline.solve_pair(
            *(RnaRecord(name=n, sequence=s, fixed_edges=e)
              for n, s, e in pair), port_params(params), (0, 1))
    except NativeBuildError:
        pytest.skip("no C++ toolchain")
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert os.path.commonpath([_LIB_DIR, PORT]) == PORT
    assert os.path.exists(os.path.join(_LIB_DIR, "libbaseline.so"))


def test_jax_native_libraries_are_built():
    """Collecting this module left the JAX package's four native libraries
    up to date, and each loads."""
    import ctypes

    jax_native_or_skip()
    assert _stale_jax_libraries() == {}
    for name in JAX_LIBRARIES:
        ctypes.CDLL(os.path.join(JAX_NATIVE, "lib", f"lib{name}.so"))

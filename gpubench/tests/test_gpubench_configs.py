"""A configuration names the reference package that judges it and the
generator kind that makes its pool, and a new configuration that brings
its own of both runs with no edit to a file of the harness."""

import importlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import gpubench.tests
from gpubench import harness
from gpubench.tests.conftest import TINY_CONFIG, TINY_TRAFFIC
from gpubench.traffic import generate

REPO = Path(__file__).resolve().parents[2]
STUB = "gpubench/tests/stub_reference"
WORKLOADS = [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("reference, judged_wrong",
                         [("gpubench/reference", False), (STUB, True)])
def test_the_named_reference_judges(cpu, reference, judged_wrong):
    """The stub changes the score of each family's pair (0, 1): where the
    configuration names it, those pairs read as differing."""
    out = harness.rehearse("trna72.families15", 5, 1.0,
                           {**TINY_CONFIG, "reference": reference},
                           {**TINY_TRAFFIC, "check_pairs": 1000})
    checks = out["checks"]
    assert checks["pairs_compared"] == 3 * out["attempted"]
    assert (checks["pairs_differing"]["value"] > 0) == judged_wrong
    assert checks["pairs_differing"]["value"] == \
        (out["attempted"] if judged_wrong else 0)
    assert out["correct"] != judged_wrong


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_resolves_to_the_frozen_reference(workload):
    assert harness.load_cell(workload).reference == "gpubench.reference"


@pytest.mark.parametrize("path", ["benchmark/reference", "gpubench",
                                  "/gpubench/reference",
                                  "gpubench/../benchmark/reference",
                                  "gpubench/reference-m0"])
def test_a_reference_outside_the_harness_is_refused(path):
    with pytest.raises(ValueError, match="is not a package under gpubench/"):
        harness.reference_package(path)


@pytest.mark.parametrize("path", ["gpubench/no_such_reference",
                                  "gpubench/no_such/reference",
                                  "gpubench/harness"])
def test_a_reference_that_is_not_there_is_refused(path):
    with pytest.raises(ValueError, match="no package " +
                       path.replace("/", r"\.") + "$"):
        harness.reference_package(path)


def test_a_reference_without_a_writer_is_refused(tmp_path, monkeypatch):
    package = tmp_path / "half_reference"
    package.mkdir()
    for name in ("__init__", "driver", "params", "records", "control"):
        (package / f"{name}.py").write_text(
            "from gpubench.reference import *  # noqa\n")
    monkeypatch.setattr(gpubench.tests, "__path__",
                        [*gpubench.tests.__path__, str(tmp_path)])
    monkeypatch.delitem(sys.modules, "gpubench.tests.half_reference",
                        raising=False)
    importlib.invalidate_caches()
    with pytest.raises(ValueError, match="gpubench.tests.half_reference "
                                         "lacks writer$"):
        harness.reference_package("gpubench/tests/half_reference")
    sys.modules.pop("gpubench.tests.half_reference", None)


def test_a_generator_file_is_loaded_by_its_kind(tmp_path, monkeypatch):
    (tmp_path / "test_copies.py").write_text(
        "from gpubench.traffic import generate\n"
        "def make(n, generator, seed, workers):\n"
        "    return generate.make_family(n, generator['length'], seed,\n"
        "                                workers, 0.05)[::-1]\n")
    monkeypatch.setattr(generate, "GENERATORS", tmp_path)
    config = {"generator": {"kind": "test_copies", "length": 30}}
    try:
        pool = generate.make_pool(config, {"pool_size": 3}, 5)
    finally:
        sys.modules.pop("gpubench.traffic.generators.test_copies", None)
    want = generate.make_family(3, 30, 5)[::-1]
    assert [(r.name, r.sequence, r.bpp_edges) for r in pool] \
        == [(r.name, r.sequence, r.bpp_edges) for r in want]


@pytest.mark.parametrize("kind", ["no_such_kind", "../generate", "__init__"])
def test_an_unknown_generator_kind_raises(kind):
    with pytest.raises(ValueError, match="unknown generator kind"):
        generate.make_pool({"generator": {"kind": kind}}, {"pool_size": 3},
                           5)


_GENERATOR = '''"""A test's generator kind: tRNA copies, each read back
on a worker process by a function of this file."""

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

from gpubench.traffic import generate


def _length(record):
    return len(record.sequence)


def make(n, generator, seed, workers):
    records = generate.make_family(n, int(generator["length"]), seed,
                                   workers, 0.05)
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=1, mp_context=ctx) as pool:
        assert list(pool.map(_length, records)) == [len(r.sequence)
                                                    for r in records]
    return records
'''


def _digests(root):
    out = {}
    for path in root.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            out[path] = path.read_bytes()
    return out


def test_a_new_configuration_runs_without_edits(tmp_path):
    """A later configuration brings its own reference package and generator
    kind as new files, and a cell in BENCHMARK.json; no file that was
    there changes."""
    copy = tmp_path / "checkout"
    shutil.copytree(REPO / "gpubench", copy / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(copy / "gpubench")
    reference = copy / "gpubench" / "reference_copy"
    reference.mkdir()
    (reference / "__init__.py").write_text('"""A test\'s reference."""\n')
    for name in harness.REFERENCE_MODULES:
        (reference / f"{name}.py").write_text(
            f"from gpubench.reference.{name} import *  # noqa\n")
    (copy / "gpubench" / "traffic" / "generators" / "test_copies.py") \
        .write_text(_GENERATOR)
    config = json.loads((REPO / "gpubench" / "configs" / "trna72.json")
                        .read_text())
    config.update(name="trna30copy", reference="gpubench/reference_copy",
                  generator={"kind": "test_copies", "length": 30})
    (copy / "gpubench" / "configs" / "trna30copy.json").write_text(
        json.dumps(config))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "trna30copy", "source": "a test",
                             "file": "gpubench/configs/trna30copy.json",
                             "reduced": [], "why": "a test's configuration"})
    bench["workloads"].append({"name": "trna30copy.families15",
                               "config": "trna30copy",
                               "traffic": "families15", "chips": 1,
                               "why": "a test's cell"})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    script = ("import json, sys\n"
              "from gpubench import harness\n"
              "if __name__ == '__main__':\n"
              "    out = harness.rehearse('trna30copy.families15', 3, 0.5, "
              "config={'params': {'num_iterations': 10}}, "
              f"traffic={TINY_TRAFFIC!r})\n"
              "    print(json.dumps({'correct': out['correct'], "
              "'checks': out['checks'], 'modules': sorted(sys.modules)}))\n")
    env = dict(os.environ, PYTHONPATH=f"{copy}{os.pathsep}{REPO}",
               LARA_PLATFORM="cpu", OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", script], cwd=copy, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["checks"]["pairs_compared"] > 0
    assert {"gpubench.reference_copy.driver",
            "gpubench.traffic.generators.test_copies"} <= set(out["modules"])
    after = _digests(copy / "gpubench")
    assert {k: v for k, v in after.items() if k in before} == before

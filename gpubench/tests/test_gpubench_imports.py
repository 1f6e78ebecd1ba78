"""No run loads JAX or the JAX package, the reference loads nothing of the
program, and nothing reads the JAX package's benchmark folder."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BANNED = {"jax", "jaxlib", "flax", "lara_tpu"}

_REHEARSAL = r"""
import json, os, sys
opened = []
sys.addaudithook(lambda event, args: opened.append(str(args[0]))
                 if event == "open" and args and isinstance(args[0], str)
                 else None)
from gpubench import harness
if __name__ == "__main__":
    out = harness.rehearse(
        "trna72.families15", 11, 0.5,
        config={"generator": {"length": 30}, "params": {"num_iterations": 10}},
        traffic={"family_size": 3, "pool_size": 4, "warmup_jobs": 1,
                 "check_pairs": 3}, workers=2)
    print(json.dumps({"correct": out["correct"],
                      "modules": sorted(sys.modules),
                      "opened": opened}))
"""


def _run(code):
    env = dict(os.environ, PYTHONPATH=str(REPO), LARA_PLATFORM="cpu",
               OMP_NUM_THREADS="2")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_a_rehearsal_loads_no_jax_and_reads_no_jax_benchmark():
    out = _run(_REHEARSAL)
    assert out["correct"]
    tops = {m.split(".", 1)[0] for m in out["modules"]}
    assert not tops & BANNED, sorted(tops & BANNED)
    assert "lara_tpu_torch" in tops  # the whole top-level name is compared
    jax_bench = str(REPO / "benchmark") + os.sep
    assert not [p for p in out["opened"]
                if os.path.abspath(p).startswith(jax_bench)]


def _references():
    """Every ``reference`` that BENCHMARK.json's configurations name."""
    with open(REPO / "BENCHMARK.json") as handle:
        configs = json.load(handle)["configs"]
    names = set()
    for config in configs:
        with open(REPO / config["file"]) as handle:
            names.add(json.load(handle)["reference"])
    return sorted(names)


@pytest.mark.parametrize("reference", _references())
def test_the_reference_loads_nothing_of_the_program(reference):
    from gpubench import harness

    package = harness.reference_package(reference)
    code = ("import importlib, json, sys\n"
            f"for name in {harness.REFERENCE_MODULES!r}:\n"
            f"    importlib.import_module('{package}.' + name)\n"
            "import gpubench.check, gpubench.traffic.generate\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    modules = _run(code)
    assert f"{package}.driver" in modules
    tops = {m.split(".", 1)[0] for m in modules}
    assert not tops & (BANNED | {"lara_tpu_torch", "torch"})


def test_no_harness_source_names_the_jax_package():
    """Every import of the benchmark's sources, by its top-level name."""
    import ast

    for path in (REPO / "gpubench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".", 1)[0] not in BANNED, (path, name)

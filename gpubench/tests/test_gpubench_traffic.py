"""The frozen traffic generator: the same seed gives the same families, the
copies equal the port's ``workloads.py``, and a traffic mix is a data file
that the harness finds by name."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from gpubench.traffic import generate

REPO = Path(__file__).resolve().parents[2]


def _key(records):
    return [(r.name, r.sequence, r.bpp_edges) for r in records]


@pytest.mark.parametrize("seed", [7, 2**31 + 5])
def test_make_family_equals_the_port(seed):
    from lara_tpu_torch import workloads

    want = _key(workloads.make_family(3, length=40, seed=seed))
    assert _key(generate.make_family(3, 40, seed)) == want
    assert _key(generate.make_family(3, 40, seed, workers=2)) == want


@pytest.mark.parametrize("seed", [47, 9])
def test_make_long_family_equals_the_port(seed):
    from lara_tpu_torch import workloads

    want = _key(workloads.make_long_family(3, length=400, seed=seed))
    assert _key(generate.make_long_family(3, 400, seed)) == want


def test_the_scaffold_seed_fixes_the_molecule():
    one = generate.make_long_family(3, 400, seed=1, scaffold_seed=47)
    two = generate.make_long_family(3, 400, seed=2, scaffold_seed=47)
    assert one[0].sequence == two[0].sequence  # the scaffold itself
    assert _key(one) != _key(two)
    assert _key(one) == _key(generate.make_long_family(
        3, 400, seed=1, scaffold_seed=47))


@pytest.mark.parametrize("name", ["trna72", "ssu16s1530"])
def test_same_seed_same_jobs(name):
    with open(REPO / "gpubench" / "configs" / f"{name}.json") as handle:
        config = json.load(handle)
    config["generator"]["length"] = 40 if name == "trna72" else 300
    traffic = {"pool_size": 6, "family_size": 3}
    seed = -12345678901
    s_pool, s_jobs, _ = generate.seeds(seed, 3)
    assert generate.seeds(seed, 3) == [s_pool, s_jobs, _]
    pools = [_key(generate.make_pool(config, traffic, s_pool))
             for _ in range(2)]
    assert pools[0] == pools[1]
    jobs = [generate.families(6, 3, s_jobs) for _ in range(2)]
    firsts = [[next(j) for _ in range(5)] for j in jobs]
    assert firsts[0] == firsts[1]
    assert all(len(set(f)) == 3 for f in firsts[0])
    other = generate.families(6, 3, generate.seeds(seed + 1, 3)[1])
    assert [next(other) for _ in range(5)] != firsts[0]


#: sha256 of each cell's pool (names, sequences, edges with their floats'
#: hex), taken before a generator kind could come from a file of its own
POOL_DIGESTS = {
    ("trna72", "families15"):
        "f2371edc0ce345eef9be6e2ba1446fc12c6763cbde0f8cefb55380ac01807404",
    ("trna72", "families64"):
        "1c76f2bae5e9cc9f5934df5c581f10d3de8970ceede43b420018e80cbf600746",
    ("ssu16s1530", "families8"):
        "03db71d41b466914281f5558069f343de921a008fa1c9f91790ffcb21a9d574b",
    ("ssu16s1530", "pair"):
        "f2a669c58410d3fe14887f9be44f687fa5d55c2aa3bb77b42cb7570b1bd9bbbd",
}


@pytest.mark.parametrize("config, traffic", sorted(POOL_DIGESTS))
def test_the_pools_are_as_they_were(config, traffic):
    with open(REPO / "gpubench" / "configs" / f"{config}.json") as handle:
        cfg = json.load(handle)
    with open(REPO / "gpubench" / "traffic" / f"{traffic}.json") as handle:
        mix = json.load(handle)
    pool = generate.make_pool(cfg, mix, int(mix["pool_seed"]), workers=4)
    key = [[r.name, r.sequence, [[int(i), int(j), float(p).hex()]
                                 for i, j, p in r.bpp_edges]] for r in pool]
    assert len(pool) == mix["pool_size"]
    assert hashlib.sha256(json.dumps(key).encode()).hexdigest() \
        == POOL_DIGESTS[config, traffic]


def test_ebpseq_equals_the_port_writer(tmp_path):
    from lara_tpu_torch.io.writers import write_ebpseq

    records = generate.make_family(3, 40, 5)
    ours = tmp_path / "ours.ebpseq"
    generate.write_ebpseq(records, str(ours))
    with open(tmp_path / "theirs.ebpseq", "w") as handle:
        write_ebpseq(records, handle)
    assert ours.read_bytes() == (tmp_path / "theirs.ebpseq").read_bytes()


def _digests(root):
    out = {}
    for base, _dirs, files in os.walk(root):
        for f in files:
            if "__pycache__" not in base:
                path = os.path.join(base, f)
                with open(path, "rb") as handle:
                    out[path] = hashlib.sha256(handle.read()).hexdigest()
    return out


def test_a_new_traffic_file_runs_without_edits(tmp_path):
    """A later PR adds a traffic mix as a data file and a cell in
    BENCHMARK.json; the harness finds it by name, and no file that was
    there changes."""
    copy = tmp_path / "checkout"
    shutil.copytree(REPO / "gpubench", copy / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(copy / "gpubench")
    with open(REPO / "BENCHMARK.json") as handle:
        bench = json.load(handle)
    bench["workloads"].append({
        "name": "trna72.tiny3", "config": "trna72", "traffic": "tiny3",
        "chips": 1, "why": "a test's cell"})
    with open(copy / "BENCHMARK.json", "w") as handle:
        json.dump(bench, handle)
    with open(copy / "gpubench" / "traffic" / "tiny3.json", "w") as handle:
        json.dump({"name": "tiny3", "family_size": 3, "pool_size": 4,
                   "pool_seed": 3,
                   "warmup_jobs": 1, "check_pairs": 3, "reduced": [],
                   "assumed": [], "source": "a test"}, handle)
    script = ("import json, sys\n"
              "from gpubench import harness\n"
              "if __name__ == '__main__':\n"
              "    out = harness.rehearse('trna72.tiny3', 3, 0.5, "
              "config={'generator': {'length': 30}, "
              "'params': {'num_iterations': 10}})\n"
              "    print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=f"{copy}{os.pathsep}{REPO}",
               LARA_PLATFORM="cpu", OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", script], cwd=copy, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["checks"]["pairs_compared"] == 3
    after = _digests(copy / "gpubench")
    assert {k: v for k, v in after.items() if k in before} == before

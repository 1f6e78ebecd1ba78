"""One run of one benchmark cell: set-up, the measured window of family
jobs through ``lara_tpu_torch.app.run``, the output check, and the
result's line.

Everything that belongs to a cell is found by name: the cell in
``BENCHMARK.json``, its configuration in the file that entry names, the
reference that judges it in the package the configuration's ``reference``
names, its pool's generator by the configuration's ``generator.kind``
(:func:`gpubench.traffic.generate.make_pool`), its traffic mix in
``gpubench/traffic/<traffic>.json``, and each per-layer metric's reader in
``gpubench/metrics/<metric>.py``.  Adding a configuration, a traffic mix
or a metric adds files and entries; no file of the harness changes.

The traffic is a closed loop with one client.  Set-up makes the traffic's
pool of records from its ``pool_seed`` (:mod:`gpubench.traffic.generate`),
the same for every run, and runs the traffic's warm-up jobs, which build
and load the program's kernels and native libraries and warm the cell's
shapes.  The window then runs family jobs one after the other, drawn from
the pool by the run's seed: each writes a family's input file, calls
``app.run`` on it, and is done when ``app.run`` has written the library.
Jobs start until ``seconds`` have passed; the one running then finishes,
and the window's wall ends with it.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import resource
import shutil
import statistics
import sys
import tempfile
import time
import traceback
from pathlib import Path, PurePosixPath
from typing import List, NamedTuple, Optional

HERE = Path(__file__).resolve().parent
#: module names that no run may load, compared by their top-level name
BANNED = ("jax", "jaxlib", "flax", "lara_tpu")
#: the longest traced window: under the profiler a tRNA window of 50 s
#: ended in an illegal memory access inside a dispatch on three runs of
#: three, at ~35 s (~230 family jobs, each a new graph capture), while
#: windows of 25 and 40 s, and every untraced run, ran through
TRACED_SECONDS = 20.0
#: the end-to-end metric that needs CUDA events around the untraced
#: window's dispatches (:class:`gpubench.trace.ReplayClock`)
CARD_METRIC = "solve_card_us_per_alignment"
#: the modules a configuration's reference package has to hold
REFERENCE_MODULES = ("driver", "params", "records", "writer", "control")


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list   # the BENCHMARK.json entries this cell reports
    per_layer: list
    reference: str     # the dotted package of the configuration's reference


class JobStat(NamedTuple):
    wall_s: float
    pairs: int
    phases: dict       # the program's phase seconds in the job


class Window(NamedTuple):
    """What the per-layer readers read."""

    cell: Cell
    wall_s: float
    jobs: List[JobStat]
    iterations: int    # settled batch iterations (K3 launches)
    trace: object      # gpubench.trace.Summary


def reference_package(path: str) -> str:
    """The package that a configuration's ``reference`` names, as a dotted
    name: ``"gpubench/reference"`` is ``gpubench.reference``.  A path
    outside ``gpubench/``, or a package that lacks one of
    :data:`REFERENCE_MODULES`, is refused."""
    parts = PurePosixPath(path).parts
    if len(parts) < 2 or parts[0] != HERE.name \
            or not all(p.isidentifier() for p in parts):
        raise ValueError(f"reference {path!r} is not a package under "
                         f"{HERE.name}/")
    package = ".".join(parts)
    try:
        spec = importlib.util.find_spec(package)
    except ModuleNotFoundError:
        spec = None
    if spec is None or spec.submodule_search_locations is None:
        raise ValueError(f"reference {path!r}: no package {package}")
    missing = [m for m in REFERENCE_MODULES
               if importlib.util.find_spec(f"{package}.{m}") is None]
    if missing:
        raise ValueError(f"reference {path!r}: package {package} lacks "
                         f"{', '.join(missing)}")
    return package


def load_cell(workload: str, root: Path = HERE.parent) -> Cell:
    """The cell ``workload`` of ``root``'s ``BENCHMARK.json``."""
    with open(root / "BENCHMARK.json", encoding="utf-8") as handle:
        bench = json.load(handle)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    cell = cells[workload]
    files = {c["name"]: c["file"] for c in bench["configs"]}
    with open(root / files[cell["config"]], encoding="utf-8") as handle:
        config = json.load(handle)
    with open(HERE / "traffic" / f"{cell['traffic']}.json",
              encoding="utf-8") as handle:
        traffic = json.load(handle)

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads",
                                                        [workload])]

    return Cell(workload, int(cell["chips"]), config, traffic,
                mine(bench["end_to_end"]), mine(bench["per_layer"]),
                reference_package(config["reference"]))


def read_metric(name: str, window: Window) -> Optional[float]:
    """The reader ``gpubench/metrics/<name>.py``'s ``read(window)``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(window)


def banned_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(BANNED))


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t0: float, workers: int = 0, control: bool = False) -> dict:
    """One run of ``cell`` on ``device``: the result's object, whose
    ``checks`` come last.  ``t0`` is the ``time.monotonic()`` at which the
    process started its set-up.  With ``control`` the checks also judge the
    control in the program's place (:mod:`gpubench.control`)."""
    import torch

    from gpubench import check
    from gpubench.traffic import generate
    from lara_tpu_torch import _build, app
    from lara_tpu_torch.params import Parameters
    from lara_tpu_torch.utils import timing

    cuda = device.type == "cuda"
    workers = workers or check.default_workers()
    if trace:
        seconds = min(seconds, TRACED_SECONDS)
    s_jobs, s_sample = generate.seeds(seed, 2)
    traffic = cell.traffic
    workdir = tempfile.mkdtemp(prefix="gpubench-")
    try:
        # the pool is the traffic's own, the same for every seed, so that a
        # seed changes which families run and in what order, not how much
        # work they hold
        pool = generate.make_pool(cell.config, traffic,
                                  int(traffic["pool_seed"]), workers)
        families = generate.families(len(pool), int(traffic["family_size"]),
                                     s_jobs)
        span = torch.profiler.record_function if trace else _no_span

        def job(label, family):
            in_file = os.path.join(workdir, f"{label}.ebpseq")
            out_file = os.path.join(workdir, f"{label}.lib")
            with span("gpubench.write_input"):
                generate.write_ebpseq([pool[k] for k in family], in_file)
            params = Parameters(in_file=in_file, out_file=out_file,
                                **cell.config["params"])
            with span("gpubench.job"):
                start = time.perf_counter()
                result = app.run(params, device)
                end = time.perf_counter()
            return check.Job(in_file, out_file, len(family),
                             result.results), start, end

        for k in range(int(traffic["warmup_jobs"])):
            job(f"warmup{k}", next(families))
        if cuda:
            torch.cuda.synchronize(device)
        _build.settle()
        _build.reset_launches()

        tracer = clock = None
        if trace:
            from gpubench.trace import Tracer

            tracer = Tracer(device)
        elif cuda and any(m["name"] == CARD_METRIC for m in cell.end_to_end):
            from gpubench.trace import ReplayClock

            clock = ReplayClock(device)
        jobs, stats = [], []
        failed, end = 0, None
        gc.freeze()
        with tracer or clock or contextlib.nullcontext():
            setup_s = time.monotonic() - t0
            usage = resource.getrusage(resource.RUSAGE_SELF)
            start = time.perf_counter()
            deadline = start + seconds
            while time.perf_counter() < deadline:
                family = next(families)
                try:
                    done, began, end = job(f"job{len(jobs)}", family)
                except Exception:  # a failed job ends the window
                    failed += 1
                    traceback.print_exc()
                    break
                jobs.append(done)
                stats.append(JobStat(end - began, len(done.results),
                                     timing.snapshot()))
                # what the harness keeps of a job is no work of the next
                # job's garbage collections
                gc.freeze()
        wall_s = (end if end is not None else time.perf_counter()) - start
        used = resource.getrusage(resource.RUSAGE_SELF)
        gc.unfreeze()
        peak = 0
        if cuda:
            torch.cuda.synchronize(device)
            peak = torch.cuda.max_memory_allocated(device)
        _build.settle()
        iterations = _build.launches["matching_rounds"]
        card_s = clock.seconds() if clock is not None else None
        summary = tracer.summary() if tracer is not None else None

        found = banned_modules()
        if found:
            raise RuntimeError(f"modules loaded that no run may load: "
                               f"{found}")
        if cuda:
            torch.cuda.empty_cache()
        checked = time.monotonic()
        numbers = check.check(jobs, failed, cell.config,
                              int(traffic["check_pairs"]), s_sample, workers,
                              cell.reference, control)
        check_s = time.monotonic() - checked
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    window = Window(cell, wall_s, stats, iterations, summary)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = read_metric(m["name"], window)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    pairs = sum(s.pairs for s in stats)
    rate = pairs / wall_s if stats else 0.0
    tail = p95([s.wall_s * 1e3 for s in stats])
    if not trace:
        e2e = {
            "alignments_per_s": rate,
            "family_p95_ms": tail,
            "setup_s": setup_s,
            CARD_METRIC: 1e6 * card_s / pairs
            if card_s and pairs else None,
        }
        for m in cell.end_to_end:
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    out = {
        "correct": check.passed(numbers),
        "attempted": len(jobs) + failed,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
    }
    if summary is not None:
        out["device"]["busy_s"] = summary.busy_s
        out["device"]["window_s"] = summary.window_s
        out["breakdown"] = {"device_ops": summary.device_ops,
                            "idle_gaps": summary.idle_gaps}
        out["trace"] = {
            "coverage": summary.coverage, "placed": summary.placed,
            "replay_s": summary.replay_s, "kernel_n": summary.kernel_n,
            "k1_calls": summary.k1.calls, "k3_calls": summary.k3.calls,
            "sm_clock_mhz": summary.clocks_mhz,
            "power_limit_w": summary.power_limit_w}
    out["phases_s"] = {"setup": setup_s, "window": wall_s, "check": check_s}
    walls = sorted(st.wall_s for st in stats)
    phases = {}
    for st in stats:
        for name, sec in st.phases.items():
            phases[name] = phases.get(name, 0.0) + sec
    out["window"] = {
        "jobs": len(stats),
        "alignments_per_s": rate,
        "family_p95_ms": tail,
        "job_ms": [1e3 * walls[k * (len(walls) - 1) // 4] for k in range(5)]
        if walls else [],
        "program_phases_s": phases,
        "cpu_s": (used.ru_utime + used.ru_stime)
        - (usage.ru_utime + usage.ru_stime),
        "involuntary_switches": used.ru_nivcsw - usage.ru_nivcsw}
    out["checks"] = numbers
    return out


def p95(values: List[float]) -> Optional[float]:
    """The 95th percentile (``statistics.quantiles``, inclusive)."""
    if not values:
        return None
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[94]


@contextlib.contextmanager
def _no_span(_name):
    yield


def report(out: dict) -> None:
    """Each number compared beside its limit, as the last lines on standard
    error, then the result's line as the last line on standard output."""
    for name, v in out["checks"].items():
        if isinstance(v, dict):
            print(f"check {name}: {v['value']} (limit {v['limit']})",
                  file=sys.stderr)
        else:
            print(f"check {name}: {v}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


def main(argv, t0: float) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="Run one cell of the benchmark once on the card.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    os.environ.pop("LARA_PLATFORM", None)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    try:
        out = run(cell, args.seed, args.seconds, bool(args.trace), device,
                  t0)
    finally:
        _stop_resource_tracker()
    report(out)
    return 0


def _stop_resource_tracker() -> None:
    """Stop, and wait for, the process that ``multiprocessing`` starts
    beside the spawned pools, so that none outlives the run."""
    from multiprocessing import resource_tracker

    resource_tracker._resource_tracker._stop()


def rehearse(workload: str, seed: int, seconds: float,
             config: dict = None, traffic: dict = None, root: Path = None,
             workers: int = 1) -> dict:
    """A run of ``workload`` on the CPU with the kernels' plain versions,
    for the tests: ``config`` and ``traffic`` entries replace the cell's
    (``config["params"]`` entries replace single parameters), so that a
    run fits a test.  It skips the look for a card, prints nothing, and
    is never a measurement."""
    import torch

    os.environ["LARA_PLATFORM"] = "cpu"
    cell = load_cell(workload, root or HERE.parent)
    cfg = dict(cell.config)
    for key, value in (config or {}).items():
        if key == "params":
            cfg["params"] = {**cfg["params"], **value}
        elif key == "generator":
            cfg["generator"] = {**cfg["generator"], **value}
        else:
            cfg[key] = value
    cell = cell._replace(config=cfg,
                         traffic={**cell.traffic, **(traffic or {})},
                         reference=reference_package(cfg["reference"]))
    return run(cell, seed, seconds, False, torch.device("cpu"),
               time.monotonic(), workers)

"""One run of one benchmark cell (see run.py).

The cell's configuration, traffic and metrics are found by the names in
BENCHMARK.json: ``configs/<config>.json`` (sizes and settings, and under
``reference`` the module of ``reference/`` that builds its mesh),
``traffic/<traffic>.json`` (read by loadgen.py; its ``request`` names the
module of ``requests/`` that serves and judges a request),
``metrics/<metric>.py`` (a ``read(ctx)`` each) and ``limits/<cell>.json``
(the limit of each number the check compares).  A run sets up the system,
warms up every shape of the traffic, measures a window of ``--seconds``,
and then, with the program's state freed, holds a sample of the window's
answers against the plain reference (reference/).  The last line of
standard output is the result; the last lines of standard error are the
numbers compared, each beside its limit.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# modules that must not be loaded in a run's process, by top-level name
BANNED = ("jax", "jaxlib", "flax", "mfmg_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_reader(name: str):
    """``read`` of metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    mod_name = "portbench_metric_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def n_refinements(cfg: dict, dry: bool) -> int:
    """The refinements a run makes: the configuration's, or its rehearsal's."""
    return cfg["dry"]["n_refinements"] if dry else cfg["laplace"]["n_refinements"]


class Cell:
    """A workload of BENCHMARK.json with its configuration, traffic, limits
    and metrics, resolved by name."""

    def __init__(self, spec: dict, name: str):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
        self.name = name
        self.workload = cells[name]
        entry = {c["name"]: c for c in spec["configs"]}[self.workload["config"]]
        self.config = load_json(ROOT / entry["file"])
        self.traffic = load_json(HERE / "traffic" / f"{self.workload['traffic']}.json")
        self.request = importlib.import_module(
            f"portbench.requests.{self.traffic['request']}")
        self.limits = load_json(HERE / "limits" / f"{name}.json")
        self.end_to_end = [m for m in spec["end_to_end"] if applies(m, name)]
        self.per_layer = [m for m in spec["per_layer"] if applies(m, name)]


class Context:
    """What a metric's ``read`` may look at: the cell, the system, the input
    pool, the request (``serve``), the window, the set-up seconds, and
    (traced runs) profiles of the traffic, made once and shared."""

    def __init__(self, cell, system, pool, serve, window, setup_s, n_ref):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.system = system
        self.pool = pool
        self.serve = serve
        self.window = window
        self.setup_s = setup_s
        self.cuda = system.device.type == "cuda"
        self.n_refinements = n_ref
        self.notes = {}
        self._traced = {}

    def traced(self, host: bool = False):
        """A profiled stretch of ``trace_requests`` requests of the traffic
        (trace.Profile), made once: without the host's operations for the
        busy time and the device's operations, with them (``host``) for the
        names of the idle gaps.  None without a card."""
        if not self.cuda:
            return None
        if host not in self._traced:
            from portbench.trace import profile
            pool, k = self.pool, [0]

            def one():
                self.serve(pool[k[0] % pool.shape[0]])
                k[0] += 1
            self._traced[host] = profile(one, self.traffic["trace_requests"],
                                         host=host)
        return self._traced[host]


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def kept_for_check(system, window, inputs: dict) -> dict:
    """What the check needs of a run, copied out of the program's state: its
    dofs' coordinates and Dirichlet flags, and the kept answers with the
    rows of every input they answer, as (k, n) tensors, and their pool
    rows' indices (``index``)."""
    nodes, _, constrained = system.mesh()
    idx = [j for _, j, _ in window.sample]
    kept = {key: rows[idx] for key, rows in inputs.items()}
    kept.update(nodes=nodes, constrained=constrained, index=torch.tensor(idx),
                answers=torch.stack([out for _, _, out in window.sample]))
    return kept


def check_answers(cell, kept: dict, n_ref: int, device, problem=None) -> dict:
    """The reference's readings of the program's mesh and of the kept
    answers, run once the program's state is freed; ``problem``, where one
    is given, is the reference's problem already built for this mesh."""
    from portbench.reference.fem import Problem
    if problem is None:
        problem = Problem(cell.config, n_ref, kept["nodes"],
                          kept["constrained"], device)
    readings = dict(problem.readings)
    readings.update(cell.request.judge(problem, kept))
    return readings


def reference_problem(cell, system, n_ref: int):
    """problem(store) -> the reference's problem on the system's mesh, for
    inputs that need it in set-up."""
    from portbench.reference.fem import Problem
    nodes, _, constrained = system.mesh()
    return lambda store=True: Problem(cell.config, n_ref, nodes, constrained,
                                      system.device, store=store)


def set_up(cell, device, n_ref: int, seed: int):
    """(system, inputs, serve): the program built, the inputs made from
    ``seed``, and the request, warmed up on every shape of the traffic."""
    from portbench.system import System
    system = System(cell.config, device, n_ref)
    print(f"levels {system.levels}; problem {system.problem_s:.3f} s, "
          f"hierarchy {system.hierarchy_s:.3f} s", flush=True)
    inputs = cell.request.inputs(cell.traffic, system, seed,
                                 reference_problem(cell, system, n_ref))
    serve = cell.request.serve(system, cell.config, cell.traffic)
    pool = inputs["pool"]
    for j in range(cell.traffic["warmup"]):
        serve(pool[j % pool.shape[0]])
    system.synchronize()
    return system, inputs, serve


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--dry", action="store_true",
                    help="rehearsal on the CPU at the configuration's small "
                         "size; prints no device metric")
    args = ap.parse_args(argv)

    spec = load_json(ROOT / "BENCHMARK.json")
    cell = Cell(spec, args.workload)
    chips = cell.workload["chips"]
    if args.dry:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"needs {chips} CUDA device(s); torch.cuda.is_available() = "
                  f"{torch.cuda.is_available()}, device_count = "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
        print(f"card: {card_line()}; torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}", flush=True)

    from portbench.loadgen import check_traffic, percentile, run
    check_traffic(cell.traffic)
    n_ref = n_refinements(cell.config, args.dry)
    system, inputs, serve = set_up(cell, device, n_ref, args.seed)
    setup_s = time.perf_counter() - t_start

    pool = inputs["pool"]
    window = run(cell.traffic, serve, pool, args.seconds, args.seed)
    counters = window.counters
    print(f"window: {window.completed} requests in {window.seconds:.4f} s; "
          f"{cell.request.summary(counters)}", flush=True)
    q = [percentile(window.latencies, v) * 1e3 for v in (50, 90, 95, 99, 100)]
    print("request ms: median {:.4f} p90 {:.4f} p95 {:.4f} p99 {:.4f} "
          "max {:.4f}".format(*q), flush=True)
    failed = sum(1 for c in counters if not c["ok"])

    ctx = Context(cell, system, pool, serve, window, setup_s, n_ref)
    metrics, extra = {}, {}
    wanted = cell.per_layer if args.trace else cell.end_to_end
    for m in wanted:
        value = load_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if ctx.notes:
        print(f"bounds: {ctx.notes}", flush=True)

    result_device = {"platform": "cpu" if args.dry else "gpu",
                     "kind": "dry rehearsal" if args.dry
                     else torch.cuda.get_device_name(0),
                     "count": chips}
    if device.type == "cuda":
        torch.cuda.synchronize()
        result_device["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
    else:
        result_device["memory_peak_bytes"] = 0
    if args.trace:
        p = ctx.traced()
        if p is not None:
            result_device["busy_s"] = p.busy_s
            result_device["window_s"] = p.wall_s
            extra["breakdown"] = {"device_ops": p.device_ops(),
                                  "idle_gaps": ctx.traced(host=True).idle_gaps()}
    kept = kept_for_check(system, window, inputs)
    ctx = system = window = pool = inputs = serve = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = check_answers(cell, kept, n_ref, device)
    from portbench.reference.judge import decide
    correct, compared = decide(readings, cell.limits)

    found = banned_modules()
    if found:
        print(f"loaded in this process: {found}", file=sys.stderr)
        return 4
    result = {"correct": correct, "attempted": len(counters), "failed": failed}
    if args.dry:
        result.update(metrics={}, rehearsal=metrics, dry=True)
    else:
        result["metrics"] = metrics
    result["device"] = result_device
    result.update(extra)
    result["compared"] = {k: {n: (v if math.isfinite(v) else None)
                              for n, v in c.items()}
                          for k, c in compared.items()}
    for name, c in compared.items():
        print(f"compared {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0

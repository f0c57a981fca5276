"""Run one cell of ``BENCHMARK.json`` once and print its result line.

The harness is driven by data. The cell names a configuration and a
traffic mix; their files (``configs/<config>.json``,
``traffic/<traffic>.json``) say what to run, and the traffic's ``entry``
picks how the cell runs: ``run`` (``engine.run``, one caller) or
``serve`` (``SolveServer``). Each metric is read by its own file,
``metrics/<name>.py``, whose ``read(ctx)`` returns a number or None; the
metrics printed are the cell's end-to-end ones with ``--trace 0`` and
its per-layer ones with ``--trace 1``.

The last line on standard output is one JSON object. Every number the
comparison with the reference judged is printed beside its limit as the
last lines on standard error, and under ``checks``, the line's last key.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
#: The fixed directory every build and kernel cache of a run lives in.
CACHE = BENCH / "_build"


@dataclasses.dataclass
class Run:
    """One run of one cell."""

    cell: str
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object            # torch.device
    t_start: float
    control: bool = False


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(bench: dict, name: str) -> tuple[dict, dict]:
    """The cell ``name`` and its configuration entry."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r}; the cells are {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return cell, configs[cell["config"]]


def load_config(entry: dict, root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / entry["file"]).read_text())


def load_traffic(name: str, root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "bench" / "traffic" / f"{name}.json")
                      .read_text())


def reader(name: str, root: pathlib.Path = ROOT):
    """The ``read(ctx)`` of ``metrics/<name>.py``."""
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _in(entry: dict, cell: str) -> bool | None:
    ws = entry.get("workloads")
    return None if ws is None else cell in ws


def metrics_for(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` prints: the end-to-end ones listed
    for it (or for every cell), or with ``trace`` the per-layer ones
    listed for it, or, without a list, those whose ``moves`` it reports."""
    e2e = [m for m in bench["end_to_end"] if _in(m, cell) is not False]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if _in(m, cell) or (_in(m, cell) is None
                                and m["moves"] in reported)]


def set_caches(env=os.environ) -> None:
    """Every build and kernel cache of the port in :data:`CACHE`."""
    env["REPRO_TORCH_BUILD_DIR"] = str(CACHE / "kernels")
    env["REPRO_TORCH_TUNE_CACHE"] = str(CACHE / "engine_tune.json")
    env["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    env["TRITON_CACHE_DIR"] = str(CACHE / "triton")


def drive(run: Run) -> dict:
    """Run the cell the way its traffic's ``entry`` names."""
    from bench import cells
    by_entry = {"run": cells.run_fixed, "serve": cells.run_served}
    return by_entry[run.traffic["entry"]](run)


def card_state(device) -> str | None:
    """The card's name, power limit, SM clock (now and its most),
    temperature and power draw, from ``nvidia-smi``, once the window
    has closed."""
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu,power.draw",
             "--format=csv,noheader", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return got.stdout.strip() or None


def result_line(bench: dict, run: Run, out: dict, chips: int) -> dict:
    """The JSON object a run prints last."""
    ctx = out["ctx"]
    metrics = {}
    for m in metrics_for(bench, run.cell, run.trace):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if run.device.type == "cuda" else
              run.device.type,
              "kind": out["device_kind"], "count": chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    if run.trace:
        device["busy_s"] = ctx["busy_s"]
        device["window_s"] = ctx["trace_window_s"]
    device["card"] = out.get("card")
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if run.trace and out.get("breakdown"):
        line["breakdown"] = out["breakdown"]
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in out["checks"]}
    return line


def note(t_start: float, what: str) -> None:
    """A line on standard error: seconds since the process started."""
    import time
    print(f"[bench] {time.perf_counter() - t_start:.3f} s: {what}",
          file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="put the low-precision reference in the program's "
                        "place (must come out not correct)")
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    set_caches()
    bench = load_benchmark()
    cell, cfg_entry = find_cell(bench, args.workload)
    cfg = load_config(cfg_entry)
    traffic = load_traffic(cell["traffic"])
    import torch
    note(t_start, "torch imported")
    # One process with few threads: the host's cores go to launching.
    torch.set_num_threads(1)
    chips = cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell {args.workload} needs {chips} card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count()={torch.cuda.device_count()}", file=sys.stderr)
        return 3
    note(t_start, "CUDA driver ready")
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"the port is not in this checkout ({e})", file=sys.stderr)
        return 4
    note(t_start, "the port imported")
    torch.zeros(1, device="cuda")
    note(t_start, "CUDA context made")
    run = Run(cell=args.workload, cfg=cfg, traffic=traffic, seed=args.seed,
              seconds=args.seconds, trace=bool(args.trace),
              device=torch.device("cuda", 0), t_start=t_start,
              control=args.control)
    out = drive(run)
    out["card"] = card_state(run.device)
    return report(bench, run, out, chips)


def report(bench: dict, run: Run, out: dict, chips: int) -> int:
    """Check the process for JAX, then print the checks and the line."""
    from bench import checks
    found = checks.forbidden_modules() + out.get("forbidden", [])
    if found:
        print(f"loaded in the run: {sorted(set(found))} (the port must run "
              f"without JAX and the JAX package)", file=sys.stderr)
        return 5
    line = result_line(bench, run, out, chips)
    for c in out["checks"]:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0

"""Run cells of the benchmark several times, one process a run, and sum
up what they printed: each metric's median and spread (the distance
between its quartiles over its median), ``setup_s`` of every run, and
every check.

    python3 bench/series.py --out series.jsonl \\
        --seconds 20 jacobi-bf16.fixed:1,2,3 jacobi-f32.fixed:4,5:trace

Each argument is ``cell:seed,seed,...`` with ``:trace`` for ``--trace
1`` and ``:control`` for the control; the runs go in the order given.
The card's name and power limit come first. Each run's result line (or
the end of its error output) is appended to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def one(cell: str, seed: int, seconds: float, trace: bool,
        control: bool) -> dict:
    cmd = [sys.executable, "bench/run.py", "--workload", cell, "--seed",
           str(seed), "--seconds", str(seconds), "--trace", str(int(trace))]
    if control:
        cmd.append("--control")
    t0 = time.perf_counter()
    got = subprocess.run(cmd, capture_output=True, text=True)
    rec = {"cell": cell, "seed": seed, "trace": trace, "control": control,
           "rc": got.returncode, "wall_s": time.perf_counter() - t0}
    lines = got.stdout.strip().splitlines()
    rec["stderr"] = got.stderr[-3000:]
    try:
        rec["line"] = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        pass
    return rec


def summary(recs: list[dict]) -> None:
    by: dict = {}
    for r in recs:
        if "line" in r:
            key = (r["cell"], r["trace"], r["control"])
            by.setdefault(key, []).append(r)
    for (cell, trace, control), rs in by.items():
        names = rs[0]["line"]["metrics"]
        print(f"== {cell} trace={int(trace)} control={int(control)}: "
              f"{len(rs)} runs, correct {[r['line']['correct'] for r in rs]}")
        for name in names:
            vals = [r["line"]["metrics"][name]["value"] for r in rs
                    if name in r["line"]["metrics"]]
            med = statistics.median(vals)
            spr = ((lambda q: (q[2] - q[0]) / q[1])(
                statistics.quantiles(vals, n=4)) if len(vals) >= 2 else 0.0)
            print(f"  {name}: median {med!r} spread {spr:.5f} "
                  f"values {vals}")
        worst: dict = {}
        for r in rs:
            for k, c in r["line"].get("checks", {}).items():
                worst.setdefault(k, []).append(c["value"])
        for k, v in worst.items():
            print(f"  check {k}: min {min(v)!r} max {max(v)!r}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True)
    p.add_argument("--seconds", type=float, default=20)
    p.add_argument("runs", nargs="+")
    a = p.parse_args(argv)
    print(card(), flush=True)
    recs = []
    for spec in a.runs:
        cell, seeds, *flags = spec.split(":")
        for seed in seeds.split(","):
            r = one(cell, int(seed), a.seconds, "trace" in flags,
                    "control" in flags)
            recs.append(r)
            with open(a.out, "a") as f:
                f.write(json.dumps(r) + "\n")
            line = r.get("line", {})
            print(f"{cell} seed={seed} rc={r['rc']} wall={r['wall_s']:.1f}s "
                  f"correct={line.get('correct')} "
                  f"{json.dumps(line.get('metrics'))} "
                  f"checks={json.dumps(line.get('checks'))}"
                  + ("" if line else f"\n{r.get('stderr', '')[-1500:]}"),
                  flush=True)
    summary(recs)
    return 0


if __name__ == "__main__":
    sys.exit(main())

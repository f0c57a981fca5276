"""CI gate: ``python -m repro_torch.analysis`` verifies every registry lowering.

Sweeps registry policies x specs x dtypes x devices x fusion depths x
masked/overlap, statically verifies each lowering plus its schedule, and
exits nonzero if any cell produces an error-severity diagnostic. The
default lane covers the two paper-relevant devices at float32; ``--all``
widens to every registered device and both dtypes.

    PYTHONPATH=src python -m repro_torch.analysis --all
    PYTHONPATH=src python -m repro_torch.analysis --device grayskull_e150 -v
"""
from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="statically verify every registry lowering + schedule")
    ap.add_argument("--all", action="store_true",
                    help="sweep every registered device and both dtypes")
    ap.add_argument("--device", action="append", default=None,
                    help="restrict to a device (repeatable)")
    ap.add_argument("--policy", action="append", default=None,
                    help="restrict to a policy (repeatable)")
    ap.add_argument("--spec", action="append", default=None,
                    help="restrict to a spec (repeatable)")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print every cell, not just failures")
    args = ap.parse_args(argv)

    from repro_torch.analysis.sweep import run_sweep
    cells = run_sweep(policies=args.policy, specs=args.spec,
                      devices=args.device, full=args.all)

    n = {"verified": 0, "infeasible": 0, "error": 0}
    for cell in cells:
        n[cell.outcome] += 1
        if args.verbose or cell.outcome == "error":
            print(cell.describe())
        if cell.outcome == "error" and cell.report is not None:
            for line in cell.report.describe().splitlines():
                print(f"    {line}")
    print(f"repro_torch.analysis: {len(cells)} cells — {n['verified']} verified, "
          f"{n['infeasible']} infeasible (planner/budget refusals), "
          f"{n['error']} error(s)")
    if args.all:
        # Per-cell timing summary, sourced from the obs metrics registry
        # (run_sweep observes every cell's wall time into a histogram).
        from repro_torch.obs import metrics
        hist = metrics.snapshot()["histograms"].get("analysis.cell_seconds")
        if hist and hist["count"]:
            print(f"cell timing: n={hist['count']} "
                  f"total={hist['sum']:.2f}s mean={hist['mean'] * 1e3:.1f}ms "
                  f"p50={hist['p50'] * 1e3:.1f}ms "
                  f"p95={hist['p95'] * 1e3:.1f}ms "
                  f"p99={hist['p99'] * 1e3:.1f}ms "
                  f"max={hist['max'] * 1e3:.1f}ms")
            for cell in sorted(cells, key=lambda c: -c.seconds)[:5]:
                print(f"  slowest {cell.seconds * 1e3:8.1f}ms  {cell.tag}")
    return 1 if n["error"] else 0


if __name__ == "__main__":
    raise SystemExit(main())

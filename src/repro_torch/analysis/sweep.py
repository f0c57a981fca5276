"""The verify-sweep: statically prove every registry lowering.

Enumerates the cross-product of registry policies x specs x dtypes x
devices x fusion depths x masked/overlap cells, lowers each combination
that plans, and runs the full static verifier plus the schedule
feasibility checks over it. One :class:`Cell` per combination records the
outcome:

* ``verified``   — lowered and proven clean (the only passing outcome);
* ``infeasible`` — the planner or the budget gates rejected the cell
  *with a diagnostic* (expected: e.g. a t=8 temporal window on the
  e150's 1.5 MiB SRAM) — not a verifier failure;
* ``error``      — a lowering was produced and the verifier rejected it,
  or a feasibility check found an error: the CI gate fails.

``python -m repro_torch.analysis`` drives this and exits nonzero on any
``error`` cell, which makes "codegen never emits a program that can
deadlock or overflow" a CI property rather than a hope.

All heavy imports are deferred so ``repro_torch.analysis`` stays importable
without dragging the backends in (and without import cycles: the
backends' ``lower`` itself calls back into :mod:`repro_torch.analysis.verify`).

The port's copy of ``repro.analysis.sweep``. Its cells on ``tpu_v5e``,
``grayskull_e150`` and ``cpu_ref`` equal the reference's; on
``gpu_sm90`` the port plans 2-D tiles, which lower only where a tile
spans the interior's width (``backends.lower``), so some of those cells
differ from the reference's (ROADMAP Queue 3).
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch.analysis.diagnostics import Report
from repro_torch.obs import metrics as _metrics

#: Default sweep axes. ``--all`` uses every registered device and both
#: dtypes; the default lane keeps the two paper-relevant chips.
SWEEP_SPECS = ("jacobi5", "laplace9", "advection3")
SWEEP_DTYPES = ("float32", "bfloat16")
SWEEP_T = (1, 3, 8)
SWEEP_SHAPE = (66, 130)
SWEEP_MESH = (4,)


def _specs():
    from repro_torch.core.stencil import (advection_2d_3pt, jacobi_2d_5pt,
                                    laplace_2d_9pt)
    return {"jacobi5": jacobi_2d_5pt(), "laplace9": laplace_2d_9pt(),
            "advection3": advection_2d_3pt()}


@dataclasses.dataclass(frozen=True)
class Cell:
    """One verified combination of the sweep cross-product."""

    policy: str
    spec: str
    dtype: str
    device: str
    t: int
    masked: bool
    overlap: bool
    outcome: str          # "verified" | "infeasible" | "error"
    detail: str
    report: Report | None = None
    seconds: float = 0.0  # wall time spent verifying this cell

    @property
    def tag(self) -> str:
        return (f"{self.policy}/{self.spec}/{self.dtype}/{self.device}"
                f"/t{self.t}{'/masked' if self.masked else ''}"
                f"{'/overlap' if self.overlap else ''}")

    def describe(self) -> str:
        return f"{self.outcome:10s} {self.tag:60s} {self.detail}"


def _verify_cell(policy: str, spec_name: str, spec, dtype: str,
                 device: str, t: int, masked: bool, overlap: bool,
                 shape) -> Cell:
    from repro_torch.analysis.feasibility import check_schedule
    from repro_torch.analysis.verify import verify_program
    from repro_torch.backends.lower import LoweringError, lower_plan
    from repro_torch.engine.plan import PlanError, plan_for
    from repro_torch.engine.schedule import build_schedule

    def cell(outcome, detail, report=None):
        return Cell(policy, spec_name, dtype, device, t, masked, overlap,
                    outcome, detail, report)

    fused = policy == "temporal"
    if masked and not fused:
        return cell("infeasible", "mask: only the temporal kernel "
                                  "streams one")
    try:
        plan = plan_for(shape, dtype, spec, policy,
                        t=t if fused else None, device=device,
                        masked=masked)
    except PlanError as e:
        return cell("infeasible", f"plan: {_first_line(e)}")
    try:
        prog = lower_plan(plan)
    except LoweringError as e:
        return cell("infeasible", f"lower: {_first_line(e)}")

    report = verify_program(prog)
    # Masked cells must be fully fused (iters divisible by t); the sweep
    # runs each cell's schedule at two fused blocks of the realized depth.
    iters = 2 * plan.t
    sched = build_schedule(
        iters, spec=spec, shape=shape, dtype=dtype, policy=policy,
        t=plan.t if fused else None, device=device,
        mesh_shape=SWEEP_MESH if (masked or overlap) else None,
        exchange_cadence=masked or overlap, overlap=overlap)
    report = report.merged(check_schedule(
        sched, shape=shape, dtype=dtype, spec=spec, device=device,
        mesh_shape=SWEEP_MESH if (masked or overlap) else None,
        program=prog, masked=masked))
    if not report.ok:
        return cell("error", f"{len(report.errors)} error diagnostic(s)",
                    report)
    occ = max((b.max_tiles for b in _occ(prog).values()), default=0)
    return cell("verified", f"cbs={len(prog.cbs)} peak_occ={occ} "
                            f"sched[{sched.describe()}]", report)


def _occ(prog):
    from repro_torch.analysis.verify import occupancy_bounds
    return occupancy_bounds(prog) or {}


def _first_line(exc) -> str:
    return str(exc).splitlines()[0]


def run_sweep(*, policies=None, specs=None, dtypes=None, devices=None,
              ts=SWEEP_T, shape=SWEEP_SHAPE, full: bool = False
              ) -> list[Cell]:
    """Verify the cross-product; returns every cell's outcome."""
    from repro_torch.backends.lower import lowerable_policies
    from repro_torch.engine.device import available_devices

    policies = tuple(policies or lowerable_policies())
    spec_map = _specs()
    specs = tuple(specs or SWEEP_SPECS)
    dtypes = tuple(dtypes or (SWEEP_DTYPES if full else ("float32",)))
    devices = tuple(devices or (available_devices() if full
                                else ("grayskull_e150", "tpu_v5e")))
    cells = []
    for device in devices:
        for policy in policies:
            for spec_name in specs:
                for dtype in dtypes:
                    for t in ts:
                        for masked in (False, True):
                            if masked and policy != "temporal":
                                continue  # only temporal streams a mask
                            for overlap in (False, True):
                                t0 = time.perf_counter()
                                cell = _verify_cell(
                                    policy, spec_name,
                                    spec_map[spec_name], dtype, device,
                                    t, masked, overlap, shape)
                                dt = time.perf_counter() - t0
                                cell = dataclasses.replace(cell, seconds=dt)
                                _metrics.histogram(
                                    "analysis.cell_seconds").observe(dt)
                                _metrics.counter(
                                    f"analysis.cells.{cell.outcome}").inc()
                                cells.append(cell)
    return cells

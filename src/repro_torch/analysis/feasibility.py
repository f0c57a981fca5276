"""Schedule feasibility: the port's copy of ``repro.analysis.feasibility``.

:func:`check_schedule` lifts the gates the executors enforce at run time
(the masked-remainder refusal, the remainder policy, the mesh
decomposition, the overlap gate) into one pass over a resolved
:class:`~repro_torch.engine.schedule.SweepSchedule`, reporting structured
:class:`~repro_torch.analysis.diagnostics.Diagnostic` records with the
reference's codes and text; :func:`check_bucket` gates a solve request
into its serving bucket. Callers that must raise do so through
``report.raise_if_errors(...)``.

The reference can also cross-check a lowered Tensix program
(``program=``); the port has no backends yet (ROADMAP Queue 1, E1), so a
program raises ``NotImplementedError``.
"""
from __future__ import annotations

from repro_torch.analysis.diagnostics import (Diagnostic, Report, error,
                                              warning)
from repro_torch.engine.device import DeviceModel
from repro_torch.engine.schedule import SweepSchedule, overlap_feasible


def _mesh_dims(mesh_shape) -> tuple[int, int]:
    if not mesh_shape:
        return (1, 1)
    px = int(mesh_shape[0])
    py = int(mesh_shape[1]) if len(mesh_shape) > 1 else 1
    return (px, py)


def check_bucket(expected: dict, got: dict) -> Report:
    """Field-by-field compatibility of a solve request with its bucket.

    The solve server (:mod:`repro_torch.serve.solve`) advances a bucket's
    slots with one batched launch, so every slot must agree on the
    launch's static fields (shape, dtype, spec, resolved policy, block
    depth, device). ``expected`` is the bucket's field dict, ``got`` the
    request's; every mismatching field becomes one ``SCHED-BUCKET-MIX``
    error diagnostic.
    """
    diags = tuple(
        error("SCHED-BUCKET-MIX", f"bucket.{field}",
              f"request has {field}={got.get(field)!r} but the bucket "
              f"batches {field}={want!r}",
              hint="route the request through SolveServer.submit, which "
                   "derives the bucket key from the request's own "
                   "schedule")
        for field, want in expected.items() if got.get(field) != want)
    return Report(diags)


def check_schedule(sched: SweepSchedule, *, shape, dtype=None,
                   spec=None, device: "str | DeviceModel | None" = None,
                   mesh_shape: tuple | None = None,
                   program=None, masked: bool = False) -> Report:
    """Statically check a schedule.

    ``shape`` is the full ringed grid the schedule sweeps; ``mesh_shape``
    the decomposition a distributed execution would use (None or one
    shard = single device); ``masked`` whether a pin-mask stream will be
    supplied (the distributed-shard form). ``dtype`` and ``device`` are
    part of the reference's signature; no gate here reads them. Returns a
    :class:`Report`, empty on the happy path.
    """
    del dtype, device  # no dtype- or device-specific gate without a program
    if program is not None:
        raise NotImplementedError(
            "check_schedule(program=...) cross-checks a lowered Tensix "
            "program, and repro_torch has no backends yet (ROADMAP Queue 1, "
            "E1)")
    diags: list[Diagnostic] = []
    if spec is not None and spec.radius != sched.radius:
        diags.append(warning(
            "SCHED-PROG-MISMATCH", "schedule",
            f"schedule was built for radius {sched.radius} but the spec "
            f"checked against has radius {spec.radius}",
            hint="build and check the schedule with the same spec"))
    r = sched.radius
    h, w = (int(s) for s in shape)
    hi, wi = h - 2 * r, w - 2 * r
    px, py = _mesh_dims(mesh_shape)

    if masked and (not sched.fused or sched.remainder):
        diags.append(error(
            "SCHED-MASK-REMAINDER", "schedule",
            f"mask requires a fully-fused schedule; got {sched.describe()}",
            hint="pick a fused policy and iters divisible by t (the "
                 "non-fused remainder would silently re-pin the geometric "
                 "ring instead of the mask)"))

    if sched.remainder:
        try:
            from repro_torch.engine.dispatch import get_policy
            rp_fused = get_policy(sched.remainder_policy).fused
        except ValueError:
            rp_fused = False  # "reference" etc.: not fused by definition
        if rp_fused:
            diags.append(error(
                "SCHED-REMAINDER-FUSED", "schedule",
                f"remainder_policy {sched.remainder_policy!r} must be "
                f"non-fused (it runs the {sched.remainder} leftover "
                f"sweep(s) one at a time)",
                hint="use a non-fused registry policy such as 'rowchunk'"))

    if px * py > 1 and (hi % px or wi % py):
        diags.append(error(
            "SCHED-MESH-DECOMP", "schedule",
            f"interior {hi}x{wi} does not decompose over mesh "
            f"{tuple(mesh_shape)}",
            hint="pick a mesh whose axes divide the interior rows/cols"))
    elif sched.overlap:
        hl, wl = hi // px, wi // py
        d = sched.halo_depth
        if not overlap_feasible(hl, wl, d, px * py):
            why = ("a single-shard mesh has no exchange to hide"
                   if px * py <= 1 else
                   f"shard interior {hl}x{wl} leaves no cell further than "
                   f"2*{d} from an edge — the rind strips cover the whole "
                   f"shard")
            diags.append(warning(
                "SCHED-OVERLAP-INFEASIBLE", "schedule",
                f"overlap selected but infeasible: {why}; the executor "
                f"falls back to the serial exchange round (same numbers, "
                f"nothing hidden)",
                hint="lower t, use fewer shards, or drop overlap"))

    return Report(tuple(diags))

"""Policy registry and dispatch for the stencil engine.

The port's copy of ``repro.engine.dispatch``. Every execution policy
registers itself here with its metadata (paper provenance, modeled
bytes/point). ``run`` is the public entry point: pick a policy
(``"auto"`` consults the device-aware heuristic, ``"tuned"`` the measured
cache in :mod:`repro_torch.engine.tune`), build the
:class:`~repro_torch.engine.schedule.SweepSchedule`, and execute it as
kernel launches.

On a CUDA tensor a schedule runs between two ping-pong buffers whose rings
are set once per run: its fused blocks enqueued by one library call, its
remainder as wrapper calls; on a CPU tensor a loop of wrapper calls runs
the plain versions. ``policy="reference"`` runs the plain
oracle ``apply_stencil`` on either device.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.core.stencil import (StencilSpec, apply_stencil,
                                      jacobi_2d_5pt, residual)
from repro_torch.engine import policies as P
from repro_torch.engine.device import DeviceModel
from repro_torch.engine.plan import DEFAULT_T, PlanError, plan_for
from repro_torch.engine.schedule import (DEFAULT_REMAINDER_POLICY,
                                         SweepSchedule, build_schedule,
                                         effective_depth)
from repro_torch.obs.trace import span as _obs_span


@dataclasses.dataclass(frozen=True)
class Policy:
    """A registered execution policy.

    ``fn(u, spec, *, bm=None, device=None, out=None[, t=None])`` advances
    the grid by one sweep (``fused=False``) or by ``t`` sweeps
    (``fused=True``).
    ``bytes_per_point(spec, dtype_bytes, t)`` is the device-memory traffic
    model per interior point per sweep.
    """

    name: str
    fn: Callable
    description: str
    paper_ref: str
    fused: bool
    bytes_per_point: Callable[[StencilSpec, int, int], float]


_REGISTRY: dict[str, Policy] = {}


def register_policy(policy: Policy) -> Policy:
    if policy.name in _REGISTRY:
        raise ValueError(f"policy {policy.name!r} already registered")
    _REGISTRY[policy.name] = policy
    return policy


def get_policy(name: str) -> Policy:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown policy {name!r}; registered: {available_policies()}"
        ) from None


def available_policies() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def registry() -> tuple[Policy, ...]:
    """All registered policies, in registration (paper-arc) order."""
    return tuple(_REGISTRY.values())


register_policy(Policy(
    name="shifted",
    fn=P.stencil_shifted,
    description="one materialized shifted copy per tap",
    paper_ref="§IV initial design (Table I 'initial')",
    fused=False,
    # taps operand reads + the source read that builds the shifts + 1 write
    bytes_per_point=lambda spec, db, t: db * (spec.taps + 2),
))
register_policy(Policy(
    name="rowchunk",
    fn=P.stencil_rowchunk,
    description="one haloed tile load + in-shared-memory tap views",
    paper_ref="§VI optimized design (Table I 'write optimised')",
    fused=False,
    bytes_per_point=lambda spec, db, t: db * 2,  # 1 read + 1 write
))
register_policy(Policy(
    name="dbuf",
    fn=P.stencil_dbuf,
    description="rowchunk with a two-stage prefetching tile walk",
    paper_ref="Table I 'double buffering'",
    fused=False,
    bytes_per_point=lambda spec, db, t: db * 2,
))
register_policy(Policy(
    name="temporal",
    fn=P.stencil_temporal,
    description="T sweeps fused per round-trip (T*r-deep halos)",
    paper_ref="beyond paper (§VII communication-avoiding direction)",
    fused=True,
    bytes_per_point=lambda spec, db, t: db * 2 / max(t, 1),
))


def resolve_auto(shape, dtype, spec: StencilSpec, *, iters: int = 1,
                 t: int | None = None,
                 device: str | DeviceModel | None = None,
                 masked: bool = False) -> str:
    """Pick a policy from a fast-memory/traffic heuristic for ``device``.

    Temporal blocking wins whenever several sweeps can amortize one
    round-trip and its plan fits *on that device*; with several blocks the
    double-buffered mover hides load latency; a single block leaves
    nothing to prefetch, so plain rowchunk; a window that never fits
    falls back to shifted.
    """
    t_eff = t if t is not None else min(DEFAULT_T, max(iters, 1))
    if iters >= 2 and t_eff >= 2:
        try:
            plan_for(shape, dtype, spec, "temporal", t=min(t_eff, iters),
                     device=device, masked=masked)
            return "temporal"
        except PlanError:
            pass
    try:
        plan = plan_for(shape, dtype, spec, "rowchunk", device=device)
    except PlanError:
        return "shifted"  # window never fits; stream per-tap blocks instead
    return "dbuf" if plan.nblocks >= 2 else "rowchunk"


def step(u: torch.Tensor, spec: StencilSpec | None = None, *,
         policy: str = "auto", bm: int | None = None, t: int | None = None,
         device: str | DeviceModel | None = None) -> torch.Tensor:
    """One kernel invocation: a single sweep, or ``t`` fused sweeps for the
    temporal policy."""
    spec = spec if spec is not None else jacobi_2d_5pt()
    if policy in ("auto", "tuned"):
        # A single step advances exactly one sweep, so auto/tuned never
        # pick a fused policy here (run() with iters does).
        policy = resolve_auto(u.shape[-2:], u.dtype, spec, iters=1, t=1,
                              device=device)
    p = get_policy(policy)
    if p.fused:
        return p.fn(u, spec, bm=bm, t=t, device=device)
    return p.fn(u, spec, bm=bm, device=device)


def residual_for(spec: StencilSpec | None = None) -> Callable:
    """Residual evaluator for ``spec``: ``u -> |apply(u) - u|_inf`` (f32)."""
    spec = spec if spec is not None else jacobi_2d_5pt()
    return functools.partial(residual, spec=spec)


def _launches(sched: SweepSchedule) -> list[tuple[Callable, dict]]:
    """A registry policy's schedule as a list of ``(fn, extra kwargs)``."""
    p = get_policy(sched.policy)
    if not p.fused:
        return [(p.fn, {})] * sched.iters
    rp = get_policy(sched.remainder_policy)
    return ([(p.fn, {"t": sched.t})] * sched.fused_blocks
            + [(rp.fn, {})] * sched.remainder)


def _ringed_like(u: torch.Tensor, r: int) -> torch.Tensor:
    buf = torch.empty_like(u, memory_format=torch.contiguous_format)
    P.copy_ring(u, buf, r)
    return buf


def _execute_schedule(u: torch.Tensor, sched: SweepSchedule,
                      spec: StencilSpec, bm, device, donate: bool
                      ) -> torch.Tensor:
    """Execute a frozen :class:`SweepSchedule` as kernel launches.

    On a CUDA tensor the launches ping-pong between two buffers whose
    rings are copied from ``u`` once; ``donate=True`` makes ``u`` itself
    the second buffer (the caller's tensor is then clobbered). The fused
    blocks go to the library in one call
    (:func:`~repro_torch.engine.policies.launch_chain`, its plan resolved
    once); the remainder launches one wrapper call each.

    The launches run under one ``engine.launches`` span whose
    ``launches`` attr counts them: its duration is the host's time for
    all of them, and its start, less the enclosing span's, the prologue
    before it. Nothing is timed per launch.
    """
    if sched.policy == "reference":
        for _ in range(sched.iters):
            u = apply_stencil(u, spec)
        return u
    calls = _launches(sched)
    if u.device.type == "cpu":
        with _obs_span("engine.launches", launches=len(calls)):
            for fn, kw in calls:
                u = fn(u, spec, bm=bm, device=device, **kw)
        return u
    r = spec.radius
    buf_a = _ringed_like(u, r) if calls else None
    buf_b = u if donate else (_ringed_like(u, r) if len(calls) > 1
                              else None)
    src, dst = u, buf_a
    chained = sched.fused_blocks if sched.fused else 0
    with _obs_span("engine.launches", launches=len(calls)):
        if chained:
            plan = plan_for(u.shape[-2:], u.dtype, spec, sched.policy, bm=bm,
                            t=sched.t, device=device)
            src = P.launch_chain(plan, u, buf_a, buf_b, chained)
            dst = buf_b if src is buf_a else buf_a
        for fn, kw in calls[chained:]:
            fn(src, spec, bm=bm, device=device, out=dst, **kw)
            src, dst = dst, (buf_b if dst is buf_a else buf_a)
    return src


def run_converged(u: torch.Tensor, spec: StencilSpec | None = None, *,
                  tol: float | None, max_iters: int, policy: str = "auto",
                  bm: int | None = None, t: int | None = None,
                  device: str | DeviceModel | None = None,
                  remainder_policy: str = DEFAULT_REMAINDER_POLICY,
                  donate: bool = False
                  ) -> tuple[torch.Tensor, int, float]:
    """Advance ``u`` until the max-norm update delta is <= ``tol``,
    checking after every cadence block.

    Semantics match ``repro.engine.run_converged`` exactly: the cadence is
    ``effective_depth(max_iters, t)``; residuals are tested at block
    boundaries only, so realized iterations are a multiple of the cadence
    and cap at ``(max_iters // cadence) * cadence``; the exit test is
    ``residual > tol`` in f32 with ``tol`` rounded to the nearest f32, and
    ``tol=None`` means ``-1.0`` (never exits early; the final residual is
    still reported). The exit test syncs with the host once per block.

    Returns ``(u, iters_done, residual)``.
    """
    spec = spec if spec is not None else jacobi_2d_5pt()
    with _obs_span("engine.run_converged", max_iters=max_iters, tol=tol,
                   shape=tuple(u.shape), requested_policy=policy) as sp:
        cadence = effective_depth(max_iters, t)
        sched = build_schedule(cadence, spec=spec, shape=u.shape,
                               dtype=u.dtype, policy=policy, t=cadence,
                               bm=bm, device=device,
                               remainder_policy=remainder_policy,
                               torch_device=u.device.type)
        max_blocks = max_iters // cadence
        tol_f32 = torch.tensor(-1.0 if tol is None else tol,
                               dtype=torch.float32, device=u.device)
        res = torch.tensor(float("inf"), dtype=torch.float32,
                           device=u.device)
        n = 0
        while n < max_blocks and bool(res > tol_f32):
            u = _execute_schedule(u, sched, spec, bm, device,
                                  donate=donate or n > 0)
            n += 1
            res = residual(u, spec)
        iters_done = n * cadence
        sp.set(policy=sched.policy, t=cadence, iters_done=iters_done,
               residual=float(res), launch="loop")
    return u, iters_done, float(res)


def run_batched(us: torch.Tensor, spec: StencilSpec | None = None, *,
                policy: str = "auto", iters: int = 1, bm: int | None = None,
                t: int | None = None,
                device: str | DeviceModel | None = None,
                remainder_policy: str = DEFAULT_REMAINDER_POLICY,
                donate: bool = False) -> torch.Tensor:
    """Advance a batch ``(B, H, W)`` of ringed grids ``iters`` sweeps each.

    Every grid shares one schedule; each launch covers the whole batch
    (the batch is a grid axis of the kernels), and each lane equals its
    solo :func:`run` bit for bit.
    """
    if us.ndim != 3:
        raise PlanError(f"run_batched wants a (B, H, W) batch of ringed "
                        f"grids; got shape {tuple(us.shape)}")
    spec = spec if spec is not None else jacobi_2d_5pt()
    sched = build_schedule(iters, spec=spec, shape=us.shape[1:],
                           dtype=us.dtype, policy=policy, t=t, bm=bm,
                           device=device, remainder_policy=remainder_policy,
                           torch_device=us.device.type)
    return _execute_schedule(us, sched, spec, bm, device, donate)


def run(u: torch.Tensor, spec: StencilSpec | None = None, *,
        policy: str = "auto", iters: int = 1, bm: int | None = None,
        t: int | None = None, device: str | DeviceModel | None = None,
        remainder_policy: str = DEFAULT_REMAINDER_POLICY,
        donate: bool = False) -> torch.Tensor:
    """Advance a ringed grid by exactly ``iters`` sweeps of ``spec``.

    ``policy`` is a registry name, ``"auto"`` (device-aware heuristic),
    ``"tuned"`` (measured winner) or ``"reference"``. ``device`` is a
    registry name or :class:`DeviceModel`; plans are validated against its
    fast-memory budget (None = :func:`~repro_torch.engine.device.detect`).
    The ``iters // t`` fused blocks plus the ``iters % t`` remainder under
    ``remainder_policy`` come from :func:`build_schedule`; this function
    executes them. ``donate=True`` lets the run use ``u``'s storage as
    one of its two buffers; the caller's tensor is invalid afterwards.
    """
    spec = spec if spec is not None else jacobi_2d_5pt()
    with _obs_span("engine.run", iters=iters, shape=tuple(u.shape),
                   requested_policy=policy) as sp:
        sched = build_schedule(iters, spec=spec, shape=u.shape,
                               dtype=u.dtype, policy=policy, t=t, bm=bm,
                               device=device,
                               remainder_policy=remainder_policy,
                               torch_device=u.device.type)
        sp.set(policy=sched.policy, t=sched.t,
               fused_blocks=sched.fused_blocks, remainder=sched.remainder,
               launch="loop")
        return _execute_schedule(u, sched, spec, bm, device, donate)

"""Jacobi iterative solver drivers (twin of ``repro.core.jacobi``).

The paper runs a fixed number of Jacobi iterations (5000/10000) over a 2-D
grid. The drivers:

  * ``jacobi_run``      — a fixed number of sweeps (paper-faithful), under
                          any engine policy name (or a step callable).
  * ``jacobi_solve``    — chunks of ``check_every`` sweeps until the
                          max-norm update across a chunk is <= ``tol``.
  * ``jacobi_run_temporal`` — temporal blocking (beyond the paper): ``t``
                          sweeps fused per grid round-trip; leftover
                          sweeps run under a non-fused registry policy.

Drivers select kernels by *policy name* from the engine registry
(``"reference"``, ``"shifted"``, ``"rowchunk"``, ``"dbuf"``,
``"temporal"``, ``"auto"``). A ``StepFn`` callable on tensors still
works. The reference scans its step with ``lax.scan``; the port loops in
Python, one kernel launch a sweep (or a fused block), on the grid's own
device.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.core.stencil import (StencilSpec, apply_stencil,
                                      jacobi_2d_5pt, max_update)

# A step function maps grid -> grid (one Jacobi sweep, ring fixed).
StepFn = Callable[[torch.Tensor], torch.Tensor]

#: Policy name for the plain oracle (not a kernel, so it lives in the
#: drivers rather than the engine registry).
REFERENCE = "reference"


def reference_step(spec: StencilSpec | None = None) -> StepFn:
    spec = spec or jacobi_2d_5pt()
    return functools.partial(apply_stencil, spec=spec)


def _both_given() -> ValueError:
    return ValueError("pass either a step callable or a policy name, "
                      "not both")


def _resolve_step(step: StepFn | str | None, policy: str | None,
                  spec: StencilSpec | None, **engine_kw) -> StepFn:
    """Turn (step, policy) into a StepFn.

    ``step`` may be a callable (used as-is), a policy-name string, or
    None; ``policy`` is the preferred spelling for names. Giving both a
    callable and a policy name is ambiguous and refused, and so is a
    fused policy, which would advance ``t`` sweeps a call.
    """
    if callable(step):
        if policy is not None:
            raise _both_given()
        return step
    name = policy if policy is not None else step
    if name is None or name == REFERENCE:
        return reference_step(spec)
    from repro_torch import engine
    if name != "auto" and engine.get_policy(name).fused:
        raise ValueError(
            f"policy {name!r} is fused; use jacobi_run (which delegates to "
            "engine.run), jacobi_run_temporal, or engine.run directly")
    return functools.partial(engine.step, spec=spec, policy=name, **engine_kw)


def _sweeps(u: torch.Tensor, step: StepFn, n: int) -> torch.Tensor:
    for _ in range(n):
        u = step(u)
    return u


def jacobi_run(u0: torch.Tensor, iters: int, step: StepFn | str | None = None,
               *, policy: str | None = None, spec: StencilSpec | None = None,
               bm: int | None = None) -> torch.Tensor:
    """Run a fixed number of Jacobi sweeps (paper's termination criterion).

    ``"auto"`` and fused policy names go to ``engine.run``, which counts
    the sweeps exactly (fused blocks plus a remainder).
    """
    if callable(step) and policy is not None:
        raise _both_given()
    name = policy if policy is not None else (step if isinstance(step, str)
                                              else None)
    if name is not None and name != REFERENCE:
        from repro_torch import engine
        if name == "auto" or engine.get_policy(name).fused:
            return engine.run(u0, spec, policy=name, iters=iters, bm=bm)
    return _sweeps(u0, _resolve_step(step, policy, spec, bm=bm), iters)


def jacobi_run_unrolled(u0: torch.Tensor, iters: int,
                        step: StepFn | str | None = None, unroll: int = 4, *,
                        policy: str | None = None,
                        spec: StencilSpec | None = None) -> torch.Tensor:
    """Fixed-iteration run. ``unroll`` is the reference's ``lax.scan``
    compile knob; a Python loop has nothing to unroll, so it is accepted
    and changes nothing."""
    return _sweeps(u0, _resolve_step(step, policy, spec), iters)


def jacobi_solve(
    u0: torch.Tensor,
    tol: float = 1e-5,
    max_iters: int = 100_000,
    check_every: int = 50,
    step: StepFn | str | None = None,
    spec: StencilSpec | None = None,
    *,
    policy: str | None = None,
    bm: int | None = None,
) -> tuple[torch.Tensor, int, float]:
    """Iterate until the max-norm update is below ``tol``.

    The reference's ``while_loop``: before each chunk, ``res > tol and it
    < max_iters``; a chunk is ``check_every`` sweeps, so the count moves
    in steps of ``check_every``; ``res`` is ``max|v - u|`` over the
    interior across the chunk, in f32 with subnormals flushed as XLA
    flushes them, compared with ``tol`` rounded to f32. The loop reads
    ``res`` on the host once a chunk (one sync a chunk).

    Returns ``(u, iters_done, final_residual)``.
    """
    spec = spec or jacobi_2d_5pt()
    step = _resolve_step(step, policy, spec, bm=bm)
    tol32 = torch.tensor(tol, dtype=torch.float32, device=u0.device)
    res = torch.tensor(float("inf"), dtype=torch.float32, device=u0.device)
    u, it = u0, 0
    while bool(res > tol32) and it < max_iters:
        v = _sweeps(u, step, check_every)
        res = max_update(v, u, spec.radius, spec.ndim)
        u, it = v, it + check_every
    return u, it, float(res)


def jacobi_run_temporal(u0: torch.Tensor, iters: int,
                        tstep: StepFn | None = None, t: int = 8, *,
                        spec: StencilSpec | None = None,
                        bm: int | None = None,
                        remainder_policy: str | None = None) -> torch.Tensor:
    """Run ``iters`` sweeps using a fused ``t``-step kernel.

    ``iters // t`` fused blocks advance the grid ``t`` sweeps per
    round-trip; the leftover ``iters % t`` sweeps run one at a time under
    ``remainder_policy`` (a non-fused registry policy, default
    :data:`repro_torch.engine.DEFAULT_REMAINDER_POLICY`), so any
    iteration count is valid.

    ``tstep`` (legacy) must advance the grid by exactly ``t`` sweeps per
    call; when omitted, the engine's temporal policy (K1) is used.
    """
    from repro_torch import engine

    spec = spec or jacobi_2d_5pt()
    remainder_policy = remainder_policy or engine.DEFAULT_REMAINDER_POLICY
    if tstep is None:
        return engine.run(u0, spec, policy="temporal", iters=iters, t=t,
                          bm=bm, remainder_policy=remainder_policy)
    nfull, rem = divmod(iters, t)
    u = _sweeps(u0, tstep, nfull)
    if rem:
        u = jacobi_run(u, rem, policy=remainder_policy, spec=spec, bm=bm)
    return u

"""Sweep scheduling: how ``iters`` sweeps become fused blocks.

The port's copy of ``repro.engine.schedule`` for single-device solves. A
:class:`SweepSchedule` is the frozen answer: the resolved policy (after
``"auto"`` lookup), the realized fusion depth ``t``, how many full-depth
blocks run, and how many remainder sweeps follow under which non-fused
policy. For the same arguments it equals the reference's schedule field
for field; ``auto`` resolves against the port's planner, whose 2-D tiles
let ``temporal`` fit on ``gpu_sm90``, and ``tuned`` against the port's
own measured cache (:mod:`repro_torch.engine.tune`), timed on
``torch_device``.

Distributed schedules (``exchange_cadence=True``) and their pricing come
with the distributed executor.
"""
from __future__ import annotations

import dataclasses
import warnings

from repro_torch.core.stencil import StencilSpec
from repro_torch.engine.device import DeviceModel
from repro_torch.engine.plan import DEFAULT_T, PlanError
from repro_torch.obs.trace import span as _obs_span

#: Non-fused policy used for the leftover sweeps when ``iters`` is not a
#: multiple of the temporal depth.
DEFAULT_REMAINDER_POLICY = "rowchunk"


def overlap_feasible(hl: int, wl: int, depth: int, nshards: int = 2) -> bool:
    """Whether a ``(hl, wl)``-interior shard can hide a depth-``depth``
    exchange behind halo-independent compute."""
    return nshards > 1 and hl > 2 * depth and wl > 2 * depth


def effective_depth(iters: int, t: int | None,
                    default: int = DEFAULT_T) -> int:
    """The realized fusion depth: the request clamped into ``[1, iters]``."""
    if t is not None and t < 1:
        raise PlanError(f"temporal depth t={t} must be >= 1")
    return min(t if t is not None else default, max(iters, 1))


@dataclasses.dataclass(frozen=True)
class SweepSchedule:
    """How ``iters`` sweeps of a radius-``r`` spec actually execute.

    ``fused_blocks`` blocks of ``t`` sweeps run under ``policy``, then
    ``remainder`` sweeps run under ``remainder_policy`` (equal to
    ``policy`` when the main policy is itself non-fused).
    """

    policy: str
    iters: int
    t: int
    fused: bool
    fused_blocks: int
    remainder: int
    remainder_policy: str
    radius: int
    #: Distributed execution only; always False here.
    overlap: bool = False

    def __post_init__(self):
        assert self.fused_blocks * self.t + self.remainder == self.iters, self

    @property
    def exchanges(self) -> int:
        """Halo exchanges a distributed execution of this schedule costs."""
        return self.fused_blocks + (1 if self.remainder else 0)

    @property
    def halo_depth(self) -> int:
        return self.t * self.radius

    def describe(self) -> str:
        parts = [f"{self.policy}: {self.iters} sweeps = "
                 f"{self.fused_blocks} x t={self.t}"]
        if self.remainder:
            parts.append(f" + {self.remainder} ({self.remainder_policy})")
        parts.append(f"; {self.exchanges} exchange"
                     f"{'s' if self.exchanges != 1 else ''} "
                     f"(halo depth {self.halo_depth}"
                     f"{', overlapped' if self.overlap else ''})")
        return "".join(parts)


def build_schedule(iters: int, *, spec: StencilSpec, shape, dtype,
                   policy: str = "auto", t: int | None = None,
                   bm: int | None = None,
                   device: "str | DeviceModel | None" = None,
                   remainder_policy: str = DEFAULT_REMAINDER_POLICY,
                   exchange_cadence: bool = False,
                   torch_device: str = "cuda") -> SweepSchedule:
    """Resolve ``(iters, t, policy)`` into a :class:`SweepSchedule`, inside
    an ``engine.build_schedule`` span (a no-op unless a tracer is
    installed)."""
    with _obs_span("engine.build_schedule", iters=iters,
                   requested_policy=policy, requested_t=t) as sp:
        sched = _build_schedule(
            iters, spec=spec, shape=shape, dtype=dtype, policy=policy, t=t,
            bm=bm, device=device, remainder_policy=remainder_policy,
            exchange_cadence=exchange_cadence, torch_device=torch_device)
        sp.set(policy=sched.policy, t=sched.t,
               fused_blocks=sched.fused_blocks, remainder=sched.remainder,
               overlap=sched.overlap)
        return sched


def _build_schedule(iters: int, *, spec: StencilSpec, shape, dtype,
                    policy: str = "auto", t: int | None = None,
                    bm: int | None = None,
                    device: "str | DeviceModel | None" = None,
                    remainder_policy: str = DEFAULT_REMAINDER_POLICY,
                    exchange_cadence: bool = False,
                    torch_device: str = "cuda") -> SweepSchedule:
    """Resolve ``(iters, t, policy)`` into a :class:`SweepSchedule`.

    ``policy`` may be a registry name, ``"reference"`` (the plain oracle),
    ``"auto"`` (device-aware heuristic) or ``"tuned"`` (measured winner,
    timed on ``torch_device`` at most once per cell); both are resolved
    with the real ``iters`` and ``t``. ``t`` groups sweeps into blocks
    for fused policies. An explicit ``t`` that must be clamped to ``iters`` warns.
    A fused ``remainder_policy`` is rejected.
    """
    if exchange_cadence:
        raise NotImplementedError(
            "exchange_cadence=True schedules the distributed executor, "
            "which repro_torch does not have yet")
    if iters < 0:
        raise PlanError(f"iters={iters} must be >= 0")
    if policy == "auto":
        from repro_torch.engine.dispatch import resolve_auto
        policy = resolve_auto(shape, dtype, spec, iters=iters, t=t,
                              device=device)
    elif policy == "tuned":
        from repro_torch.engine import tune  # deferred: tune imports dispatch
        policy = tune.best_policy(shape, dtype, spec, iters=iters, t=t,
                                  bm=bm, torch_device=torch_device,
                                  device=device)
    if policy == "reference":
        fused = False
    else:
        from repro_torch.engine.dispatch import get_policy
        fused = get_policy(policy).fused

    if fused:
        t_eff = effective_depth(iters, t)
        if t is not None and iters > 0 and t_eff < t:
            warnings.warn(
                f"requested fusion depth t={t} exceeds iters={iters}; "
                f"running t={t_eff} sweeps per fused block instead (the "
                f"schedule cannot fuse sweeps that do not exist)",
                stacklevel=2)
    else:
        t_eff = 1
    nfull, rem = divmod(iters, t_eff)

    if fused:
        if rem:
            from repro_torch.engine.dispatch import get_policy
            if get_policy(remainder_policy).fused:
                raise ValueError(
                    f"remainder_policy {remainder_policy!r} must be "
                    f"non-fused")
        rp = remainder_policy
    else:
        rp = policy  # non-fused remainders re-run the main policy
    return SweepSchedule(policy=policy, iters=iters, t=t_eff, fused=fused,
                         fused_blocks=nfull, remainder=rem,
                         remainder_policy=rp, radius=spec.radius)

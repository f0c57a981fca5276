"""Sweep scheduling: how ``iters`` sweeps become fused blocks + exchanges.

The port's copy of ``repro.engine.schedule``. A :class:`SweepSchedule` is
the frozen answer: the resolved policy (after ``"auto"``/``"tuned"``
lookup), the realized fusion depth ``t``, how many full-depth blocks run,
how many remainder sweeps follow under which non-fused policy, and — for
the distributed executor — how many halo exchanges the whole thing costs
and how deep each halo band is (``t * r``). For the same arguments it
equals the reference's schedule field for field; ``auto`` resolves
against the port's planner, whose 2-D tiles let ``temporal`` fit on
``gpu_sm90``, and ``tuned`` against the port's own measured cache
(:mod:`repro_torch.engine.tune`), timed on ``torch_device``.

:func:`price_exchange` bills a distributed schedule's halo rounds
serially (exchange + full-block compute) and overlapped (``max(exchange,
interior) + rind``: each shard's interior is independent of the incoming
halo, so it computes while the ``t*r``-deep exchange is in flight, and
only the rind strips wait; see :mod:`repro_torch.dist.stencil`). The
resulting :class:`ExchangeBill` is how ``build_schedule(overlap=None)``
decides per (shape, spec, t, device, mesh) whether hiding the exchange
pays for the rind's redundant compute. The bill prices the device
model's link rate (``DeviceModel.halo_link_bw``), whatever transport
actually carries the halo.
"""
from __future__ import annotations

import dataclasses
import warnings

import torch

from repro_torch.core.stencil import StencilSpec
from repro_torch.engine.device import DeviceModel, get_device
from repro_torch.engine.plan import DEFAULT_T, PlanError, dtype_name
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
    #: Distributed execution only: split each shard block into a
    #: halo-independent interior (launched while the exchange is in
    #: flight) and rind strips (patched in after arrival), instead of
    #: serializing exchange then full-block compute. Numerically
    #: identical either way; priced by :func:`price_exchange`.
    overlap: bool = False

    def __post_init__(self):
        assert self.fused_blocks * self.t + self.remainder == self.iters, self

    @property
    def exchanges(self) -> int:
        """Halo exchanges a distributed execution of this schedule costs."""
        return self.fused_blocks + (1 if self.remainder else 0)

    @property
    def halo_depth(self) -> int:
        """Rows/cols of halo each full-depth exchange must carry (t·r)."""
        return self.t * self.radius

    @property
    def remainder_halo_depth(self) -> int:
        return self.remainder * self.radius

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


@dataclasses.dataclass(frozen=True)
class ExchangeBill:
    """Modeled cost of a distributed schedule's halo rounds, both ways.

    All times are seconds summed over every round (fused blocks plus the
    remainder). ``serial_s`` bills each round as ``exchange + full-block
    compute``; ``overlapped_s`` bills ``max(exchange, interior) +
    rind`` — the interior launch has no data dependence on the incoming
    halo, so it rides free under the exchange, and only the four rind
    strips (which recompute a band of width ``3*t*r`` around the shard,
    the redundancy overlap pays for) sit on the critical path.
    ``feasible`` is False when the shard is too small to hold a nonempty
    interior (``hl <= 2*t*r`` or ``wl <= 2*t*r``) or the mesh has a
    single shard; the executor then falls back to the serial round and
    ``overlapped_s == serial_s``.
    """

    exchange_s: float
    compute_s: float
    interior_s: float
    rind_s: float
    serial_s: float
    overlapped_s: float
    halo_bytes: int
    feasible: bool

    @property
    def wins(self) -> bool:
        """Whether overlapping beats the serial bill for this cell."""
        return self.feasible and self.overlapped_s < self.serial_s

    def describe(self) -> str:
        return (f"exchange {self.exchange_s * 1e6:.1f}us "
                f"({self.halo_bytes} B): serial "
                f"{self.serial_s * 1e6:.1f}us vs overlapped "
                f"{self.overlapped_s * 1e6:.1f}us "
                f"({'overlap wins' if self.wins else 'serial wins'})")

    def as_attrs(self) -> dict:
        """The bill as flat span attrs (``model_``-prefixed seconds), the
        form the traced distributed executor attaches to each round's
        ``exchange``/``interior``/``rind`` spans so ``obs.reconcile`` can
        join measured durations against this pricing."""
        return {"model_exchange_s": self.exchange_s,
                "model_compute_s": self.compute_s,
                "model_interior_s": self.interior_s,
                "model_rind_s": self.rind_s,
                "model_serial_s": self.serial_s,
                "model_overlapped_s": self.overlapped_s,
                "halo_bytes": self.halo_bytes,
                "feasible": self.feasible}


def _price_rounds(rounds, *, d_max: int, radius: int, taps: int,
                  shard_shape, dtype, device, mesh_shape) -> ExchangeBill:
    """Price halo rounds on one shard. ``rounds`` is ``[(reps, sweeps)]``;
    ``shard_shape`` is the *extended* shard (interior + 2*d_max halo)."""
    dev = get_device(device)
    db = getattr(torch, dtype_name(dtype)).itemsize
    hl = shard_shape[0] - 2 * d_max
    wl = shard_shape[1] - 2 * d_max
    mesh_shape = tuple(mesh_shape) if mesh_shape else (1,)
    px = int(mesh_shape[0])
    py = int(mesh_shape[1]) if len(mesh_shape) > 1 else 1
    feasible = overlap_feasible(hl, wl, d_max, px * py)

    def compute_s(area: int, sweeps: int) -> float:
        # Fused-traffic floor: one read + one write of the block per
        # round whatever the policy ends up being (non-fused policies pay
        # more on both sides of the comparison), flops per sweep.
        flops = 2 * taps * area * sweeps / max(dev.vector_flops, 1.0)
        mem = area * 2 * db / dev.dram_bw
        return max(flops, mem)

    exchange = compute = interior = rind = serial = overlapped = 0.0
    halo_bytes = 0
    for reps, sweeps in rounds:
        if reps <= 0 or sweeps <= 0:
            continue
        dd = sweeps * radius
        msgs, nbytes = 0, 0
        if px > 1:
            msgs += 2
            nbytes += 2 * dd * wl * db
        if py > 1:
            msgs += 2
            nbytes += 2 * dd * (hl + 2 * dd) * db
        ex = msgs * dev.txn_overhead_s + nbytes / dev.halo_link_bw \
            + (2 * dev.noc_hop_latency_s if msgs else 0.0)
        full = compute_s((hl + 2 * dd) * (wl + 2 * dd), sweeps)
        inner = compute_s(hl * wl, sweeps)
        # The four rind strips are separate launches: top/bottom span the
        # full extended width at height 3*dd, left/right fill the
        # remaining hl rows at width 3*dd (repro_torch.dist.stencil).
        rnd = 2 * compute_s(3 * dd * (wl + 2 * dd), sweeps) \
            + 2 * compute_s(hl * 3 * dd, sweeps)
        exchange += reps * ex
        compute += reps * full
        interior += reps * inner
        rind += reps * rnd
        halo_bytes += reps * nbytes
        serial += reps * (ex + full)
        overlapped += reps * ((max(ex, inner) + rnd) if feasible
                              else (ex + full))
    return ExchangeBill(exchange_s=exchange, compute_s=compute,
                        interior_s=interior, rind_s=rind, serial_s=serial,
                        overlapped_s=overlapped, halo_bytes=halo_bytes,
                        feasible=feasible)


def price_exchange(sched: SweepSchedule, *, shard_shape, dtype,
                   spec: StencilSpec,
                   device: "str | DeviceModel | None" = None,
                   mesh_shape: tuple | None = None) -> ExchangeBill:
    """Bill a distributed schedule's halo rounds serial vs overlapped.

    ``shard_shape`` is the extended shard ``plan_distributed`` returns
    (interior + the depth-``t*r`` halo on each side); ``mesh_shape`` the
    decomposition (e.g. ``(4,)`` or ``(2, 2)``); ``device`` the model
    whose link/DRAM/vector numbers do the pricing — exchange bytes ride
    :attr:`~repro_torch.engine.device.DeviceModel.halo_link_bw`.
    """
    rounds = [(sched.fused_blocks, sched.t)]
    if sched.remainder:
        rounds.append((1, sched.remainder))
    return _price_rounds(rounds, d_max=sched.halo_depth,
                         radius=sched.radius, taps=spec.taps,
                         shard_shape=shard_shape, dtype=dtype,
                         device=device, mesh_shape=mesh_shape)


def build_schedule(iters: int, *, spec: StencilSpec, shape, dtype,
                   policy: str = "auto", t: int | None = None,
                   bm: int | None = None,
                   device: "str | DeviceModel | None" = None,
                   mesh_shape: tuple | None = None,
                   remainder_policy: str = DEFAULT_REMAINDER_POLICY,
                   exchange_cadence: bool = False,
                   overlap: bool | None = None,
                   torch_device: str = "cuda") -> SweepSchedule:
    """Resolve ``(iters, t, policy)`` into a :class:`SweepSchedule`, inside
    an ``engine.build_schedule`` span (a no-op unless a tracer is
    installed)."""
    with _obs_span("engine.build_schedule", iters=iters,
                   requested_policy=policy, requested_t=t) as sp:
        sched = _build_schedule(
            iters, spec=spec, shape=shape, dtype=dtype, policy=policy, t=t,
            bm=bm, device=device, mesh_shape=mesh_shape,
            remainder_policy=remainder_policy,
            exchange_cadence=exchange_cadence, overlap=overlap,
            torch_device=torch_device)
        sp.set(policy=sched.policy, t=sched.t,
               fused_blocks=sched.fused_blocks, remainder=sched.remainder,
               overlap=sched.overlap)
        return sched


def _build_schedule(iters: int, *, spec: StencilSpec, shape, dtype,
                    policy: str = "auto", t: int | None = None,
                    bm: int | None = None,
                    device: "str | DeviceModel | None" = None,
                    mesh_shape: tuple | None = None,
                    remainder_policy: str = DEFAULT_REMAINDER_POLICY,
                    exchange_cadence: bool = False,
                    overlap: bool | None = None,
                    torch_device: str = "cuda") -> SweepSchedule:
    """Resolve ``(iters, t, policy)`` into a :class:`SweepSchedule`.

    ``policy`` may be a registry name, ``"reference"`` (the plain oracle),
    ``"auto"`` (device-aware heuristic) or ``"tuned"`` (measured winner,
    timed on ``torch_device`` at most once per cell); both are resolved
    against ``shape``/``dtype``/``device`` with the real ``iters`` and
    ``t`` (and ``mesh_shape`` folded into the tuned cache key).

    ``t`` groups sweeps into blocks for fused policies always, and for
    non-fused policies only under ``exchange_cadence=True`` (the
    distributed executor, where ``t`` is the sweeps-per-exchange knob
    whatever the local fusion). An explicit ``t`` that must be clamped to
    ``iters`` warns. A fused ``remainder_policy`` is rejected.

    ``overlap`` (under ``exchange_cadence`` only) selects the interior/rind
    split that hides each exchange behind the halo-independent compute:
    ``True``/``False`` force it, ``None`` asks :func:`price_exchange`
    whether the hidden exchange beats the rind's redundant compute for
    this (shape, spec, t, device, mesh) cell — resolved before the policy
    so the tuned cache key can carry it.
    """
    if iters < 0:
        raise PlanError(f"iters={iters} must be >= 0")
    if overlap and not exchange_cadence:
        raise PlanError(
            "overlap=True requires exchange_cadence=True (the distributed "
            "executor): a single-device schedule has no halo exchange to "
            "hide")
    overlap_eff = bool(overlap) and exchange_cadence
    if overlap is None and exchange_cadence and iters > 0:
        t_probe = effective_depth(iters, t)
        nfull_p, rem_p = divmod(iters, t_probe)
        rounds = [(nfull_p, t_probe)] + ([(1, rem_p)] if rem_p else [])
        bill = _price_rounds(rounds, d_max=t_probe * spec.radius,
                             radius=spec.radius, taps=spec.taps,
                             shard_shape=shape, dtype=dtype, device=device,
                             mesh_shape=mesh_shape)
        overlap_eff = bill.wins
    if policy == "auto":
        from repro_torch.engine.dispatch import resolve_auto
        # The distributed executor launches fused policies with a pin
        # mask; gate the candidate by the plan that will run.
        policy = resolve_auto(shape, dtype, spec, iters=iters, t=t,
                              device=device, masked=exchange_cadence)
    elif policy == "tuned":
        from repro_torch.engine import tune  # deferred: tune imports dispatch
        policy = tune.best_policy(shape, dtype, spec, iters=iters, t=t,
                                  bm=bm, torch_device=torch_device,
                                  device=device, mesh=mesh_shape,
                                  masked=exchange_cadence,
                                  overlap=overlap_eff)
    if policy == "reference":
        fused = False
    else:
        from repro_torch.engine.dispatch import get_policy
        fused = get_policy(policy).fused

    if fused or exchange_cadence:
        t_eff = effective_depth(iters, t)
        if t is not None and iters > 0 and t_eff < t:
            warnings.warn(
                f"requested fusion depth t={t} exceeds iters={iters}; "
                f"running t={t_eff} sweeps per "
                f"{'exchange' if exchange_cadence else 'fused block'} "
                f"instead (the schedule cannot fuse sweeps that do not "
                f"exist)", stacklevel=2)
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
                         remainder_policy=rp, radius=spec.radius,
                         overlap=overlap_eff)

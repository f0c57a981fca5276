"""Distributed dispatch: any registered policy, per shard, over a mesh.

The port's copy of ``repro.engine.distributed``. ``run_distributed`` is
the multi-device twin of ``engine.run``: it advances a ringed grid by
``iters`` sweeps of any 2-D :class:`StencilSpec`, decomposed over a
:class:`~repro_torch.dist.mesh.ShardMesh` (every shard in this process)
or a :class:`~repro_torch.dist.process.ProcessMesh` (one shard a rank of
a ``torch.distributed`` group, every rank making the same call) with
depth-``t`` halo exchange (:mod:`repro_torch.dist.stencil`), and runs the
*local* computation through the same policy registry ``engine.run``
uses.

Scheduling is shared with ``engine.run``: both executors run a
:class:`~repro_torch.engine.schedule.SweepSchedule` (``t`` sweeps per
fused block/halo exchange, remainder under a non-fused policy), built once
by :func:`plan_distributed` — inspect it to see the exchange count a run
will cost before paying for it. Per-shard plans are validated against the
target :class:`~repro_torch.engine.device.DeviceModel` before anything is
split: the static local block (shard interior + exchanged halo, from
``dist.stencil.extended_shard_shape``) must fit the device's fast memory.

The local sweep obeys the registry contract (f32 tap accumulation in
fixed tap order), so the distributed result is bit-identical to the
single-device ``engine.run`` under the same policy. Fused policies run
*fused* per shard: K1 (``stencil_temporal``) takes the shard's pin mask
(only the slice of the global Dirichlet ring the shard owns stays fixed;
the exchanged halo evolves) and advances all ``t`` sweeps in one
round-trip between exchanges.

The reference's ``interpret`` flag becomes ``torch_device``, as in
:mod:`repro_torch.engine.tune`: the device type ``policy="tuned"`` times
its candidates on (None: that of the mesh's shards).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.stencil import StencilSpec, apply_stencil, jacobi_2d_5pt
from repro_torch.engine.device import DeviceModel
from repro_torch.engine.dispatch import get_policy, resolve_auto
from repro_torch.engine.plan import plan_for
from repro_torch.engine.schedule import (DEFAULT_REMAINDER_POLICY,
                                         SweepSchedule, build_schedule,
                                         effective_depth, price_exchange)
from repro_torch.obs.trace import get_tracer


def _mesh_shape(mesh, row_axis: str | None, col_axis: str | None) -> tuple:
    """The decomposition shape folded into tuned cache keys — derived in
    one place so the key built at schedule time and the one passed to
    ``local_sweep_for`` cannot diverge."""
    return tuple(mesh.shape[a] for a in (row_axis, col_axis)
                 if a is not None)


def _torch_device(mesh, torch_device: str | None) -> str:
    return torch_device if torch_device is not None else \
        mesh.devices[0].type


def local_sweep_for(policy: str, spec: StencilSpec, *, shard_shape,
                    dtype, iters: int = 1, t: int = 1,
                    bm: int | None = None, torch_device: str = "cuda",
                    device: str | DeviceModel | None = None,
                    mesh_shape: tuple | None = None,
                    overlap: bool = False):
    """Resolve a policy name to a block callable on extended shards.

    The returned ``block(ext, fixed, t, out=None)`` advances an extended
    shard ``t`` sweeps, keeping the ``fixed`` cells (the shard's slice of
    the global Dirichlet ring) pinned: fused policies pass the mask
    straight into the kernel and run all ``t`` sweeps in one round-trip;
    non-fused policies loop single sweeps with re-pinning in between
    (:func:`repro_torch.dist.stencil.masked_block`).

    ``"reference"`` selects the plain oracle; ``"auto"`` consults the
    planner and ``"tuned"`` the measured cache (timed on
    ``torch_device``), both against the extended shard shape on
    ``device`` at the real ``iters`` and ``t`` (``mesh_shape`` and
    ``overlap`` fold into the tuned cache key). For registry policies the
    shard plan is resolved here, so a device-budget violation surfaces
    before any shard moves.
    """
    from repro_torch.dist.stencil import masked_block

    if policy == "reference":
        return masked_block(lambda ext: apply_stencil(ext, spec))
    if policy == "auto":
        policy = resolve_auto(shard_shape, dtype, spec, iters=iters, t=t,
                              device=device, masked=True)
    elif policy == "tuned":
        from repro_torch.engine import tune  # deferred: tune imports dispatch
        policy = tune.best_policy(shard_shape, dtype, spec, iters=iters, t=t,
                                  bm=bm, torch_device=torch_device,
                                  device=device, mesh=mesh_shape,
                                  masked=True, overlap=overlap)
    p = get_policy(policy)
    if p.fused:
        plan_for(shard_shape, dtype, spec, policy, bm=bm, t=t, device=device,
                 masked=True)

        def fused(ext, fixed, tt: int, out=None):
            return p.fn(ext, spec, bm=bm, t=tt, device=device, mask=fixed,
                        out=out)
        return fused
    plan_for(shard_shape, dtype, spec, policy, bm=bm, device=device)
    return masked_block(lambda ext: p.fn(ext, spec, bm=bm, device=device))


def plan_distributed(shape, dtype, spec: StencilSpec | None = None, *,
                     mesh, policy: str = "auto", iters: int = 1, t: int = 1,
                     bm: int | None = None, row_axis: str | None = None,
                     col_axis: str | None = None,
                     torch_device: str | None = None,
                     device: str | DeviceModel | None = None,
                     remainder_policy: str = DEFAULT_REMAINDER_POLICY,
                     overlap: bool | None = None
                     ) -> tuple[SweepSchedule, tuple[int, int], tuple]:
    """Resolve what a ``run_distributed`` call will execute, without running.

    Returns ``(schedule, shard_shape, (row_axis, col_axis))``: the shared
    :class:`SweepSchedule` (resolved policy, realized ``t``, fused blocks,
    remainder, and ``schedule.exchanges`` halo exchanges of depth
    ``schedule.halo_depth``), plus the static extended shard shape
    per-shard plans are validated against. ``run_distributed`` itself
    goes through here, so inspection and execution cannot disagree.

    ``overlap=None`` reads the mesh first: when every shard sits on one
    device, no halo crosses a link and the split has nothing to hide, so
    the round runs serially. Otherwise the schedule chooses the split by
    price (``engine.price_exchange`` against ``device`` and the mesh,
    which bills a device and a link a shard). ``True``/``False`` force
    it.
    """
    from repro_torch.dist import stencil as dstencil

    spec = spec if spec is not None else jacobi_2d_5pt()
    row_axis, col_axis = dstencil.resolve_axes(mesh, row_axis, col_axis)
    if overlap is None and len(set(mesh.devices)) == 1:
        overlap = False
    t_eff = effective_depth(iters, t)
    shard_shape = dstencil.extended_shard_shape(
        shape, mesh, spec, t=t_eff, row_axis=row_axis, col_axis=col_axis)
    sched = build_schedule(iters, spec=spec, shape=shard_shape, dtype=dtype,
                           policy=policy, t=t, bm=bm, device=device,
                           mesh_shape=_mesh_shape(mesh, row_axis, col_axis),
                           remainder_policy=remainder_policy,
                           exchange_cadence=True, overlap=overlap,
                           torch_device=_torch_device(mesh, torch_device))
    return sched, shard_shape, (row_axis, col_axis)


def run_distributed(u: torch.Tensor, spec: StencilSpec | None = None, *,
                    mesh, policy: str = "auto", iters: int = 1, t: int = 1,
                    bm: int | None = None, row_axis: str | None = None,
                    col_axis: str | None = None,
                    torch_device: str | None = None,
                    device: str | DeviceModel | None = None,
                    remainder_policy: str = DEFAULT_REMAINDER_POLICY,
                    overlap: bool | None = None,
                    donate: bool = False) -> torch.Tensor:
    """Advance a ringed grid by ``iters`` sweeps of ``spec`` over ``mesh``.

    Same contract and return as ``engine.run`` (full grid, ring copied
    through), decomposed rows x cols over ``(row_axis, col_axis)``
    (defaults: the mesh's first/second axes), each shard on the mesh's
    device for it. ``t`` sweeps run per halo exchange (depth-``t*r``
    halos; a ``t`` that must be clamped to ``iters`` warns); fused
    policies run all ``t`` sweeps in one kernel launch per shard.
    ``policy`` is any registry name, ``"reference"``, ``"auto"`` or
    ``"tuned"``; ``device`` selects the device model each shard's plan is
    validated against (None = detect); leftover ``iters % t`` sweeps run
    under ``remainder_policy`` when the main policy is fused, exactly
    like ``engine.run``. ``overlap`` hides each exchange behind the
    shard's halo-independent interior compute (None = serial when every
    shard is on one device, else let the schedule price it; the result
    is bit-identical either way). ``donate=True``
    writes the result into ``u`` itself.

    Over a ``ProcessMesh`` every rank passes the same ``u``, runs its own
    shard's rounds and returns the whole grid (all-gathered), on ``u``'s
    device. The rounds are a Python loop of launches. With an obs tracer
    installed, rounds run through the span-per-phase traced executor,
    each phase span carrying its round's modeled
    :class:`~repro_torch.engine.schedule.ExchangeBill`.
    """
    from repro_torch.dist import stencil as dstencil

    spec = spec if spec is not None else jacobi_2d_5pt()
    torch_device = _torch_device(mesh, torch_device)
    sched, shard_shape, (row_axis, col_axis) = plan_distributed(
        u.shape, u.dtype, spec, mesh=mesh, policy=policy, iters=iters, t=t,
        bm=bm, row_axis=row_axis, col_axis=col_axis,
        torch_device=torch_device, device=device,
        remainder_policy=remainder_policy, overlap=overlap)
    mesh_shape = _mesh_shape(mesh, row_axis, col_axis)
    block = local_sweep_for(sched.policy, spec, shard_shape=shard_shape,
                            dtype=u.dtype, iters=iters, t=sched.t, bm=bm,
                            torch_device=torch_device, device=device,
                            mesh_shape=mesh_shape, overlap=sched.overlap)
    remainder_block = None
    if sched.remainder and sched.remainder_policy != sched.policy:
        # Fused main policy with leftovers: the shallower remainder
        # exchange runs the non-fused remainder policy per shard.
        remainder_block = local_sweep_for(
            sched.remainder_policy, spec, shard_shape=shard_shape,
            dtype=u.dtype, iters=sched.remainder, t=sched.remainder, bm=bm,
            torch_device=torch_device, device=device, mesh_shape=mesh_shape,
            overlap=sched.overlap)
    bill = remainder_bill = None
    if get_tracer() is not None:
        # Per-round bills for the traced executor's phase spans: one
        # fused round, and the (shallower) remainder round, priced by the
        # same price_exchange the overlap decision came from.
        if sched.fused_blocks:
            bill = price_exchange(
                dataclasses.replace(sched, iters=sched.t, fused_blocks=1,
                                    remainder=0),
                shard_shape=shard_shape, dtype=u.dtype, spec=spec,
                device=device, mesh_shape=mesh_shape)
        if sched.remainder:
            remainder_bill = price_exchange(
                dataclasses.replace(sched, iters=sched.remainder,
                                    fused_blocks=0),
                shard_shape=shard_shape, dtype=u.dtype, spec=spec,
                device=device, mesh_shape=mesh_shape)
    return dstencil.run_sharded(u, spec, mesh, block, schedule=sched,
                                row_axis=row_axis, col_axis=col_axis,
                                remainder_block=remainder_block,
                                bill=bill, remainder_bill=remainder_bill,
                                donate=donate)

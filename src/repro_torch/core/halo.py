"""Distributed Jacobi front door: the halo exchange between shards.

The port's copy of ``repro.core.halo``. The reference's helpers run
inside ``shard_map`` on one shard and move halos with ``ppermute``; here
one process holds every shard of a
:class:`~repro_torch.dist.mesh.ShardMesh`, so the helpers take the list
of shard tensors along one mesh axis and hand each shard its neighbours'
boundary rows (or columns). Everything else — deep (depth-``t``) halos,
Dirichlet-band pinning, corner transport, any
:class:`~repro_torch.core.stencil.StencilSpec` and engine policy per shard,
and the interior/rind overlap — lives in :mod:`repro_torch.dist.stencil`
behind ``repro_torch.engine.run_distributed``;
:func:`make_distributed_step` is a thin delegate, so the machinery exists
exactly once.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch


def exchange_rows(shards: Sequence[torch.Tensor], depth: int = 1):
    """Each shard's ``(up, down)`` halos of ``depth`` rows.

    ``shards`` are the row neighbours in order (shard ``i`` sits above
    shard ``i + 1``). Shard ``i`` receives the last ``depth`` rows of shard
    ``i - 1`` as ``up`` and the first ``depth`` rows of shard ``i + 1`` as
    ``down``, on its own device (views when the devices agree). Edge
    shards receive zeros, which the caller replaces with Dirichlet data.
    """
    out = []
    for i, u in enumerate(shards):
        z = None if 0 < i < len(shards) - 1 else u.new_zeros(
            (depth,) + tuple(u.shape[1:]))
        up = shards[i - 1][-depth:, :].to(u.device) if i > 0 else z
        down = shards[i + 1][:depth, :].to(u.device) \
            if i < len(shards) - 1 else z
        out.append((up, down))
    return out


def exchange_cols(shards: Sequence[torch.Tensor], depth: int = 1):
    """Each shard's ``(left, right)`` halos of ``depth`` columns; the
    column twin of :func:`exchange_rows` (shard ``i`` sits left of shard
    ``i + 1``)."""
    out = []
    for i, u in enumerate(shards):
        z = None if 0 < i < len(shards) - 1 else u.new_zeros(
            tuple(u.shape[:1]) + (depth,))
        left = shards[i - 1][:, -depth:].to(u.device) if i > 0 else z
        right = shards[i + 1][:, :depth].to(u.device) \
            if i < len(shards) - 1 else z
        out.append((left, right))
    return out


def make_distributed_step(
    mesh,
    row_axis: str | None = "data",
    col_axis: str | None = "model",
    depth: int = 1,
    overlap: bool = True,
    local_sweep: Callable | None = None,
) -> Callable:
    """Build a global step: ``(interior, bc) -> interior'``.

    The returned function advances the grid by ``depth`` Jacobi sweeps
    with one halo exchange over ``mesh`` (a
    :class:`~repro_torch.dist.mesh.ShardMesh`). ``bc`` holds the four
    Dirichlet edge vectors of :func:`repro_torch.core.decomp.split_ringed`.
    ``local_sweep`` optionally plugs a custom kernel in for the local
    computation (ringed contract: full grid in, full grid out, outer ring
    copied through). ``overlap`` computes the halo-independent interior
    before the exchange. Everything delegates to
    :mod:`repro_torch.dist.stencil`.
    """
    # Deferred: dist.stencil imports the exchange helpers from here.
    from repro_torch.core.stencil import apply_stencil, jacobi_2d_5pt
    from repro_torch.dist import stencil as dstencil

    spec = jacobi_2d_5pt()
    sweep = local_sweep if local_sweep is not None else (
        lambda ext: apply_stencil(ext, spec))
    band_step = dstencil.make_sharded_step(mesh, spec,
                                           dstencil.masked_block(sweep),
                                           row_axis=row_axis,
                                           col_axis=col_axis, t=depth,
                                           overlap=overlap)

    def step(interior: torch.Tensor,
             bc: Dict[str, torch.Tensor]) -> torch.Tensor:
        bands = {"top": bc["top"][None, :], "bottom": bc["bottom"][None, :],
                 "left": bc["left"][:, None], "right": bc["right"][:, None]}
        return band_step(interior, bands)

    return step


def jacobi_run_distributed(interior, bc, iters: int, step: Callable,
                           depth: int = 1):
    """Run ``iters`` sweeps (``iters % depth == 0``) with the distributed
    step, one call a ``depth`` sweeps."""
    if iters % depth:
        raise ValueError(f"iters={iters} not divisible by halo depth {depth}")
    u = interior
    for _ in range(iters // depth):
        u = step(u, bc)
    return u

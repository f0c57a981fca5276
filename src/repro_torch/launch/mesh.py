"""Production meshes (twin of ``repro.launch.mesh``), as
:class:`~repro_torch.dist.mesh.ShardMesh` es.

:func:`make_production_mesh` is the dry run's mesh: 16 x 16 (one pod of
256 chips) or 2 x 16 x 16 over ``("pod", "data", "model")``, its shards
on the ``meta`` device, so it holds no storage and asks for no card: the
sharding rules read only its shape. :func:`make_mesh` is any mesh over
real devices (the cards present, shard ``i`` on card ``i % count``,
unless the caller asks for the CPU), as the reference's takes
``jax.devices()[:n]``.
"""
from __future__ import annotations

import math

from repro_torch.dist.mesh import ShardMesh


def make_production_mesh(*, multi_pod: bool = False) -> ShardMesh:
    """16x16 (one pod, 256 chips) or 2x16x16 (two pods), every shard on
    ``meta`` (shapes only)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return ShardMesh(shape, axes, ["meta"] * math.prod(shape))


def make_mesh(shape: tuple, axes: tuple, devices=None) -> ShardMesh:
    """A mesh of ``shape`` over ``axes``; ``devices`` lists one device a
    shard (default: :func:`repro_torch.dist.mesh.default_devices`, shard
    ``i`` on ``cuda:{i % device_count()}``)."""
    return ShardMesh(shape, axes, devices)

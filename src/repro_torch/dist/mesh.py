"""An in-process mesh of shards, the port's counterpart of a jax ``Mesh``.

The reference's distributed executor is single-controller SPMD: one
program, ``shard_map`` over a ``jax.sharding.Mesh``, halos moved with
``ppermute``. Its counterpart here is one process that holds every
shard, each on a torch device from a list, with the halos moved between
the shard tensors by ``copy_`` (between cards too: PyTorch orders a copy
between devices against both devices' current streams). By default
shard ``i`` sits on ``cuda:{i % torch.cuda.device_count()}``
(:func:`default_devices`): one shard a card when there are as many cards
as shards, as ``jax.devices()[:n]`` gives; on one card every shard
shares it (four shards on one card run the exchange, the masked kernels
and the overlap split for real, on one card's memory). One process a
card over ``torch.distributed`` is
:class:`~repro_torch.dist.process.ProcessMesh`.

:class:`ShardMesh` answers what the executor reads of a mesh:
``.shape[axis]``, ``.axis_names``, and the device of a shard.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.stencil import require_device


def check_mesh(shape, axis_names) -> tuple[tuple, tuple]:
    """``shape`` and ``axis_names`` as tuples, one name an axis, sizes
    >= 1 and names distinct; else ValueError."""
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names) or not shape:
        raise ValueError(f"mesh shape {shape} needs one name an axis; "
                         f"got {axis_names}")
    if min(shape) < 1 or len(set(axis_names)) != len(axis_names):
        raise ValueError(f"mesh {shape} over {axis_names}: sizes must "
                         f"be >= 1 and names distinct")
    return shape, axis_names


def flat_index(shape: dict, axis_names: tuple, coords: dict) -> int:
    """The row-major index of the shard at ``coords`` (axis name ->
    index; an axis left out is index 0) on a mesh of ``shape`` (axis name
    -> size)."""
    flat = 0
    for name in axis_names:
        i = coords.get(name, 0)
        if not 0 <= i < shape[name]:
            raise IndexError(f"{name}={i} outside mesh {shape}")
        flat = flat * shape[name] + i
    return flat


def default_devices(n: int) -> list[str]:
    """One device a shard for ``n`` shards: shard ``i`` on
    ``cuda:{i % torch.cuda.device_count()}``. Without a card, ``"cuda"``
    for every shard (which :class:`ShardMesh` refuses)."""
    cards = torch.cuda.device_count()
    if cards == 0:
        return ["cuda"] * n
    return [f"cuda:{i % cards}" for i in range(n)]


class ShardMesh:
    """A named grid of shards, each on a torch device.

    ``shape`` gives the number of shards along each of ``axis_names``;
    ``devices`` lists one device per shard in row-major order over the
    axes (default: :func:`default_devices`, the cards present in turn, so
    a mesh runs on the cards unless the caller asks for ``"cpu"``). A
    CUDA device without a card raises here, not at the first launch.
    """

    def __init__(self, shape, axis_names, devices=None):
        shape, axis_names = check_mesh(shape, axis_names)
        n = math.prod(shape)
        devices = default_devices(n) if devices is None else list(devices)
        if len(devices) != n:
            raise ValueError(f"mesh {shape} has {n} shards; got "
                             f"{len(devices)} devices")
        self.shape = dict(zip(axis_names, shape))
        self.axis_names = axis_names
        self.devices = tuple(require_device(d) for d in devices)

    def device(self, **coords: int) -> torch.device:
        """The device of the shard at ``coords`` (axis name -> index; an
        axis left out is index 0)."""
        return self.devices[flat_index(self.shape, self.axis_names, coords)]

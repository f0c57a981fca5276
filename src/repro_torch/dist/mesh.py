"""An in-process mesh of shards, the port's counterpart of a jax ``Mesh``.

The reference's distributed executor is single-controller SPMD: one
program, ``shard_map`` over a ``jax.sharding.Mesh``, halos moved with
``ppermute``. Its counterpart here is one process that holds every
shard, each on a torch device from a list, with the halos moved between
the shard tensors by ``copy_``. Several shards may share one device
(four shards on one card run the exchange, the masked kernels and the
overlap split for real, on one card's memory); a multi-process transport
(``torch.distributed``, one process a card) is not built.

:class:`ShardMesh` answers what the executor reads of a mesh:
``.shape[axis]``, ``.axis_names``, and the device of a shard.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.stencil import require_device


class ShardMesh:
    """A named grid of shards, each on a torch device.

    ``shape`` gives the number of shards along each of ``axis_names``;
    ``devices`` lists one device per shard in row-major order over the
    axes (default: ``"cuda"`` for every shard, so a mesh runs on the card
    unless the caller asks for ``"cpu"``). A CUDA device without a card
    raises here, not at the first launch.
    """

    def __init__(self, shape, axis_names, devices=None):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names) or not shape:
            raise ValueError(f"mesh shape {shape} needs one name an axis; "
                             f"got {axis_names}")
        if min(shape) < 1 or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh {shape} over {axis_names}: sizes must "
                             f"be >= 1 and names distinct")
        n = math.prod(shape)
        devices = ["cuda"] * n if devices is None else list(devices)
        if len(devices) != n:
            raise ValueError(f"mesh {shape} has {n} shards; got "
                             f"{len(devices)} devices")
        self.shape = dict(zip(axis_names, shape))
        self.axis_names = axis_names
        self.devices = tuple(require_device(d) for d in devices)

    def device(self, **coords: int) -> torch.device:
        """The device of the shard at ``coords`` (axis name -> index; an
        axis left out is index 0)."""
        flat = 0
        for name in self.axis_names:
            i = coords.get(name, 0)
            if not 0 <= i < self.shape[name]:
                raise IndexError(f"{name}={i} outside mesh {self.shape}")
            flat = flat * self.shape[name] + i
        return self.devices[flat]


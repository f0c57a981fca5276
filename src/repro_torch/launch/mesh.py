"""Production meshes (twin of ``repro.launch.mesh``), as
:class:`~repro_torch.dist.mesh.ShardMesh` es.

:func:`make_production_mesh` is the dry run's mesh: 16 x 16 (one pod of
256 chips) or 2 x 16 x 16 over ``("pod", "data", "model")``, its shards
on the ``meta`` device, so it holds no storage and asks for no card: the
sharding rules read only its shape. :func:`make_mesh` is any mesh over
real devices (the cards present, shard ``i`` on card ``i % count``,
unless the caller asks for the CPU), as the reference's takes
``jax.devices()[:n]``.

The partitioned program runs on a ``DeviceMesh``
(:func:`production_device_mesh`, :func:`make_device_mesh`), whose
dimension names are the axes. Counting it on ``meta``, the production
mesh stands over PyTorch's ``fake`` process group
(``torch.testing._internal.distributed.fake_pg``): this process is rank
0 of 256 (``pod``) or 512 (``multipod``) ranks that exist only as a
world size, so DTensor runs rank 0's local program and its collectives
run no communication. A process holds one default group, so
:func:`fake_group` makes it for the length of a ``with`` block and
destroys it after: the dry run counts each cell in a group of its own
(256 ranks for ``pod``, 512 for ``multipod``, one process for both). A
group that is already initialized is refused (a real one, ``gloo`` or
``nccl``, is never replaced). A PyTorch without the fake group's module
raises with the import's message: there is no even split to fall back
on.
"""
from __future__ import annotations

import contextlib
import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.dist.mesh import ShardMesh

#: The production meshes: ``name -> (shape, axis names)``.
PRODUCTION = {"pod": ((16, 16), ("data", "model")),
              "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False) -> ShardMesh:
    """16x16 (one pod, 256 chips) or 2x16x16 (two pods), every shard on
    ``meta`` (shapes only)."""
    shape, axes = PRODUCTION["multipod" if multi_pod else "pod"]
    return ShardMesh(shape, axes, ["meta"] * math.prod(shape))


@contextlib.contextmanager
def fake_group(world_size: int):
    """This process as rank 0 of a ``fake`` default group of
    ``world_size`` ranks for the ``with`` block (see the module note)."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(f"the partitioned count needs PyTorch's fake "
                           f"process group: {e}") from e
    if dist.is_initialized():
        raise RuntimeError(f"a {dist.get_backend()} process group is "
                           f"initialized; a fake group needs the process's "
                           f"default group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_device_mesh(shape: tuple, axes: tuple, device_type: str = "cpu"):
    """A :func:`make_device_mesh` over a fake group of ``prod(shape)``
    ranks, for the ``with`` block."""
    with fake_group(math.prod(shape)):
        yield make_device_mesh(shape, axes, device_type)


def production_device_mesh(*, multi_pod: bool = False,
                           device_type: str = "cpu"):
    """The production mesh as a ``DeviceMesh`` over a fake group of 256
    or 512 ranks (the program's tensors are on ``meta``), ``pod`` and
    ``data`` merged (:func:`make_device_mesh`), for a ``with`` block."""
    shape, axes = PRODUCTION["multipod" if multi_pod else "pod"]
    return fake_device_mesh(shape, axes, device_type)


#: Axes that :func:`make_device_mesh` merges into one mesh dimension.
MERGED = ("pod", "data")


def make_device_mesh(shape: tuple, axes: tuple,
                     device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` over ``axes`` on the default group,
    which the caller has initialized (``gloo``/``nccl``, or
    :func:`fake_group`) with ``prod(shape)`` ranks.

    Where ``axes`` hold both ``pod`` and ``data`` (adjacent, in that
    order), they are one mesh dimension of ``pod x data`` ranks, named
    ``"pod.data"``; ``mesh.axes_of`` maps each axis to its dimension and
    size (``dist.sharding.mesh_axes``). The rule tables only ever split
    a dimension over both together, and XLA runs a collective over both
    as one group, where DTensor would issue one a mesh dimension (and
    plans a re-layout over three mesh dimensions by a search that does
    not finish at the production shapes)."""
    if not dist.is_initialized():
        raise RuntimeError("make_device_mesh needs an initialized default "
                           "process group")
    shape, axes = tuple(shape), tuple(axes)
    if not all(a in axes for a in MERGED):
        return init_device_mesh(device_type, shape, mesh_dim_names=axes)
    i = axes.index(MERGED[0])
    if axes[i:i + len(MERGED)] != MERGED:
        raise ValueError(f"axes {axes}: {MERGED} must be adjacent")
    n = len(MERGED)
    dims = shape[:i] + (math.prod(shape[i:i + n]),) + shape[i + n:]
    names = axes[:i] + (".".join(MERGED),) + axes[i + n:]
    mesh = init_device_mesh(device_type, dims, mesh_dim_names=names)
    mesh.axes_of = {a: (k if k < i else max(i, k - n + 1), s)
                    for k, (a, s) in enumerate(zip(axes, shape))}
    return mesh


def make_mesh(shape: tuple, axes: tuple, devices=None) -> ShardMesh:
    """A mesh of ``shape`` over ``axes``; ``devices`` lists one device a
    shard (default: :func:`repro_torch.dist.mesh.default_devices`, shard
    ``i`` on ``cuda:{i % device_count()}``)."""
    return ShardMesh(shape, axes, devices)

"""One process a card: the distributed stencil over ``torch.distributed``.

No file of the reference stands for this module. The reference's
distributed stencil is one SPMD program: ``shard_map`` over a mesh, the
halos moved by ``ppermute`` (``src/repro/dist/stencil.py``'s exchange),
which XLA turns into device-to-device sends inside one cached launch.
:class:`~repro_torch.dist.mesh.ShardMesh` is the port's single-process
counterpart, one host thread issuing every shard's work; here each rank
of a process group holds one shard on its own card and the halos move as
point-to-point messages:

* every rank runs the same ``engine.run_distributed`` call on the same
  global grid (an SPMD script under ``torchrun``), cuts its own shard and
  builds its own extended block, Dirichlet bands and pin mask;
* each round's exchange goes phase by phase, as in one process: rows,
  then the columns of the row-extended block (the corners ride the
  column phase). A phase is one ``batch_isend_irecv`` of packed
  contiguous strips (:func:`~repro_torch.dist.stencil._halo_strips`, the
  views the in-process exchange copies), unpacked into the block. The
  pack buffers are made once a depth;
* under NCCL the strips are CUDA tensors. gloo takes CPU tensors only, so
  a CUDA rank stages its strips through pinned host buffers;
* at the end every rank all-gathers the shards into the full grid,
  ``engine.run``'s return contract.

The caller names the backend (``init_process_group``); nothing switches by
itself. NCCL takes one rank a card: ranks that share a card raise and are
told to use gloo.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import os
import tempfile
from typing import Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.decomp import check_divisible
from repro_torch.core.stencil import require_device
from repro_torch.dist.mesh import check_mesh, flat_index
from repro_torch.dist.stencil import _halo_strips

BACKENDS = ("nccl", "gloo")


def rank_coords(shape, rank: int) -> tuple:
    """The shard coordinates of ``rank`` on a mesh of ``shape``, row-major
    (the last axis fastest), as :class:`ShardMesh` orders its devices."""
    coords = []
    for size in reversed(tuple(shape)):
        rank, i = divmod(rank, size)
        coords.append(i)
    return tuple(reversed(coords))


def rank_device() -> torch.device:
    """This rank's card: ``cuda:{LOCAL_RANK % device_count()}`` (the
    group rank when ``LOCAL_RANK`` is unset); without a card it raises."""
    cards = torch.cuda.device_count()
    if cards == 0:
        require_device("cuda")  # raises, naming device="cpu"
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device(f"cuda:{local % cards}")


def check_backend(backend: str, device: torch.device, local_ranks: int,
                  cards: int) -> None:
    """Refuse what a backend cannot carry: NCCL moves CUDA tensors, one
    rank a card, so a rank on the CPU or ``local_ranks`` ranks on fewer
    cards raise. gloo carries either."""
    if backend not in BACKENDS:
        raise ValueError(f"the process transport runs over {BACKENDS}; got "
                         f"{backend!r}")
    if backend != "nccl":
        return
    if device.type != "cuda":
        raise ValueError(f"NCCL moves CUDA tensors; a rank on {device} "
                         f"takes the gloo backend")
    if local_ranks > cards:
        raise ValueError(f"NCCL takes one rank a card: {local_ranks} ranks "
                         f"share {cards} card(s) on this host; use the gloo "
                         f"backend (halos staged through host memory) or "
                         f"start one rank a card")


class ProcessMesh:
    """A named grid of ranks of a ``torch.distributed`` process group, one
    shard a rank.

    ``shape`` gives the ranks along each of ``axis_names``; the world size
    of ``group`` (default: the default group, which must be initialized)
    must be ``prod(shape)``. Rank ``k`` holds the shard at
    :func:`rank_coords` ``(shape, k)``. This rank's device is
    :func:`rank_device` (its card), or ``device`` when the caller names
    one (``"cpu"`` for the plain versions). At construction every rank
    learns every rank's device (one ``all_gather_object``), so
    ``.devices`` and ``.device(**coords)`` answer as a
    :class:`~repro_torch.dist.mesh.ShardMesh`'s do, and the backend is
    checked (:func:`check_backend`) before any message moves.

    Its entry point is ``engine.run_distributed(u, spec, mesh=...)``,
    called by every rank with the same arguments.
    """

    def __init__(self, shape, axis_names, group=None, device=None):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("ProcessMesh needs an initialized process "
                               "group: call torch.distributed."
                               "init_process_group first")
        shape, axis_names = check_mesh(shape, axis_names)
        world = dist.get_world_size(group)
        if math.prod(shape) != world:
            raise ValueError(f"mesh {shape} has {math.prod(shape)} shards; "
                             f"the process group has {world} ranks")
        self.group = group
        self.backend = str(dist.get_backend(group))
        self.rank = dist.get_rank(group)
        self.shape = dict(zip(axis_names, shape))
        self.axis_names = axis_names
        self.coords = dict(zip(axis_names, rank_coords(shape, self.rank)))
        here = (rank_device() if device is None
                else require_device(device))
        check_backend(self.backend, here, int(os.environ.get(
            "LOCAL_WORLD_SIZE", world)), torch.cuda.device_count())
        self.device_here = here
        names = [None] * world
        with _current(here):
            dist.all_gather_object(names, str(here), group=group)
        self.devices = tuple(torch.device(n) for n in names)

    def rank_of(self, **coords: int) -> int:
        """The group rank holding the shard at ``coords`` (an axis left
        out is index 0)."""
        return flat_index(self.shape, self.axis_names, coords)

    def device(self, **coords: int) -> torch.device:
        """The device of the shard at ``coords``."""
        return self.devices[self.rank_of(**coords)]

    def global_rank(self, rank: int) -> int:
        """The default group's rank of this group's ``rank`` (what
        point-to-point ops address)."""
        return rank if self.group is None else dist.get_global_rank(
            self.group, rank)


def _current(device: torch.device):
    """``device`` made current when it is a card (NCCL's collectives run
    on the current device); else nothing."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _wire(mesh: ProcessMesh, like: torch.Tensor, shape) -> torch.Tensor:
    """A buffer of ``shape`` the backend sends from or receives into: on
    the rank's card under NCCL; in (pinned, for a card) host memory under
    gloo."""
    if mesh.backend == "nccl":
        return torch.empty(shape, dtype=like.dtype, device=like.device)
    return torch.empty(shape, dtype=like.dtype, device="cpu",
                       pin_memory=like.is_cuda)


class _RankHalos:
    """This rank's exchange into one extended block ``ext``: per phase,
    pack the strips its neighbours need, one ``batch_isend_irecv``, unpack
    what arrived. ``phases`` hold ``(peer global rank, recv slices, send
    slices)`` and ``bufs`` one ``(send, recv)`` buffer pair a strip."""

    def __init__(self, mesh: ProcessMesh, ext: torch.Tensor, phases, bufs):
        self.mesh, self.ext, self.phases, self.bufs = mesh, ext, phases, bufs

    def __call__(self) -> None:
        with _current(self.ext.device):
            for i, strips in enumerate(self.phases):
                if strips:
                    self.pack(i)
                    self.post(i)
                    self.unpack(i)

    def pack(self, i: int) -> None:
        """Copy phase ``i``'s outgoing strips into their send buffers."""
        for (_, _, send), (sbuf, _) in zip(self.phases[i], self.bufs[i]):
            sbuf.copy_(self.ext[send])

    def post(self, i: int) -> None:
        """Send phase ``i``'s buffers and receive the neighbours', in one
        ``batch_isend_irecv``; return when all have arrived."""
        ops = []
        for (peer, _, _), (sbuf, rbuf) in zip(self.phases[i], self.bufs[i]):
            ops += [dist.P2POp(dist.isend, sbuf, peer, self.mesh.group),
                    dist.P2POp(dist.irecv, rbuf, peer, self.mesh.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    def unpack(self, i: int) -> None:
        """Copy phase ``i``'s arrived strips into the block's halo."""
        for (_, recv, _), (_, rbuf) in zip(self.phases[i], self.bufs[i]):
            self.ext[recv].copy_(rbuf)


@dataclasses.dataclass(frozen=True)
class RankLayout:
    """This rank's place in a ``px x py`` split of a ``(Hi, Wi)`` interior
    over a :class:`ProcessMesh`: the shard at ``(ix, iy)``, rows
    ``ix*hl:(ix+1)*hl`` and columns ``iy*wl:(iy+1)*wl``, on ``device``.
    The stencil executor's layout interface (``split``, ``positions``,
    ``exchanger``, ``join_into``), as the in-process one has it."""

    mesh: ProcessMesh
    px: int
    py: int
    hl: int
    wl: int
    ix: int
    iy: int
    row_axis: str | None
    col_axis: str | None

    @classmethod
    def of(cls, mesh: ProcessMesh, row_axis: str | None,
           col_axis: str | None, interior_shape) -> "RankLayout":
        px = mesh.shape[row_axis] if row_axis else 1
        py = mesh.shape[col_axis] if col_axis else 1
        if px * py != math.prod(mesh.shape.values()):
            raise ValueError(f"a process mesh splits over all its ranks: "
                             f"axes ({row_axis}, {col_axis}) of "
                             f"{mesh.shape} hold {px * py}")
        hi, wi = interior_shape
        check_divisible(hi, wi, px, py)
        return cls(mesh, px, py, hi // px, wi // py,
                   mesh.coords.get(row_axis, 0), mesh.coords.get(col_axis, 0),
                   row_axis, col_axis)

    def _rank(self, ix: int, iy: int) -> int:
        coords = {a: i for a, i in ((self.row_axis, ix), (self.col_axis, iy))
                  if a}
        return self.mesh.rank_of(**coords)

    def _block(self, ix: int, iy: int) -> tuple[slice, slice]:
        return (slice(ix * self.hl, (ix + 1) * self.hl),
                slice(iy * self.wl, (iy + 1) * self.wl))

    @property
    def positions(self) -> list:
        """The ``(ix, iy)`` of the one shard this rank holds."""
        return [(self.ix, self.iy)]

    def split(self, interior: torch.Tensor) -> list:
        """This rank's block of ``interior``, on its device."""
        rs, cs = self._block(self.ix, self.iy)
        return [interior[rs, cs].to(self.mesh.device_here)]

    def exchanger(self, d: int) -> Callable:
        """``exts`` (this rank's one block) -> its exchange at depth
        ``d``; the pack buffers are made once and shared by the blocks a
        depth swaps between."""
        phases = [[(self.mesh.global_rank(self._rank(*peer)), recv, send)
                   for peer, recv, send in strips]
                  for strips in _halo_strips(self.ix, self.iy, px=self.px,
                                             py=self.py, hl=self.hl,
                                             wl=self.wl, d=d)]
        bufs = []

        def make(exts):
            ext, = exts
            if not bufs:
                for strips in phases:
                    bufs.append([tuple(_wire(self.mesh, ext,
                                             ext[send].shape)
                                       for _ in range(2))
                                 for _, _, send in strips])
            return _RankHalos(self.mesh, ext, phases, bufs)
        return make

    def join_into(self, out: torch.Tensor, shards) -> torch.Tensor:
        """All-gather every rank's shard and assign each into its block of
        ``out`` (on every rank); return ``out``."""
        mine, = shards
        mine = mine.contiguous()
        if self.mesh.backend != "nccl":
            mine = mine.cpu()
        parts = [torch.empty_like(mine) for _ in self.mesh.devices]
        with _current(self.mesh.device_here):
            dist.all_gather(parts, mine, group=self.mesh.group)
        for ix in range(self.px):
            for iy in range(self.py):
                rs, cs = self._block(ix, iy)
                out[rs, cs] = parts[self._rank(ix, iy)]
        return out


def spawn(fn: Callable, world: int, *args, backend: str = "gloo",
          timeout_s: float = 300.0) -> None:
    """Run ``fn(rank, *args)`` in ``world`` new processes, each rank
    ``rank`` of a process group over ``backend``, without a launcher and
    without a TCP port: the ranks meet through a ``FileStore`` in a
    temporary directory. Each process sees ``RANK``, ``LOCAL_RANK``,
    ``WORLD_SIZE`` and ``LOCAL_WORLD_SIZE`` as ``torchrun`` sets them on
    one host; under NCCL its card is made current. ``fn`` must be
    importable (a module-level function). A rank that raises makes this
    raise, after the other processes are stopped; a collective that
    waits longer than ``timeout_s`` raises in its rank."""
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(
            _rank_main, nprocs=world,
            args=(fn, world, backend, os.path.join(tmp, "store"), timeout_s,
                  args))


def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               store: str, timeout_s: float, args: tuple) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()

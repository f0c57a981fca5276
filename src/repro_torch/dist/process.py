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

The sharded LM pieces (``dist.sharding``, ``dist.pipeline``,
``core.ssm_sp``, ``train.compression``, ``train.fault``) move their data
with the reference's collectives along a mesh axis, here on this rank's
tensor: :func:`ppermute` (one ``batch_isend_irecv``), :func:`all_gather`
and :func:`psum` (an all-gather, then a sum in axis order, so that it is
bit for bit the in-process pieces' sum in replica order; an
``all_reduce`` sums in its backend's own order). Each runs over the
subgroup of this rank's line along the axis, which the mesh builds at
construction.

The caller names the backend (``init_process_group``); nothing switches by
itself. NCCL takes one rank a card: ranks that share a card raise and are
told to use gloo. A process-mesh call with no process group raises; a
collective that fails raises in its rank.
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


def axis_lines(shape, axis_names) -> list[tuple[str, tuple[int, ...]]]:
    """Every line of shards along every axis of a mesh of ``shape``, in the
    order a :class:`ProcessMesh` creates their subgroups: axis by axis,
    and along one axis the lines by their first shard's row-major index;
    each line the shards' indices in axis order."""
    sizes = dict(zip(axis_names, shape))
    lines = []
    for axis in axis_names:
        for k in range(math.prod(shape)):
            coords = dict(zip(axis_names, rank_coords(shape, k)))
            if coords[axis] == 0:
                lines.append((axis, tuple(
                    flat_index(sizes, axis_names, {**coords, axis: i})
                    for i in range(sizes[axis]))))
    return lines


class ProcessMesh:
    """A named grid of ranks of a ``torch.distributed`` process group, one
    shard a rank.

    ``shape`` gives the ranks along each of ``axis_names``. ``ranks`` lists
    the default group's ranks the mesh spans, increasing (default: all of
    them); the shard at row-major index ``k`` (:func:`rank_coords`) is on
    ``ranks[k]``. Every rank of the default group constructs the mesh,
    members or not, since it creates process groups: one over ``ranks``
    (unless they are the whole world) and one for every line of ranks
    along every axis (:func:`axis_lines`), in the same order on every
    rank. A rank outside ``ranks`` gets ``rank`` None and holds no shard
    (an elastic scale-down's dropped ranks).

    A member's device is :func:`rank_device` (its card), or ``device``
    when the caller names one (``"cpu"`` for the plain versions). At
    construction every member learns every member's device (one
    ``all_gather_object``), so ``.devices`` and ``.device(**coords)``
    answer as a :class:`~repro_torch.dist.mesh.ShardMesh`'s do, and the
    backend is checked (:func:`check_backend`) before any message moves.

    Its entry points are ``engine.run_distributed(u, spec, mesh=...)`` and
    the sharded LM pieces, called by every rank with the same arguments.
    """

    def __init__(self, shape, axis_names, ranks=None, device=None):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("ProcessMesh needs an initialized process "
                               "group: call torch.distributed."
                               "init_process_group first")
        shape, axis_names = check_mesh(shape, axis_names)
        world = dist.get_world_size()
        every = tuple(range(world))
        ranks = every if ranks is None else tuple(int(r) for r in ranks)
        if math.prod(shape) != len(ranks):
            raise ValueError(f"mesh {shape} has {math.prod(shape)} shards; "
                             f"the process group has {len(ranks)} ranks")
        if list(ranks) != sorted(set(ranks)) or not set(ranks) <= set(every):
            raise ValueError(f"a mesh spans increasing ranks of the "
                             f"{world}-rank group; got {ranks}")
        self.ranks = ranks
        self.group = None if ranks == every else dist.new_group(list(ranks))
        self.backend = str(dist.get_backend())
        me = dist.get_rank()
        self.rank = ranks.index(me) if me in ranks else None
        self.shape = dict(zip(axis_names, shape))
        self.axis_names = axis_names
        self.lines = {}
        for axis, line in axis_lines(shape, axis_names):
            group = dist.new_group([ranks[k] for k in line])
            if self.rank in line:
                self.lines[axis] = group
        if self.rank is None:
            self.coords, self.device_here, self.devices = None, None, ()
            return
        self.coords = dict(zip(axis_names, rank_coords(shape, self.rank)))
        here = (rank_device() if device is None
                else require_device(device))
        check_backend(self.backend, here, int(os.environ.get(
            "LOCAL_WORLD_SIZE", world)), torch.cuda.device_count())
        self.device_here = here
        names = [None] * len(ranks)
        with _current(here):
            dist.all_gather_object(names, str(here), group=self.group)
        self.devices = tuple(torch.device(n) for n in names)

    def rank_of(self, **coords: int) -> int:
        """The mesh rank (row-major index) of the shard at ``coords`` (an
        axis left out is index 0)."""
        return flat_index(self.shape, self.axis_names, coords)

    def device(self, **coords: int) -> torch.device:
        """The device of the shard at ``coords``."""
        return self.devices[self.rank_of(**coords)]

    def global_rank(self, rank: int) -> int:
        """The default group's rank of mesh rank ``rank`` (what
        point-to-point ops address)."""
        return self.ranks[rank]

    def line(self, axis: str) -> tuple[int, ...]:
        """The default group's ranks of this rank's line along ``axis``, in
        axis order."""
        return tuple(self.global_rank(self.rank_of(**{**self.coords, axis: i}))
                     for i in range(self.shape[axis]))

    def check_group(self) -> None:
        """Raise unless the process group is up: every call on the mesh
        needs it, and none falls back to one process."""
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("a ProcessMesh call needs an initialized "
                               "process group: call torch.distributed."
                               "init_process_group first")

    def require_member(self) -> None:
        """Raise unless the process group is up and this rank holds a
        shard of the mesh: a collective on the mesh needs both."""
        self.check_group()
        if self.rank is None:
            raise ValueError(f"rank {dist.get_rank()} holds no shard of the "
                             f"mesh over ranks {self.ranks}")


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


def _staged(mesh: ProcessMesh, t: torch.Tensor) -> bool:
    """Whether ``t`` moves through host buffers: gloo carries CPU tensors
    only, so a card's tensor is staged (:func:`_wire`)."""
    return mesh.backend != "nccl" and t.is_cuda


def all_gather(t: torch.Tensor, mesh: ProcessMesh,
               axis: str | None = None) -> list[torch.Tensor]:
    """Every rank's ``t`` along ``axis`` of ``mesh`` (every rank of the
    mesh when None), in axis order (row-major over the mesh), on ``t``'s
    device: the reference's ``jax.lax.all_gather``, unstacked. Every rank
    of the line calls it, each with a tensor of one shape and dtype."""
    mesh.require_member()
    group, n = ((mesh.group, len(mesh.ranks)) if axis is None
                else (mesh.lines[axis], mesh.shape[axis]))
    t = t.contiguous()
    with _current(t.device):
        if not _staged(mesh, t):
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t, group=group)
            return parts
        mine = _wire(mesh, t, t.shape)
        mine.copy_(t)
        parts = [_wire(mesh, t, t.shape) for _ in range(n)]
        dist.all_gather(parts, mine, group=group)
        return [p.to(t.device) for p in parts]


def psum(t: torch.Tensor, mesh: ProcessMesh,
         axis: str | None = None) -> torch.Tensor:
    """The sum of every rank's ``t`` along ``axis``, on every rank of the
    line: the reference's ``jax.lax.psum``. It adds in axis order,
    ``(t0 + t1) + t2 ...`` after an :func:`all_gather`, which is bit for
    bit the in-process pieces' sum in replica order; an ``all_reduce``
    would sum in its backend's own order."""
    parts = all_gather(t, mesh, axis)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def ppermute(t: torch.Tensor, mesh: ProcessMesh, axis: str,
             perm) -> torch.Tensor:
    """This rank's share of the reference's ``jax.lax.ppermute`` along
    ``axis``: ``perm`` lists ``(src, dst)`` axis indices, each at most once
    on either side, and the rank at ``src`` sends ``t`` to the rank at
    ``dst`` of its line; the sends and receives go in one
    ``batch_isend_irecv``. Returns what arrived, or zeros where no pair
    sends to this rank. Every rank of the line calls it with the same
    ``perm`` and a tensor of one shape and dtype."""
    mesh.require_member()
    n = mesh.shape[axis]
    srcs, dsts = [p[0] for p in perm], [p[1] for p in perm]
    if (len(set(srcs)) < len(srcs) or len(set(dsts)) < len(dsts)
            or not all(0 <= i < n for i in srcs + dsts)):
        raise ValueError(f"ppermute over {n} ranks of {axis!r} takes each "
                         f"index at most once a side; got {list(perm)}")
    i, line = mesh.coords[axis], mesh.line(axis)
    to = [line[d] for s, d in perm if s == i]
    frm = [line[s] for s, d in perm if d == i]
    out = torch.zeros(t.shape, dtype=t.dtype, device=t.device)
    if not (to or frm):
        return out
    staged = _staged(mesh, t)
    with _current(t.device):
        if staged:
            sbuf, rbuf = (_wire(mesh, t, t.shape) for _ in range(2))
            sbuf.copy_(t)
        else:
            sbuf, rbuf = t.contiguous(), out
        ops = ([dist.P2POp(dist.isend, sbuf, p, mesh.group) for p in to]
               + [dist.P2POp(dist.irecv, rbuf, p, mesh.group) for p in frm])
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if staged and frm:
            out.copy_(rbuf)
    return out


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
        parts = all_gather(mine, self.mesh)
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

"""Logical-axis sharding: rule tables mapping model axes to mesh axes
(twin of ``repro.dist.sharding``).

Every parameter and cache of the port carries *logical* axis names
(``"embed"``, ``"heads"``, ``"batch"``, ...: ``model.logical_axes()`` and
``model.cache_axes()``); nothing outside this module knows about meshes.
:func:`pspec_for` resolves those names against a mesh through an ordered
rule table (MaxText-style logical-to-physical rules):

* each rule ``(logical_name, mesh_axes)`` is tried in priority order;
* a rule only fires if the dimension size is divisible by the mesh-axis
  extent (the *divisibility fallback*: 2 KV heads can never take a
  16-way ``model`` axis, so a later rule lets the KV-sequence dim pick
  the axis up instead);
* a mesh axis is consumed at most once per array (no axis reuse);
* multi-axis entries like ``("pod", "data")`` shard one dimension over
  several mesh axes and degrade to whatever subset of them the mesh has.

A spec here is a plain tuple with one entry a dimension: ``None``
(unsharded), a mesh axis name, or a tuple of names (major first), the
entries of the reference's ``PartitionSpec``. ``mesh`` needs only a
``.shape`` mapping (a :class:`~repro_torch.dist.mesh.ShardMesh`, or any
object with one).

The partitioned program (the reference's ``jit`` with shardings) runs
on DTensors (``torch.distributed.tensor``) over a ``DeviceMesh`` whose
dimension names are the mesh axes: :func:`placements` turns a spec into
one ``Shard(d)``/``Replicate()`` a mesh dimension, :func:`distribute` and
:func:`distribute_model` lay out the arguments, and DTensor propagates
the layouts op by op, issuing a ``_c10d_functional`` collective where one
must change. Under such a mesh in :func:`use_mesh`, :func:`constrain`
redistributes an activation to ``pspec_for(axes, ACT_RULES)``'s layout,
at the reference's ``with_sharding_constraint`` sites, and
:func:`on_mesh` puts a tensor that a layer makes (positions, rope tables,
masks, carries) on the mesh, replicated. Without a ``DeviceMesh`` both
return their input untouched: the single-card paths and the in-process
meshes (``ShardMesh``, ``ProcessMesh``, which read the specs themselves:
``kernels.ops.flash_attention``, ``train.fault.remesh_state``) never see
a DTensor.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Optional, Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.dist.process import ProcessMesh, all_gather

Axes = Sequence[Optional[str]]
Rules = tuple[tuple[str, Any], ...]
Spec = tuple

#: Weight / train-state layout: FSDP shards the embed (contraction) dim
#: over data(/pod), tensor parallelism shards head/mlp/vocab dims, expert
#: parallelism shards the expert dim. ``kv_seq`` entries are fallbacks.
DEFAULT_RULES: Rules = (
    ("expert", "model"),
    ("embed", ("pod", "data")),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("mlp", "model"),
    ("vocab", "model"),
    ("ssm_inner", "model"),
    ("batch", ("pod", "data")),
    ("kv_seq", "model"),
    ("kv_seq", ("pod", "data")),
)

#: Activation layout: KV heads take the model axis when they divide it,
#: otherwise the GQA group (query-head) dim, otherwise the query-sequence
#: dim (context parallelism as the last resort). Batch rides data.
ACT_RULES: Rules = (
    ("kv_heads", "model"),
    ("heads", "model"),
    ("expert", "model"),
    ("mlp", "model"),
    ("ssm_inner", "model"),
    ("vocab", "model"),
    ("batch", ("pod", "data")),
    ("qseq", "model"),
    ("kv_seq", "model"),
    ("qseq", ("pod", "data")),
)


def pspec_for(axes: Axes, shape: Sequence[int], mesh,
              rules: Rules | None = None) -> Spec:
    """Resolve logical ``axes`` for an array of ``shape`` to a spec tuple.

    Unknown logical names and ``None`` entries stay unsharded.
    """
    if rules is None:
        rules = DEFAULT_RULES
    if len(axes) != len(shape):
        raise ValueError(f"logical axes {tuple(axes)} do not match array "
                         f"shape {tuple(shape)}")
    mesh_shape = axis_sizes(mesh)
    assigned: list[Any] = [None] * len(axes)
    used: set[str] = set()
    for name, cand in rules:
        cand = cand if isinstance(cand, tuple) else (cand,)
        take = [a for a in cand if a in mesh_shape and a not in used]
        if not take:
            continue
        extent = math.prod(mesh_shape[a] for a in take)
        for i, ax in enumerate(axes):
            if ax == name and assigned[i] is None and shape[i] % extent == 0:
                assigned[i] = tuple(take) if len(take) > 1 else take[0]
                used.update(take)
                break
    return tuple(assigned)


def mesh_axes(mesh: DeviceMesh) -> dict:
    """``{axis name: (mesh dimension, size)}`` of a ``DeviceMesh``: its
    dimension names, or the axes that :func:`repro_torch.launch.mesh.
    make_device_mesh` merged into one dimension (``axes_of``)."""
    got = getattr(mesh, "axes_of", None)
    if got is not None:
        return got
    return {n: (i, s) for i, (n, s) in enumerate(zip(mesh.mesh_dim_names,
                                                     mesh.shape))}


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (:func:`mesh_axes`) or of
    any mesh with a ``.shape`` mapping."""
    if isinstance(mesh, DeviceMesh):
        return {a: s for a, (_, s) in mesh_axes(mesh).items()}
    return dict(mesh.shape)


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry (major first; ``()`` unsharded)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_bytes(shape: Sequence[int], itemsize: int, spec: Spec,
                mesh) -> int:
    """Bytes of one shard of an array of ``shape`` laid out by ``spec``."""
    n = math.prod(shape) * itemsize
    sizes = axis_sizes(mesh)
    for entry in spec:
        n //= math.prod(sizes[a] for a in spec_axes(entry))
    return n


# ---------------------------------------------------------------------------
# DTensor layouts on a DeviceMesh
# ---------------------------------------------------------------------------

def placements(spec: Spec, mesh: DeviceMesh) -> tuple:
    """A spec as DTensor placements: one a mesh dimension, ``Shard(d)``
    where the spec splits tensor dimension ``d`` over it, else
    ``Replicate()``. An entry of several axes (``("pod", "data")``)
    shards its dimension over each of their mesh dimensions, major
    first, which must be the mesh's own order; axes merged into one
    dimension must come together."""
    where = mesh_axes(mesh)
    out = [Replicate()] * mesh.ndim
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        idx = [where[a][0] for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"axis order {tuple(where)}")
        for i in sorted(set(idx)):
            if {a for a in where if where[a][0] == i} - set(axes):
                raise ValueError(f"spec entry {entry} splits part of mesh "
                                 f"dimension {i}")
            out[i] = Shard(d)
    return tuple(out)


def distribute(tree, specs, mesh: DeviceMesh):
    """``tree``'s tensors as DTensors on ``mesh`` laid out by ``specs``
    (mirroring ``tree``: what :func:`tree_shardings`,
    :func:`state_shardings` or :func:`batch_shardings` return); other
    leaves pass through. Every rank holds the whole tensor and keeps its
    own block (no collective: ``src_data_rank=None``)."""
    return _map(lambda x, s: distribute_tensor(
        x, mesh, placements(s, mesh), src_data_rank=None)
        if isinstance(x, torch.Tensor) else x, tree, specs)


def distribute_model(model: torch.nn.Module, mesh: DeviceMesh,
                     rules: Rules | None = None) -> torch.nn.Module:
    """Replace each parameter of ``model`` (in place) by a DTensor laid
    out by ``pspec_for`` of its logical axes (``model.logical_axes()``),
    keeping ``requires_grad``; returns ``model``."""
    axes = model.logical_axes()
    for name, p in list(model.named_parameters()):
        owner, leaf = name.rpartition(".")[::2]
        mod = model.get_submodule(owner)
        spec = pspec_for(axes[name], p.shape, mesh, rules)
        d = distribute_tensor(p.detach(), mesh, placements(spec, mesh),
                              src_data_rank=None)
        setattr(mod, leaf, torch.nn.Parameter(d, requires_grad=
                                              p.requires_grad))
    return model


# ---------------------------------------------------------------------------
# mesh context: sharded wrappers find the active mesh here.
# ---------------------------------------------------------------------------

_MESH_STACK: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Activate ``mesh`` for the sharded kernel wrappers
    (``kernels.ops.flash_attention``) and, a ``DeviceMesh``, for
    :func:`constrain` and :func:`on_mesh`."""
    _MESH_STACK.append(mesh)
    try:
        yield mesh
    finally:
        _MESH_STACK.pop()


def _context_mesh():
    """The innermost active mesh, or None (one device)."""
    return _MESH_STACK[-1] if _MESH_STACK else None


_LOCAL: list = []


@contextlib.contextmanager
def local_blocks():
    """Inside a function that ``local_map`` runs on a rank's blocks: no
    ``DeviceMesh`` is active, so :func:`constrain`, :func:`view` and
    :func:`on_mesh` leave the plain blocks alone."""
    _LOCAL.append(True)
    try:
        yield
    finally:
        _LOCAL.pop()


def _device_mesh():
    """The innermost active mesh if it is a ``DeviceMesh`` (and no
    :func:`local_blocks` is open), else None."""
    mesh = _context_mesh()
    if _LOCAL or not isinstance(mesh, DeviceMesh):
        return None
    return mesh


class _Constrain(torch.autograd.Function):
    """``x`` laid out by ``target``, its gradient too: the transpose of
    a sharding constraint constrains the cotangent alike, so a partial
    gradient is summed here, where DTensor's own backward would let it
    run on as a partial sum (and later split the other operand of a
    product, at the cost of the whole product on every rank)."""

    @staticmethod
    def forward(ctx, x, target):
        ctx.target = target
        return x.redistribute(x.device_mesh, target)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.target), None


def constrain(x: torch.Tensor, axes: Axes, rules: Rules | None = None):
    """The reference's sharding constraint on an activation: under a
    ``DeviceMesh`` in :func:`use_mesh`, the DTensor ``x`` redistributed
    to ``pspec_for(axes, x.shape, mesh, ACT_RULES)``'s placements, and
    its gradient in the backward alike (the collectives DTensor needs
    for it, none if it is laid out so already); otherwise ``x``
    untouched."""
    mesh = _device_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = pspec_for(axes, x.shape, mesh,
                     ACT_RULES if rules is None else rules)
    return _Constrain.apply(x, placements(spec, mesh))


#: The mesh axes that lay out data: a weight split over them is FSDP's.
BATCH_AXES = ("pod", "data")


def gathered(w: torch.Tensor) -> torch.Tensor:
    """A weight as a layer uses it under a ``DeviceMesh``: gathered over
    the batch axes (:data:`BATCH_AXES`, FSDP's all-gather at the use,
    whose backward reduce-scatters the gradient), its tensor- and
    expert-parallel split kept. Without one, ``w`` untouched."""
    mesh = _device_mesh()
    if mesh is None or not isinstance(w, DTensor):
        return w
    batch = {i for a, (i, _) in mesh_axes(mesh).items() if a in BATCH_AXES}
    pl = [Replicate() if i in batch else p
          for i, p in enumerate(w.placements)]
    return w.redistribute(mesh, pl)


def _view_groups(a: Sequence[int], b: Sequence[int]) -> list:
    """The dimensions of shape ``a`` and of shape ``b`` (same count of
    elements) that a view maps onto each other, as ``(in dims, out
    dims)`` groups in order."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        ins, outs, pa, pb = [i], [j], a[i], b[j]
        i, j = i + 1, j + 1
        while pa != pb:
            if pa < pb:
                pa, i = pa * a[i], i + 1
                ins.append(i - 1)
            else:
                pb, j = pb * b[j], j + 1
                outs.append(j - 1)
        out.append((ins, outs))
    return out


def _relayout_view(x: DTensor, shape: list, target: Sequence) -> DTensor:
    """``x`` viewed as ``shape`` and laid out by ``target`` (placements):
    first laid out so that each dimension ``target`` shards comes from
    the leading input dimension of its group (that dimension whole on the
    axis where it cannot), then viewed, then laid out by ``target``."""
    mesh = x.device_mesh
    lead = {}
    for ins, outs in _view_groups(tuple(x.shape), shape):
        big = [d for d in ins if x.shape[d] > 1]
        lead[outs[0]] = big[0] if big else None
    extent: dict = {}
    for m, pl in enumerate(target):
        if isinstance(pl, Shard):
            extent[pl.dim] = extent.get(pl.dim, 1) * mesh.shape[m]
    src = []
    for pl in target:
        d = lead.get(pl.dim) if isinstance(pl, Shard) else None
        ok = d is not None and x.shape[d] % extent[pl.dim] == 0
        src.append(Shard(d) if ok else Replicate())
    return x.redistribute(mesh, src).reshape(shape).redistribute(mesh,
                                                                 target)


class _View(torch.autograd.Function):
    """:func:`_relayout_view` whose backward views the gradient back the
    same way, to the input's layout (a partial sum's gradient
    replicated): DTensor's own view backward meets the same uneven
    splits."""

    @staticmethod
    def forward(ctx, x, shape, target):
        ctx.shape = tuple(x.shape)
        ctx.target = tuple(Replicate() if p.is_partial() else p
                           for p in x.placements)
        return _relayout_view(x, shape, target)

    @staticmethod
    def backward(ctx, gy):
        return _relayout_view(gy, list(ctx.shape), ctx.target), None, None


def view(x: torch.Tensor, shape: Sequence[int], axes: Axes,
         rules: Rules | None = None) -> torch.Tensor:
    """``x.reshape(shape)`` constrained to ``axes`` (:func:`constrain`).

    DTensor views a sharded dimension only where the split falls on the
    leading dimension of the ones it is viewed as, which GSPMD does not
    need; so under a ``DeviceMesh`` the view goes through
    :func:`_relayout_view`, forward and backward: the collectives the
    reference's reshape-then-constrain needs, and no others. Without a
    mesh, ``x.reshape(shape)``."""
    mesh = _device_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x.reshape(shape)
    shape = list(shape)
    if -1 in shape:
        i = shape.index(-1)
        shape[i] = x.numel() // math.prod(d for d in shape if d != -1)
    target = placements(pspec_for(axes, shape, mesh,
                                  ACT_RULES if rules is None else rules),
                        mesh)
    return _View.apply(x, shape, target)


class _SummedGrad(torch.autograd.Function):
    """The identity, whose backward sums a partial gradient (an
    all-reduce): DTensor cannot turn a partial sum into the masked
    partial sum of a vocab-split lookup, but takes a whole one."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if not isinstance(g, DTensor):
            return g
        return g.redistribute(g.device_mesh, [
            Replicate() if p.is_partial() else p for p in g.placements])


def lookup(table: torch.Tensor, ids: torch.Tensor, axes: Axes):
    """``table[ids]``: under a ``DeviceMesh``, ``F.embedding`` on the
    DTensor ``table`` (rows split: each rank looks up the rows it holds,
    a masked partial sum), summed to ``axes``' layout; an index would
    gather the table. Without one, ``table[ids]``."""
    if _device_mesh() is None or not isinstance(table, DTensor):
        return table[ids]
    out = constrain(torch.nn.functional.embedding(ids, table), axes)
    return _SummedGrad.apply(out)


def write_slice(buf: torch.Tensor, dim: int, start: int,
                x: torch.Tensor) -> None:
    """``buf[..., start:start + n, ...] = x`` along ``dim``, in place.

    Of a DTensor ``buf`` split along ``dim`` (a cache's ``kv_seq``), each
    rank writes the part of ``x`` that falls in its own block, from
    ``x`` laid out as ``buf`` but whole along ``dim``: the partitioned
    ``dynamic_update_slice``, where DTensor's own slice assignment would
    gather the whole buffer to write one position."""
    n = x.shape[dim]
    if not isinstance(buf, DTensor):
        buf.narrow(dim, start, n).copy_(x)
        return
    mesh = buf.device_mesh
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
          for p in buf.placements]
    xl = x.redistribute(mesh, pl).to_local()
    local = buf.to_local()
    idx, coord = 0, mesh.get_coordinate()
    for m, p in enumerate(buf.placements):
        if isinstance(p, Shard) and p.dim == dim:
            idx = idx * mesh.shape[m] + coord[m]
    off = idx * local.shape[dim]
    lo, hi = max(start, off), min(start + n, off + local.shape[dim])
    if lo < hi:
        local.narrow(dim, lo - off, hi - lo).copy_(
            xl.narrow(dim, lo - start, hi - lo))


def on_mesh(x: torch.Tensor) -> torch.Tensor:
    """A tensor that a layer makes (the same on every rank: positions,
    rope tables, masks, carries), replicated on the active
    ``DeviceMesh``; without one, ``x`` untouched."""
    mesh = _device_mesh()
    if mesh is None or isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


# ---------------------------------------------------------------------------
# tree-level builders (launchers, remesh, dry run)
# ---------------------------------------------------------------------------

def replicated(mesh) -> Spec:
    """The fully-replicated spec (scalars, metrics)."""
    del mesh
    return ()


def _is_axes(x) -> bool:
    # A logical-axes leaf is a *plain* tuple of names; NamedTuples (cache
    # spec trees) keep recursing as containers.
    return (type(x) is tuple
            and all(e is None or isinstance(e, str) for e in x))


def _map(fn, tree, specs=None):
    """``fn(leaf, spec)`` over ``tree`` (dicts, tuples, NamedTuples and
    lists of tensors and other leaves), ``specs`` mirroring its
    structure (or None)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, None if specs is None else specs[k])
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        sub = [None] * len(tree) if specs is None else specs
        out = [_map(fn, v, s) for v, s in zip(tree, sub)]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, specs)


def tree_shardings(tree, specs, mesh, rules: Rules | None = None):
    """Specs for a tree whose logical axes mirror its structure; a leaf
    that is not a tensor (a cache's int length) is replicated."""
    return _map(lambda x, s: pspec_for(s, x.shape, mesh, rules)
                if isinstance(x, torch.Tensor) else replicated(mesh),
                tree, specs)


def batch_shardings(batch, mesh):
    """Data-parallel layout for an input batch: leading dim over
    data(/pod)."""
    def one(x, _):
        axes = ("batch",) + (None,) * (x.dim() - 1)
        return pspec_for(axes, x.shape, mesh, ACT_RULES)
    return _map(one, batch)


def _flat_axes(specs, prefix=()) -> dict:
    out = {}
    for k, v in specs.items():
        if isinstance(v, dict):
            out.update(_flat_axes(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = tuple(v)
    return out


def _with_paths(fn, tree, keys=()):
    """``fn(keys, leaf)`` over ``tree``, ``keys`` the trailing run of dict
    keys on the leaf's path (a key with dots splits into its parts)."""
    if isinstance(tree, dict):
        return {k: _with_paths(fn, v, keys + tuple(str(k).split(".")))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [_with_paths(fn, v, ()) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return fn(keys, tree)


def state_shardings(state, specs, mesh, rules: Rules | None = None):
    """Specs for a whole train state (parameters + optimizer moments).

    ``specs`` describes the *parameters* only (``model.logical_axes()``,
    keyed by dotted parameter names, or a nested dict); the optimizer's
    moments are keyed as the parameters, so every state leaf is matched
    to its parameter's axes by the trailing run of dict keys on its path
    (``opt_state.mu["layers.0.attn.wq"]`` -> ``specs["layers.0.attn.wq"]``).
    Leaves with no matching spec (the step counter) are replicated.
    """
    by_path = {tuple(".".join(k).split(".")): axes
               for k, axes in _flat_axes(specs).items()}

    def one(keys, x):
        axes = by_path.get(keys)
        if isinstance(x, torch.Tensor) and axes is not None \
                and len(axes) == x.dim():
            return pspec_for(axes, x.shape, mesh, rules)
        return replicated(mesh)

    return _with_paths(one, state)


# ---------------------------------------------------------------------------
# layouts: the blocks of a spec on a ShardMesh or a ProcessMesh
# ---------------------------------------------------------------------------

def _coords(mesh, flat: int) -> dict:
    """The coordinates (axis -> index) of shard ``flat`` (row-major)."""
    out = {}
    for name in reversed(mesh.axis_names):
        flat, out[name] = divmod(flat, mesh.shape[name])
    return out


def block_slices(shape: Sequence[int], spec: Spec, mesh,
                 coords: dict) -> tuple[slice, ...]:
    """The slices of an array of ``shape`` that the shard at ``coords``
    holds under ``spec``: a dimension split over axes ``(a1, a2, ...)``
    (``a1`` major, as a ``PartitionSpec`` entry reads) in equal blocks;
    any other dimension whole."""
    out = []
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    for size, entry in zip(shape, spec):
        idx, n = 0, 1
        for a in spec_axes(entry):
            idx = idx * mesh.shape[a] + coords.get(a, 0)
            n *= mesh.shape[a]
        if size % n:
            raise ValueError(f"dimension {size} does not split {n} ways")
        step = size // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


class Sharded:
    """A tensor laid out on a mesh by ``spec``.

    On a :class:`~repro_torch.dist.mesh.ShardMesh`, ``shards[i]`` is shard
    ``i``'s block (row-major over the mesh's axes), on that shard's
    device. On a :class:`~repro_torch.dist.process.ProcessMesh`,
    ``shards`` holds this rank's block alone (nothing on a rank outside the
    mesh). A dimension the spec leaves unsplit is whole in every shard (a
    replica)."""

    def __init__(self, spec: Spec, shape, shards, mesh):
        self.spec, self.shape = tuple(spec), tuple(shape)
        self.shards, self.mesh = tuple(shards), mesh

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the first block's). On
        a process mesh every rank of it calls this, and the blocks are
        all-gathered."""
        blocks = self.shards
        if isinstance(self.mesh, ProcessMesh):
            self.mesh.require_member()
            blocks = all_gather(blocks[0], self.mesh)
        device = blocks[0].device if device is None else device
        out = torch.empty(self.shape, dtype=blocks[0].dtype, device=device)
        for i, block in enumerate(blocks):
            out[block_slices(self.shape, self.spec, self.mesh,
                             _coords(self.mesh, i))].copy_(block)
        return out


def _held(mesh) -> list:
    """``(flat index, device)`` of each shard this process holds: every
    shard of a ``ShardMesh``, this rank's of a ``ProcessMesh``."""
    if isinstance(mesh, ProcessMesh):
        mesh.check_group()
        return [] if mesh.rank is None else [(mesh.rank, mesh.device_here)]
    return list(enumerate(mesh.devices))


def lay_out(x: torch.Tensor, spec: Spec, mesh) -> Sharded:
    """``x`` laid out on ``mesh`` by ``spec``: each block this process
    holds copied to its device (on a process mesh, this rank's)."""
    shards = []
    for i, dev in _held(mesh):
        blk = x[block_slices(x.shape, spec, mesh, _coords(mesh, i))]
        shards.append(torch.empty(blk.shape, dtype=x.dtype,
                                  device=dev).copy_(blk))
    return Sharded(spec, x.shape, shards, mesh)


def shard_call(fn, mesh, args, in_specs, out_spec):
    """``fn`` run on each shard's blocks of ``args`` on its device, and its
    results put together by ``out_spec``: the in-process ``shard_map``.

    On a ``ShardMesh``, a block that several shards hold alike (the spec
    splits no dimension over some mesh axis) runs once, on the first
    shard that holds it. On a ``ProcessMesh`` every rank runs ``fn`` once,
    on its blocks of the whole ``args`` it was given, and the results are
    all-gathered, so every rank gets the whole result. The result is on
    the first argument's device.
    """
    def slices(i):
        return [block_slices(a.shape, s, mesh, _coords(mesh, i))
                for a, s in zip(args, in_specs)]

    def run(sls, dev):
        return fn(*[torch.empty(a[sl].shape, dtype=a.dtype,
                                device=dev).copy_(a[sl])
                    for a, sl in zip(args, sls)])

    if isinstance(mesh, ProcessMesh):
        mesh.require_member()
        y = run(slices(mesh.rank), mesh.device_here)
        results = list(enumerate(all_gather(y, mesh)))
    else:
        results, done = [], set()
        for i, dev in enumerate(mesh.devices):
            sls = slices(i)
            key = tuple((s.start, s.stop) for sl in sls for s in sl)
            if key not in done:
                done.add(key)
                results.append((i, run(sls, dev)))
    y = results[0][1]
    full = list(y.shape)
    for d, entry in enumerate(out_spec):
        full[d] *= math.prod(mesh.shape[a] for a in spec_axes(entry))
    out = torch.empty(full, dtype=y.dtype, device=args[0].device)
    for i, y in results:
        out[block_slices(out.shape, out_spec, mesh,
                         _coords(mesh, i))].copy_(y)
    return out

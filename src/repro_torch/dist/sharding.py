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

``constrain`` is a no-op: the reference hints GSPMD's partitioner with
``with_sharding_constraint``; the port has no SPMD partitioner to hint.
Code that shards (``kernels.ops.flash_attention``, ``train.fault.
remesh_state``) reads the specs itself.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Optional, Sequence

import torch

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
    mesh_shape = dict(mesh.shape)
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


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry (major first; ``()`` unsharded)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_bytes(shape: Sequence[int], itemsize: int, spec: Spec,
                mesh) -> int:
    """Bytes of one shard of an array of ``shape`` laid out by ``spec``."""
    n = math.prod(shape) * itemsize
    for entry in spec:
        n //= math.prod(mesh.shape[a] for a in spec_axes(entry))
    return n


# ---------------------------------------------------------------------------
# mesh context: sharded wrappers find the active mesh here.
# ---------------------------------------------------------------------------

_MESH_STACK: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Activate ``mesh`` for the sharded kernel wrappers
    (``kernels.ops.flash_attention``)."""
    _MESH_STACK.append(mesh)
    try:
        yield mesh
    finally:
        _MESH_STACK.pop()


def _context_mesh():
    """The innermost active mesh, or None (one device)."""
    return _MESH_STACK[-1] if _MESH_STACK else None


def constrain(x: torch.Tensor, axes: Axes, rules: Rules | None = None):
    """The reference's sharding constraint on an activation: a no-op here,
    with or without a mesh (no SPMD partitioner to hint)."""
    del axes, rules
    return x


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

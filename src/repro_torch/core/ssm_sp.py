"""Sequence parallelism for SSM layers: the stencil discipline on time
(twin of ``repro.core.ssm_sp``).

For sequences too long for one device, the sequence axis is cut into
shards (``dist.sharding.lay_out(x, (None, axis), mesh).shards``), one a
shard of a mesh axis, each on its shard's device, and two pieces of boundary data move between
neighbouring shards, the halo pattern of the distributed Jacobi solver:

  * the depthwise causal conv needs the previous shard's last (K-1)
    tokens: a depth-(K-1) one-sided halo (:func:`conv_halo_exchange`;
    the reference's ``ppermute`` is a ``copy_`` to the next shard's
    device in one process, a message between ranks on a process mesh);
  * the SSD recurrence needs the state at the shard boundary. States
    compose associatively (h' = decay * h + inc with per-shard (decay,
    inc) summaries), so every shard gathers all shards' pairs (the
    reference's ``all_gather``) and takes its inbound state from an
    exclusive **associative scan over shards**
    (:func:`associative_scan`, the reference's log-depth
    ``jax.lax.associative_scan``).

Each shard runs the local chunked SSD once from zero state (outputs and
final local increment); the inbound state's contribution is added in
closed form (state-to-output decay). The reference runs inside
``shard_map`` on one shard's slices. The port's functions take the list
of every shard's tensors and return every shard's result; with
``mesh=`` (a :class:`~repro_torch.dist.process.ProcessMesh`) and
``axis=`` they take and return this rank's shard, as the reference's do.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.dist.process import all_gather, ppermute
from repro_torch.layers.ssm import _f32, ssd_scan


def _shard_decay(dt: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Total decay of a shard: exp(sum_l dt*A). dt (b,l,g,m) -> (b,g,m)."""
    return torch.exp(torch.sum(dt * a, dim=1))


def associative_scan(fn: Callable, elems: tuple) -> tuple:
    """Inclusive scan of ``fn`` over dim 0 of each tensor in ``elems``,
    by the odd/even recursion of ``jax.lax.associative_scan`` (log depth;
    ``fn`` takes and returns tuples of tensors)."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = fn(tuple(e[0:-1:2] for e in elems),
                 tuple(e[1::2] for e in elems))
    odd = associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn(tuple(e[:-1] for e in odd), tuple(e[2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[2::2] for e in elems))
    even = tuple(torch.cat([e[0:1], r]) for e, r in zip(elems, even))
    out = []
    for ev, od in zip(even, odd):
        both = torch.empty((n,) + tuple(ev.shape[1:]), dtype=ev.dtype,
                           device=ev.device)
        both[0::2] = ev
        both[1::2] = od
        out.append(both)
    return tuple(out)


def _combine(lo, hi):
    d1, s1 = lo
    d2, s2 = hi
    return d1 * d2, s2 + s1 * d2[..., None, None]


def _with_inbound(i: int, y_local, inc, dt, a, c, d_all, s_all, dtype):
    """Shard ``i``'s output: its local ``y_local`` plus the contribution
    of its inbound state, from the exclusive scan of every shard's
    (decay, increment) pair ``d_all``, ``s_all`` (stacked in shard
    order, on this shard's device)."""
    dev = y_local.device
    _, s_cum = associative_scan(_combine, (d_all, s_all))
    s_in = torch.zeros_like(inc) if i == 0 else s_cum[i - 1]
    da = dt.to(torch.float32) * a.to(dev)                     # (b, l, g, m)
    da_cs = torch.cumsum(da, dim=1)                           # decay 0 -> t
    contrib = torch.einsum("blgn,bgmpn->blgmp", _f32(c, dtype),
                           _f32(s_in, dtype))
    contrib = contrib * torch.exp(da_cs)[..., None]
    return (y_local.to(torch.float32) + contrib).to(y_local.dtype)


def ssd_sequence_parallel(xs, dts, a: torch.Tensor, bs, cs, chunk: int,
                          dtype=torch.float32, *, mesh=None,
                          axis: str | None = None):
    """Sequence-sharded SSD.

    Shard ``i``: x (b, l_loc, g, m, p); dt (b, l_loc, g, m)
    [post-softplus]; b/c (b, l_loc, g, n); ``a`` (g, m). Without ``mesh``,
    ``xs``, ``dts``, ``bs`` and ``cs`` list every shard's tensors, each on
    its device, and every shard's y (b, l_loc, g, m, p) is returned on its
    device. With a :class:`~repro_torch.dist.process.ProcessMesh` and its
    ``axis``, they are this rank's shard and this rank's y is returned:
    the shards' decays and final states are all-gathered (the
    reference's ``all_gather``) and scanned as in one process.
    """
    if mesh is not None:
        mesh.require_member()
        y_local, inc = ssd_scan(xs, dts, a.to(xs.device), bs, cs, chunk,
                                dtype)
        if mesh.shape[axis] == 1:
            return y_local
        decay = _shard_decay(dts.to(torch.float32), a.to(dts.device))
        d_all = torch.stack(all_gather(decay, mesh, axis))
        s_all = torch.stack(all_gather(inc, mesh, axis))
        return _with_inbound(mesh.coords[axis], y_local, inc, dts, a, cs,
                             d_all, s_all, dtype)
    n = len(xs)
    local = [ssd_scan(x, dt, a.to(x.device), b_, c, chunk, dtype)
             for x, dt, b_, c in zip(xs, dts, bs, cs)]
    if n == 1:
        return [local[0][0]]
    decays = [_shard_decay(dt.to(torch.float32), a.to(dt.device))
              for dt in dts]                                  # (b, g, m)
    out = []
    for i, (x, dt, c) in enumerate(zip(xs, dts, cs)):
        dev = x.device
        y_local, inc = local[i]
        d_all = torch.stack([d.to(dev) for d in decays])      # (S, b, g, m)
        s_all = torch.stack([s.to(dev) for _, s in local])    # (S, b,g,m,p,n)
        out.append(_with_inbound(i, y_local, inc, dt, a, c, d_all, s_all,
                                 dtype))
    return out


def conv_halo_exchange(shards, k: int, *, mesh=None,
                       axis: str | None = None):
    """Prepend to each shard the previous shard's last (k-1) tokens (zeros
    for shard 0), copied to its device.

    Shard (b, l_loc, c) -> (b, l_loc + k - 1, c); a causal conv of the
    extended shard then gives the local l_loc outputs as its last l_loc.
    Without ``mesh``, ``shards`` lists every shard and every extended
    shard is returned. With a :class:`~repro_torch.dist.process.
    ProcessMesh` and its ``axis``, ``shards`` is this rank's shard and its
    extended shard is returned: the tail moves one hop along ``axis`` by
    :func:`~repro_torch.dist.process.ppermute` (the reference's).
    """
    if mesh is not None:
        mesh.require_member()
        n, x = mesh.shape[axis], shards
        if n == 1 or k == 1:
            return F.pad(x, (0, 0, k - 1, 0))
        halo = ppermute(x[:, -(k - 1):, :], mesh, axis,
                        [(i, i + 1) for i in range(n - 1)])
        return torch.cat([halo, x], dim=1)
    n = len(shards)
    if n == 1 or k == 1:
        return [F.pad(x, (0, 0, k - 1, 0)) for x in shards]
    out = []
    for i, x in enumerate(shards):
        if i == 0:
            halo = torch.zeros((x.shape[0], k - 1, x.shape[2]),
                               dtype=x.dtype, device=x.device)
        else:
            tail = shards[i - 1][:, -(k - 1):, :]
            halo = torch.empty(tail.shape, dtype=x.dtype,
                               device=x.device).copy_(tail)
        out.append(torch.cat([halo, x], dim=1))
    return out

"""Sequence parallelism for SSM layers: the stencil discipline on time
(twin of ``repro.core.ssm_sp``).

For sequences too long for one device, the sequence axis is cut into
shards (``dist.sharding.lay_out(x, (None, axis), mesh).shards``), one a
shard of a mesh axis, each on its shard's device, and two pieces of boundary data move between
neighbouring shards, the halo pattern of the distributed Jacobi solver:

  * the depthwise causal conv needs the previous shard's last (K-1)
    tokens: a depth-(K-1) one-sided halo (:func:`conv_halo_exchange`;
    the reference's ``ppermute`` is a ``copy_`` to the next shard's
    device here);
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
``shard_map`` on one shard's slices; the port's functions take the list
of every shard's tensors and return every shard's result.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

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


def ssd_sequence_parallel(xs: Sequence[torch.Tensor],
                          dts: Sequence[torch.Tensor], a: torch.Tensor,
                          bs: Sequence[torch.Tensor],
                          cs: Sequence[torch.Tensor], chunk: int,
                          dtype=torch.float32) -> list[torch.Tensor]:
    """Sequence-sharded SSD over the shards' tensors, each on its device.

    Shard ``i``: x (b, l_loc, g, m, p); dt (b, l_loc, g, m)
    [post-softplus]; b/c (b, l_loc, g, n); ``a`` (g, m). Returns each
    shard's y (b, l_loc, g, m, p) on its device.
    """
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
        _, s_cum = associative_scan(_combine, (d_all, s_all))
        s_in = torch.zeros_like(inc) if i == 0 else s_cum[i - 1]
        da = dt.to(torch.float32) * a.to(dev)                 # (b, l, g, m)
        da_cs = torch.cumsum(da, dim=1)                       # decay 0 -> t
        contrib = torch.einsum("blgn,bgmpn->blgmp", _f32(c, dtype),
                               _f32(s_in, dtype))
        contrib = contrib * torch.exp(da_cs)[..., None]
        out.append((y_local.to(torch.float32) + contrib).to(y_local.dtype))
    return out


def conv_halo_exchange(shards: Sequence[torch.Tensor],
                       k: int) -> list[torch.Tensor]:
    """Prepend to each shard the previous shard's last (k-1) tokens (zeros
    for shard 0), copied to its device.

    Shard (b, l_loc, c) -> (b, l_loc + k - 1, c); a causal conv of the
    extended shard then gives the local l_loc outputs as its last l_loc.
    """
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

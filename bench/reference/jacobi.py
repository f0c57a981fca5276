"""Plain PyTorch Jacobi: the spec's arithmetic, frozen.

A copy of the arithmetic the stencil spec defines (``core/stencil.py``
of both packages), kept here so that no change to the program can move
the yardstick: each sweep sums the taps in f32, in tap order, with one
rounded multiply and one rounded add per tap (no fused multiply-add),
and casts once to the grid's dtype; f32 subnormals flush to zero in the
operand and after every multiply and add, as XLA and the card's kernels
(built with ``-ftz=true``) flush them. The residual is the max-norm of
one sweep's update over the interior, flushed the same way.

It imports neither ``jax``, ``repro`` nor anything of ``repro_torch``,
and takes nothing the program made: a grid in, a grid out.

``arith`` selects the dtype the taps are summed in. ``torch.float32`` is
the spec; ``torch.bfloat16`` is the control, the nearest precision below
the one the configurations state, which the comparison has to refuse.
``store_every`` is how many sweeps the grid is held in ``arith`` before
it is stored in its own dtype again: a bf16 grid's answer depends on it
(the port's fused kernel holds 8 sweeps in f32 a round trip), so the
configuration states it.
"""
from __future__ import annotations

import functools
import math
import struct

import torch

F32_TINY = torch.finfo(torch.float32).tiny
#: An exact product below this flushes (the product rounded to 24 bits
#: with an unbounded exponent decides, as on the card and in XLA).
MUL_FLUSH_BELOW = float(F32_TINY) - 2.0 ** -151


def f32(w: float) -> float:
    """``w`` rounded to the nearest f32, as a Python float."""
    return struct.unpack("f", struct.pack("f", w))[0]


def _f32_step(x: float, units: int) -> float:
    bits = struct.unpack("I", struct.pack("f", x))[0] + units
    return struct.unpack("f", struct.pack("I", bits))[0]


@functools.lru_cache(maxsize=64)
def flush_magnitude(w: float) -> float:
    """The largest f32 ``|c|`` whose product with ``w`` flushes."""
    aw = abs(w)
    if aw == 0.0:
        return math.inf
    c = f32(min(MUL_FLUSH_BELOW / aw, 3.4e38))
    while c > 0 and c * aw >= MUL_FLUSH_BELOW:
        c = _f32_step(c, -1)
    while _f32_step(c, 1) * aw < MUL_FLUSH_BELOW:
        c = _f32_step(c, 1)
    return c


def ftz(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x.abs() < F32_TINY, torch.zeros_like(x), x)


def _mul_ftz(c: torch.Tensor, w: float) -> torch.Tensor:
    return torch.where(c.abs() <= flush_magnitude(w), torch.zeros_like(c),
                       c * w)


def radius(offsets) -> int:
    return max(abs(c) for off in offsets for c in off)


def _interior(u: torch.Tensor, r: int) -> torch.Tensor:
    return u[..., r:u.shape[-2] - r, r:u.shape[-1] - r]


def sweep(u: torch.Tensor, offsets, weights,
          arith: torch.dtype = torch.float32) -> torch.Tensor:
    """One sweep of a ringed grid ``(..., H, W)``; the ring is copied."""
    r = radius(offsets)
    h, w_ = u.shape[-2:]
    c = ftz(u.to(arith))
    acc = None
    for (dy, dx), w in zip(offsets, weights):
        term = _mul_ftz(c[..., r + dy:h - r + dy, r + dx:w_ - r + dx],
                        f32(w))
        acc = term if acc is None else ftz(acc + term)
    out = u.clone()
    _interior(out, r).copy_(acc.to(u.dtype))
    return out


def residual(u: torch.Tensor, offsets, weights,
             arith: torch.dtype = torch.float32) -> torch.Tensor:
    """``|sweep(u) - u|_inf`` over the interior, in f32, flushed."""
    r = radius(offsets)
    v = sweep(u, offsets, weights, arith)
    d = (ftz(_interior(v, r).to(torch.float32))
         - ftz(_interior(u, r).to(torch.float32))).abs()
    return ftz(d.amax(dim=(-2, -1)))


def run(u: torch.Tensor, offsets, weights, iters: int,
        arith: torch.dtype = torch.float32,
        store_every: int = 1) -> torch.Tensor:
    """``iters`` sweeps. The grid is held in ``arith`` for blocks of
    ``store_every`` sweeps and stored in its own dtype after each block;
    the ``iters % store_every`` sweeps left over are stored one by one."""
    blocks, left = divmod(iters, store_every)
    for _ in range(blocks):
        c = u.to(arith)
        for _ in range(store_every):
            c = sweep(c, offsets, weights, arith)
        u = c.to(u.dtype)
    for _ in range(left):
        u = sweep(u, offsets, weights, arith)
    return u


def run_converged(u: torch.Tensor, offsets, weights, *, tol, max_iters: int,
                  t: int, arith: torch.dtype = torch.float32):
    """Blocks of ``t`` sweeps until the residual after a block is at most
    ``tol`` (never, for ``tol`` None) or ``max_iters // t`` blocks ran.

    Returns ``(grid, iters_done, residual, converged)``; the residual is
    the one after the last block, compared with ``tol`` as a double.
    """
    res = None
    blocks = 0
    for blocks in range(1, max_iters // t + 1):
        u = run(u, offsets, weights, t, arith)
        res = float(residual(u, offsets, weights, arith))
        if tol is not None and res <= tol:
            return u, blocks * t, res, True
    return u, blocks * t, res, False

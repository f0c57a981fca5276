"""Optimizers from scratch: AdamW, Lion, SGD-momentum (twin of
``repro.train.optimizer``).

Trees are dicts of tensors keyed by parameter name. ``opt.init(params)
-> state`` as in the reference; ``opt.update_(grads, state, params) ->
state`` computes the numbers of the reference's ``update`` followed by
``apply_updates`` and writes them in place (the parameters and the
moments; the gradients are scaled in place by the clip), one leaf at a
time, so a step needs no second copy of the model: the port's stand-in
for the reference's donated buffers. Everything that can raise (the
clip's norm, the schedule) runs before the first write.

The maths runs in f32; moments are stored in ``moments_dtype`` (AdamW;
f32 for the others); an update is ``(-lr * u).astype(p.dtype)`` added to
``p``, as the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.dist.sharding import on_mesh

f32 = torch.float32


class OptState(NamedTuple):
    step: torch.Tensor   # int32 scalar on the parameters' device
    mu: Any              # first moment (or momentum): name -> tensor
    nu: Any              # second moment (None for lion/sgd)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable      # params -> OptState
    update_: Callable   # (grads, state, params) -> new state, in place


def _moments_like(tree, dtype=f32):
    # zeros_like: a DTensor parameter's moments take its placements
    return {k: torch.zeros_like(p, dtype=dtype, requires_grad=False)
            for k, p in tree.items()}


def _device(tree) -> torch.device:
    return next(iter(tree.values())).device


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(g.to(f32))) for g in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(grads, max_norm: float):
    norm = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0), norm


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm)."""
    scale, norm = _clip_scale(grads, max_norm)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, norm


def _optimizer(leaf: Callable, moments: tuple, lr: Callable | float,
               max_grad_norm: float | None) -> Optimizer:
    """An optimizer from its per-leaf rule ``leaf(g, m, v, p, t, lr_t) ->
    (update, m', v')`` and the dtypes of its moments (``(mu, nu)``, nu
    None when it keeps none)."""
    lr_fn = lr if callable(lr) else (lambda _: lr)
    mu_dt, nu_dt = moments

    def init(params):
        step = torch.zeros((), dtype=torch.int32, device=_device(params))
        return OptState(step, _moments_like(params, mu_dt),
                        None if nu_dt is None
                        else _moments_like(params, nu_dt))

    def begin(state):
        step = state.step + 1
        lr_t = torch.as_tensor(lr_fn(step), dtype=f32, device=step.device)
        return step, on_mesh(step.to(f32)), on_mesh(lr_t)

    def nu_of(state, k):
        return None if state.nu is None else state.nu[k]

    @torch.no_grad()
    def update_(grads, state, params):
        scale = (None if max_grad_norm is None
                 else _clip_scale(grads, max_grad_norm)[0])
        step, t, lr_t = begin(state)
        for k, p in params.items():
            g = grads[k] if scale is None else grads[k].mul_(
                scale.to(grads[k].dtype))
            u, m, v = leaf(g, state.mu[k], nu_of(state, k), p, t, lr_t)
            state.mu[k].copy_(m)
            if v is not None:
                state.nu[k].copy_(v)
            p.add_(u)
        return OptState(step, state.mu, state.nu)

    return Optimizer(init, update_)


def adamw(lr: Callable | float, b1=0.9, b2=0.95, eps=1e-8,
          weight_decay=0.1, max_grad_norm: float | None = 1.0,
          moments_dtype=f32) -> Optimizer:
    """AdamW. ``moments_dtype=torch.bfloat16`` halves the optimizer
    state; the moment maths still runs in f32."""

    def leaf(g, m, v, p, t, lr_t):
        g = g.to(f32)
        m = b1 * m.to(f32) + (1 - b1) * g
        v = b2 * v.to(f32) + (1 - b2) * g * g
        mhat = m / (1 - b1 ** t)
        vhat = v / (1 - b2 ** t)
        u = mhat / (torch.sqrt(vhat) + eps)
        if weight_decay:
            u = u + weight_decay * p.to(f32)
        return ((-lr_t * u).to(p.dtype), m.to(moments_dtype),
                v.to(moments_dtype))

    return _optimizer(leaf, (moments_dtype, moments_dtype), lr,
                      max_grad_norm)


def lion(lr: Callable | float, b1=0.9, b2=0.99, weight_decay=0.1,
         max_grad_norm: float | None = 1.0) -> Optimizer:

    def leaf(g, m, v, p, t, lr_t):
        g = g.to(f32)
        u = torch.sign(b1 * m + (1 - b1) * g)
        if weight_decay:
            u = u + weight_decay * p.to(f32)
        m_new = b2 * m + (1 - b2) * g
        return (-lr_t * u).to(p.dtype), m_new, None

    return _optimizer(leaf, (f32, None), lr, max_grad_norm)


def sgd(lr: Callable | float, momentum=0.9,
        max_grad_norm: float | None = None) -> Optimizer:

    def leaf(g, m, v, p, t, lr_t):
        m_new = momentum * m + g.to(f32)
        return (-lr_t * m_new).to(p.dtype), m_new, None

    return _optimizer(leaf, (f32, None), lr, max_grad_norm)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1):
    """Linear warmup then cosine decay to ``floor * peak_lr``."""

    def lr(step):
        step = torch.as_tensor(step).to(f32)
        warm = peak_lr * step / max(1, warmup_steps)
        prog = torch.clamp((step - warmup_steps) /
                           max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 *
                         (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)

    return lr

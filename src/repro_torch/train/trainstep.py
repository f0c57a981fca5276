"""Train-step builder: loss and gradients, microbatched gradient
accumulation (twin of ``repro.train.trainstep``).

The reference's state is a functional tree, donated to its jitted step.
The port's :class:`TrainState` holds the model's own parameter tensors
(``dict(model.named_parameters())``) and the optimizer's state; a step
writes them in place (``Optimizer.update_``) and returns the new state
around the same tensors. A step that raises leaves the state untouched:
the forward, the backward, the accumulation, the clip's norm and the
schedule all run before the first write. ``FaultTolerantRunner``'s
retry relies on that, as the reference's does on its pure function.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.train.optimizer import Optimizer


class TrainState(NamedTuple):
    params: Any      # name -> the model's parameter tensor
    opt_state: Any   # OptState


def _check_state(model, params) -> list[str]:
    named = dict(model.named_parameters())
    if set(params) != set(named) or any(params[k] is not named[k]
                                        for k in named):
        raise ValueError("the state's params must be the model's own "
                         "parameters (init_state, or "
                         "interop.train_state_from_jax)")
    return list(named)


def loss_and_grads(model, params, batch, accum_steps: int = 1,
                   accum_dtype=torch.float32):
    """(metrics, grads) of ``model.loss`` on ``batch`` for the parameter
    dict ``params`` (the model's own): with ``accum_steps > 1`` the batch
    is split along its first axis into microbatches whose gradients are
    summed in ``accum_dtype`` and averaged, as are their metrics.
    Non-tensor entries of ``batch`` are ignored."""
    names = _check_state(model, params)
    batch = {k: v for k, v in batch.items() if isinstance(v, torch.Tensor)}

    def one(mb):
        loss, metrics = model.loss(mb)
        grads = torch.autograd.grad(loss.to(torch.float32),
                                    [params[k] for k in names],
                                    allow_unused=True)
        return metrics, {k: torch.zeros_like(params[k]) if g is None else g
                         for k, g in zip(names, grads)}

    if accum_steps == 1:
        return one(batch)
    b = next(iter(batch.values())).shape[0]
    if b % accum_steps:
        raise ValueError(f"batch {b} is not a multiple of accum_steps "
                         f"{accum_steps}")
    grads = {k: torch.zeros_like(params[k], dtype=accum_dtype,
                                 requires_grad=False) for k in names}
    msum = None
    for i in range(accum_steps):
        metrics, g = one({k: microbatch(v, i, accum_steps)
                          for k, v in batch.items()})
        for k in names:
            grads[k] += g[k].to(accum_dtype)
        del g
        if msum is None:
            msum = {k: torch.zeros_like(v, dtype=torch.float32)
                    for k, v in metrics.items()}
        msum = {k: msum[k] + metrics[k] for k in msum}
    for g in grads.values():
        g.div_(accum_steps)
    return {k: m / accum_steps for k, m in msum.items()}, grads


def microbatch(x: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Microbatch ``i`` of ``n`` of ``x`` along its first axis: rows
    ``[i * mb, (i + 1) * mb)``. Of a DTensor, each rank's block's rows
    ``[i * lmb, (i + 1) * lmb)`` (``lmb`` = its rows / ``n``): every
    device keeps its share of every microbatch and no row moves, where
    a global row range would gather the batch; the microbatches hold
    other rows than the unpartitioned split's, and together the same."""
    if isinstance(x, DTensor):
        local = x.to_local()
        lmb = local.shape[0] // n
        return DTensor.from_local(local[i * lmb:(i + 1) * lmb],
                                  x.device_mesh, x.placements,
                                  run_check=False)
    mb = x.shape[0] // n
    return x[i * mb:(i + 1) * mb]


def make_train_step(model, opt: Optimizer, accum_steps: int = 1,
                    accum_dtype=torch.float32):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` is a dict of tensors on the model's device; gradients as
    :func:`loss_and_grads`, then ``opt.update_``.
    """

    def train_step(state: TrainState, batch):
        params, opt_state = state
        metrics, grads = loss_and_grads(model, params, batch, accum_steps,
                                        accum_dtype)
        opt_state = opt.update_(grads, opt_state, params)
        return TrainState(params, opt_state), metrics

    return train_step


def init_state(model, opt: Optimizer) -> TrainState:
    """The train state of ``model``'s parameters as they stand (the
    reference's ``init_state`` also draws them; the port's model is made
    drawn). Sharding specs are the sharded slice's (ROADMAP Queue 1, C2)."""
    params = dict(model.named_parameters())
    return TrainState(params, opt.init(params))

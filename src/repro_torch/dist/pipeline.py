"""Pipeline parallelism: a microbatched GPipe schedule over a mesh axis
(twin of ``repro.dist.pipeline``).

The layer stack is split into ``S`` contiguous stages (:func:`split_stages`);
:func:`pipeline_forward` runs them over the ``"stage"`` axis of a
:class:`~repro_torch.dist.mesh.ShardMesh`, stage ``s`` on that shard's
device. Microbatch ``m`` enters stage 0 at schedule step ``m``, moves one
stage a step, and leaves the last stage at step ``m + S - 1``: the
classic ``M + S - 1``-step fill/drain schedule. The reference rotates the
activations with ``ppermute`` and runs every stage every step (bubble
steps on zeros); here an activation moves to the next stage's device
with ``copy_``, and a stage with no microbatch at a step idles.

``copy_`` and the stage functions are differentiable, so autograd through
the pipelined forward gives the sequential model's gradients.
"""
from __future__ import annotations

from typing import Callable

import torch


def split_stages(params, n_stages: int):
    """Split stacked layer params (leading ``layers`` dim) into ``n_stages``
    equal contiguous stage slabs, ``(L, ...) -> (S, L // S, ...)`` (a dict
    of tensors, as the reference's); a list of layer modules splits into
    ``n_stages`` lists."""
    def check(layers):
        if layers % n_stages:
            raise ValueError(
                f"{layers} layers not divisible into {n_stages} stages")
        return layers // n_stages

    if isinstance(params, (list, torch.nn.ModuleList)):
        per = check(len(params))
        return [list(params[s * per:(s + 1) * per])
                for s in range(n_stages)]
    if isinstance(params, dict):
        return {k: split_stages(v, n_stages) for k, v in params.items()}
    return params.reshape((n_stages, check(params.shape[0]))
                          + tuple(params.shape[1:]))


def _send(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` copied into a new tensor on ``device`` (autograd tracks it)."""
    return torch.empty(t.shape, dtype=t.dtype, device=device).copy_(t)


def _stage(stage_params, s: int, device):
    """Stage ``s``'s parameters on ``device``: a list's ``s``-th entry as
    it is, a tree of stacked tensors' ``s``-th slab moved there."""
    if isinstance(stage_params, list):
        return stage_params[s]
    if isinstance(stage_params, dict):
        return {k: _stage(v, s, device) for k, v in stage_params.items()}
    return stage_params[s].to(device)


def pipeline_forward(stage_fn: Callable, mesh, axis: str = "stage"):
    """Build ``pipe(stage_params, x) -> y`` running ``stage_fn`` as a pipeline.

    ``stage_fn(params_local, h)`` advances one microbatch through one
    stage's layers. ``stage_params`` is a list with one entry a stage, or
    a tree of tensors with a leading stage dim (from :func:`split_stages`);
    ``x`` is ``(n_microbatches, microbatch, ...)`` and the result has the
    same shape with every microbatch through all stages, on ``x``'s
    device.
    """
    n_stages = mesh.shape[axis]
    devices = [mesh.device(**{axis: s}) for s in range(n_stages)]

    def forward(stage_params, x):
        n_micro = x.shape[0]
        inbox: list = [None] * n_stages  # the activation at each stage
        outs: list = [None] * n_micro
        for step in range(n_micro + n_stages - 1):
            # The last stage first: stage s + 1 takes its input before
            # stage s sends the next one.
            for s in reversed(range(n_stages)):
                m = step - s
                if not 0 <= m < n_micro:
                    continue
                h = _send(x[m], devices[0]) if s == 0 else inbox[s]
                out = stage_fn(_stage(stage_params, s, devices[s]), h)
                if s == n_stages - 1:
                    outs[m] = _send(out, x.device)
                else:
                    inbox[s + 1] = _send(out, devices[s + 1])
        return torch.stack(outs)

    return forward

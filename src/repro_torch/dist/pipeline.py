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

On a :class:`~repro_torch.dist.process.ProcessMesh` rank ``s`` holds
stage ``s`` alone and runs the same schedule; each step's activations
move one stage by :func:`~repro_torch.dist.process.ppermute`, as the
reference's do, and the last stage's outputs reach every rank by an
all-gather (the reference's ``psum`` of outputs that are zero but on the
last stage). Its gradients are :class:`_RankStage`'s.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.dist.process import ProcessMesh, all_gather, ppermute


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
    stage's layers, keeping its shape and dtype. On a ``ShardMesh``,
    ``stage_params`` is a list with one entry a stage, or a tree of tensors
    with a leading stage dim (from :func:`split_stages`), and the result is
    on ``x``'s device. On a ``ProcessMesh``, every rank of the ``axis``
    line calls ``pipe`` with its own stage's entry (what ``stage_params[s]``
    would be: a list of modules, or a tree of tensors) and the same ``x``,
    and gets the whole result on its device; every rank must then run its
    backward too. ``x`` is ``(n_microbatches, microbatch, ...)`` and the
    result has the same shape with every microbatch through all stages.
    """
    if isinstance(mesh, ProcessMesh):
        return functools.partial(_rank_pipeline, stage_fn, mesh, axis)
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


def _leaves(tree) -> list:
    """The tensors of a stage (a module's parameters, a tree's tensors)
    that require grad, each once."""
    if isinstance(tree, torch.nn.Module):
        found = list(tree.parameters())
    elif isinstance(tree, dict):
        found = [t for v in tree.values() for t in _leaves(v)]
    elif isinstance(tree, (list, tuple)):
        found = [t for v in tree for t in _leaves(v)]
    else:
        found = [tree] if isinstance(tree, torch.Tensor) else []
    return list({id(t): t for t in found if t.requires_grad}.values())


def _rank_pipeline(stage_fn, mesh, axis, stage_params, x):
    mesh.require_member()
    leaves = _leaves(stage_params)
    track = torch.is_grad_enabled() and (x.requires_grad or bool(leaves))
    return _RankStage.apply(stage_fn, mesh, axis, stage_params, x, track,
                            *leaves)


def _hops(step: int, n_micro: int, n_stages: int, delta: int) -> list:
    """The ``(src, dst)`` stage pairs that pass a microbatch at ``step``:
    each stage ``r`` that holds one (``0 <= step - r < n_micro``) to
    ``r + delta``, where that is a stage."""
    return [(r, r + delta) for r in range(n_stages)
            if 0 <= step - r < n_micro and 0 <= r + delta < n_stages]


class _RankStage(torch.autograd.Function):
    """This rank's stage of a pipeline over a ``ProcessMesh``.

    Forward runs the ``M + S - 1``-step schedule: at each step the stage
    runs its microbatch, if it holds one, with grad recorded into that
    microbatch's own graph (its input a leaf), then one :func:`ppermute`
    hands every stage's output to the next. The last stage's outputs are
    all-gathered and returned on every rank.

    Backward walks the schedule in reverse, the explicit GPipe backward:
    at each step the stage takes the gradient of its microbatch's output,
    back-propagates it through that microbatch's graph, and one
    ``ppermute`` hands the gradient of every stage's input to the stage
    before. The loss is replicated, so every rank holds the same
    gradient of the result; only the last stage feeds it into the graph,
    the others take theirs from the stage after, so it enters once. Rank
    ``s``'s backward therefore waits on rank ``s + 1``'s, and every rank
    must run it. Each parameter's gradients are summed over the
    microbatches from the last to the first, the order in which autograd
    sums them through the in-process pipeline, so the two agree bit for
    bit.
    """

    @staticmethod
    def forward(ctx, stage_fn, mesh, axis, stage_params, x, track, *leaves):
        s, n_stages, n_micro = mesh.coords[axis], mesh.shape[axis], x.shape[0]
        dev = mesh.device_here
        ins, outs = [None] * n_micro, [None] * n_micro
        inbox = None
        for step in range(n_micro + n_stages - 1):
            m = step - s
            if 0 <= m < n_micro:
                h = _send(x[m].detach(), dev) if s == 0 else inbox
                with torch.set_grad_enabled(track):
                    h.requires_grad_(track and (s > 0 or x.requires_grad))
                    out = stage_fn(stage_params, h)
                ins[m], outs[m], sent = h, out, out.detach()
            else:  # a bubble: nothing to pass on
                sent = torch.zeros(x.shape[1:], dtype=x.dtype, device=dev)
            inbox = ppermute(sent, mesh, axis, _hops(step, n_micro,
                                                     n_stages, 1))
        last = (torch.stack([o.detach() for o in outs])
                if s == n_stages - 1 else
                torch.zeros(x.shape, dtype=x.dtype, device=dev))
        ctx.args = (mesh, axis, x.requires_grad, leaves, ins, outs)
        return all_gather(last, mesh, axis)[-1]

    @staticmethod
    def backward(ctx, grad_y):
        mesh, axis, x_grad, leaves, ins, outs = ctx.args
        s, n_stages, n_micro = mesh.coords[axis], mesh.shape[axis], len(outs)
        grads: list = [None] * len(leaves)
        gx = torch.zeros(grad_y.shape, dtype=grad_y.dtype,
                         device=grad_y.device) if s == 0 and x_grad else None
        inbox = None
        for step in reversed(range(n_micro + n_stages - 1)):
            m = step - s
            sent = torch.zeros(grad_y.shape[1:], dtype=grad_y.dtype,
                               device=grad_y.device)  # stage 0, a bubble
            if 0 <= m < n_micro:
                g_out = grad_y[m] if s == n_stages - 1 else inbox
                h = ins[m]
                want = ([h] if h.requires_grad else []) + list(leaves)
                got = list(torch.autograd.grad(outs[m], want, g_out,
                                               allow_unused=True))
                if h.requires_grad:
                    gh = got.pop(0)
                    if s > 0:
                        sent = gh
                    else:
                        gx[m] = gh
                grads = [a if g is None else g if a is None else a + g
                         for a, g in zip(grads, got)]
                ins[m] = outs[m] = None
            inbox = ppermute(sent, mesh, axis, _hops(step, n_micro,
                                                     n_stages, -1))
        return (None, None, None, None, gx, None, *grads)

"""Gradient compression with error feedback (twin of
``repro.train.compression``).

int8 quantization with an f32 scale per leaf, and the error-feedback
state that carries each step's quantization residual to the next
(unbiased in the long run). :func:`compressed_psum` is the data-parallel
all-reduce of the compressed gradients over the replicas of a mesh axis;
the reference calls it inside ``shard_map`` on one replica's gradients.
The port takes every replica's (each on its device) and returns every
replica's result, or, on a process mesh, this rank's replica's.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.dist.process import all_gather


class EFState(NamedTuple):
    residual: Any  # same structure as grads (name -> tensor), f32


def init_ef(params) -> EFState:
    return EFState({k: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for k, p in params.items()})


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded once, on either device, as the reference divides.
    Given a Python number, the CUDA kernel multiplies by ``1 / d`` rounded
    first, which is an ulp off the quotient for some ``x``; a tensor
    divisor on ``x``'s device is divided by on the card as on the CPU."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, f32 scale): ``round(g / scale)`` clipped to
    [-127, 127], ``scale = max|g| / 127 + 1e-12``; rounds half to even
    as ``jnp.round``."""
    scale = _div(torch.max(torch.abs(g)), 127.0) + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _compress(g: torch.Tensor, residual: torch.Tensor, mode: str):
    """One replica's f32 gradient plus residual, and its compressed form:
    ``(g, payload, c)``, where ``payload`` is what crosses the wire
    (``(q, scale)`` for int8, the bf16 values for bf16) and ``c`` what the
    sum adds (the dequantized values, or the bf16 values)."""
    g = g.to(torch.float32) + residual
    if mode == "int8":
        q, scale = quantize_int8(g)
        return g, (q, scale), dequantize_int8(q, scale)
    c = g.to(torch.bfloat16)
    return g, c, c


def _sum_in_order(sent: list) -> torch.Tensor:
    total = sent[0]
    for c in sent[1:]:
        total = total + c.to(total.device)
    return total.to(torch.float32)


def compressed_psum(grads, efs, mode: str = "int8", *, mesh=None,
                    axis: str | None = None):
    """All-reduce replica gradients with compression + error feedback.

    Each replica adds its residual to its f32 gradient and compresses it
    (``"int8"``: quantized and dequantized with its own scale; ``"bf16"``:
    rounded to bf16); the payloads are summed in replica order (in bf16
    for ``"bf16"``) and divided by the replica count. The new residual is
    what compression lost.

    Without ``mesh``, ``grads[r]`` and ``efs[r]`` are replica ``r``'s (name
    -> tensor, on its device); the sum runs on replica 0's device and is
    copied to every replica; returns (each replica's mean gradients, each
    replica's new ``EFState``). With a :class:`~repro_torch.dist.process.
    ProcessMesh` and its data-parallel ``axis``, ``grads`` and ``efs`` are
    this rank's, and this rank's (mean, ``EFState``) is returned: each
    tensor's int8 payload and f32 scale (1 byte a value, where the
    reference's ``psum`` of the dequantized values carries 4), or its bf16
    values, are all-gathered and summed in rank order on every rank, bit
    for bit the in-process sum.
    """
    if mode not in ("int8", "bf16"):
        raise ValueError(mode)
    if mesh is not None:
        mesh.require_member()
        n = mesh.shape[axis]
        mean, res = {}, {}
        for name, grad in grads.items():
            g, payload, c = _compress(grad, efs.residual[name], mode)
            if mode == "int8":
                qs = all_gather(payload[0], mesh, axis)
                scales = all_gather(payload[1].reshape(1), mesh, axis)
                sent = [dequantize_int8(q, s.reshape(()))
                        for q, s in zip(qs, scales)]
            else:
                sent = all_gather(payload, mesh, axis)
            res[name] = g - c.to(torch.float32)
            mean[name] = _div(_sum_in_order(sent), n)
        return mean, EFState(res)
    n = len(grads)
    means: list = [{} for _ in range(n)]
    res: list = [{} for _ in range(n)]
    for name in grads[0]:
        sent = []
        for r in range(n):
            g, _, c = _compress(grads[r][name], efs[r].residual[name], mode)
            res[r][name] = g - c.to(torch.float32)
            sent.append(c)
        total = _sum_in_order(sent)
        for r in range(n):
            dev = grads[r][name].device
            means[r][name] = _div(torch.empty(
                total.shape, dtype=torch.float32, device=dev).copy_(total), n)
    return means, [EFState(r) for r in res]

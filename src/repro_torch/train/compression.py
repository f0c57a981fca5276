"""Gradient compression with error feedback (twin of
``repro.train.compression``).

int8 quantization with an f32 scale per leaf, and the error-feedback
state that carries each step's quantization residual to the next
(unbiased in the long run). :func:`compressed_psum` is the data-parallel
all-reduce of the compressed gradients over the replicas of a mesh axis;
the reference calls it inside ``shard_map`` on one replica's gradients,
the port takes every replica's (each on its device) and returns every
replica's result.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import torch


class EFState(NamedTuple):
    residual: Any  # same structure as grads (name -> tensor), f32


def init_ef(params) -> EFState:
    return EFState({k: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for k, p in params.items()})


def quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, f32 scale): ``round(g / scale)`` clipped to
    [-127, 127], ``scale = max|g| / 127 + 1e-12``; rounds half to even
    as ``jnp.round``."""
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(grads: Sequence[dict], efs: Sequence[EFState],
                    mode: str = "int8") -> tuple[list, list]:
    """All-reduce replica gradients with compression + error feedback.

    ``grads[r]`` and ``efs[r]`` are replica ``r``'s (name -> tensor, on its
    device). Each replica adds its residual to its f32 gradient and
    compresses it (``"int8"``: quantized and dequantized with its own
    scale; ``"bf16"``: rounded to bf16); the payloads are summed in
    replica order on replica 0's device (in bf16 for ``"bf16"``), the sum
    is copied to every replica and divided by the replica count. The new
    residual is what compression lost. Returns (each replica's mean
    gradients, each replica's new ``EFState``).
    """
    if mode not in ("int8", "bf16"):
        raise ValueError(mode)
    n = len(grads)
    means: list = [{} for _ in range(n)]
    res: list = [{} for _ in range(n)]
    for name in grads[0]:
        sent = []
        for r in range(n):
            g = grads[r][name].to(torch.float32) + efs[r].residual[name]
            if mode == "int8":
                c = dequantize_int8(*quantize_int8(g))
            else:
                c = g.to(torch.bfloat16)
            res[r][name] = g - c.to(torch.float32)
            sent.append(c)
        total = sent[0]
        for c in sent[1:]:
            total = total + c.to(total.device)
        total = total.to(torch.float32)
        for r in range(n):
            dev = grads[r][name].device
            means[r][name] = torch.empty(total.shape, dtype=torch.float32,
                                         device=dev).copy_(total) / n
    return means, [EFState(r) for r in res]

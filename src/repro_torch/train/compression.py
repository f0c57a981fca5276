"""Gradient compression with error feedback (twin of
``repro.train.compression``).

int8 quantization with an f32 scale per leaf, and the error-feedback
state that carries each step's quantization residual to the next
(unbiased in the long run). The reference's ``compressed_psum``, the
data-parallel all-reduce of the compressed gradients, belongs to the
sharded slice (ROADMAP Queue 1, C2).
"""
from __future__ import annotations

from typing import Any, NamedTuple

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

"""Plain PyTorch oracles for the kernels (twin of ``repro.kernels.ref``).

Each takes tensors on any device and does the reference oracle's
operations in the same order; the stencil ones are the port's
``apply_stencil`` (subnormals flushed as XLA flushes them).
"""
from __future__ import annotations

import torch

from repro_torch.core.stencil import StencilSpec, apply_stencil, jacobi_2d_5pt
from repro_torch.kernels.conv1d import conv1d_depthwise_causal_plain


def jacobi_step(u: torch.Tensor) -> torch.Tensor:
    """One 5-point Jacobi sweep on a ringed grid (boundary fixed)."""
    return apply_stencil(u, jacobi_2d_5pt())


def jacobi_multi(u: torch.Tensor, t: int) -> torch.Tensor:
    """t consecutive Jacobi sweeps (oracle for the temporal-blocked kernel)."""
    for _ in range(t):
        u = jacobi_step(u)
    return u


def stencil_step(u: torch.Tensor, spec: StencilSpec) -> torch.Tensor:
    """Generic weighted-stencil sweep (oracle for the general kernel)."""
    return apply_stencil(u, spec)


def conv1d_depthwise_causal(x: torch.Tensor, w: torch.Tensor,
                            b: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal 1-D convolution (Mamba2's conv frontend).

    x: (B, L, D), w: (K, D), b: (D,) or None. Output (B, L, D) where
    ``out[:, l, d] = sum_k w[k, d] * x[:, l - (K-1) + k, d]`` (zero padded),
    summed in f32 in tap order.
    """
    return conv1d_depthwise_causal_plain(x, w, b)


def stream_copy(x: torch.Tensor) -> torch.Tensor:
    """Identity copy (oracle for the streaming/data-access benchmark)."""
    return x


def stream_replicated(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Oracle for the replicated-read benchmark: ``x * factor`` in f32,
    as the reference's. K5c itself sums ``factor`` reads in order
    (``kernels/stream.py::stream_replicated_plain``), within rtol 1e-6 of
    this product."""
    return (x.to(torch.float32) * float(factor)).to(x.dtype)

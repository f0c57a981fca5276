"""Public wrappers over the port's kernels (twin of ``repro.kernels.ops``).

:func:`flash_attention` (K8) and :func:`conv1d` (K7), on one device. The
reference's ``shard_map`` branch of ``flash_attention`` (batch over the
data axis, KV heads over the model axis) comes with the distributed
slice; the stencil step wrappers (``jacobi_step``) are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.conv1d import (conv1d_depthwise_causal,
                                        conv1d_depthwise_causal_plain)
from repro_torch.kernels.flash_attention import flash_attention_local


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           *, bl: int = 512, use_kernel: bool = True) -> torch.Tensor:
    """Depthwise causal conv1d: K7 on a CUDA tensor, or the plain version
    (``use_kernel=False``). x (B, L, D), w (K, D), b (D,) -> (B, L, D)."""
    if not use_kernel:
        return conv1d_depthwise_causal_plain(x, w, b)
    return conv1d_depthwise_causal(x, w, b, bl=bl)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = 512,
                    bk: int = 512) -> torch.Tensor:
    """Fused attention forward on one device (K8 on a CUDA tensor).
    q (B,Sq,H,hd), k/v (B,Sk,K,hd) -> (B,Sq,H,hd)."""
    return flash_attention_local(q, k, v, causal=causal, bq=bq, bk=bk)

"""Public wrappers over the port's kernels (twin of ``repro.kernels.ops``).

Only :func:`flash_attention` is here so far, on one device. The
reference's ``shard_map`` branch (batch over the data axis, KV heads over
the model axis) comes with the distributed slice; the stencil step
wrappers (``jacobi_step``) and ``conv1d`` (K7) are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention_local


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = 512,
                    bk: int = 512) -> torch.Tensor:
    """Fused attention forward on one device (K8 on a CUDA tensor).
    q (B,Sq,H,hd), k/v (B,Sk,K,hd) -> (B,Sq,H,hd)."""
    return flash_attention_local(q, k, v, causal=causal, bq=bq, bk=bk)

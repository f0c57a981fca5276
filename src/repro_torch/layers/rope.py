"""Rotary position embeddings (twin of ``repro.layers.rope``)."""
from __future__ import annotations

import torch

from repro_torch.dist.sharding import on_mesh


def rope_angles(positions: torch.Tensor, dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for ``dim`` rotated dims. positions: (...,) int."""
    if dim % 2:
        raise ValueError(f"rotated dims must be even; got {dim}")
    exps = on_mesh(torch.arange(0, dim, 2, dtype=torch.float32,
                                device=positions.device)) / dim
    inv = 1.0 / (theta ** exps)
    ang = positions.to(torch.float32)[..., None] * inv  # (..., dim/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               frac: float = 1.0, theta: float = 10000.0) -> torch.Tensor:
    """Rotate the first ``frac`` fraction of head dims, in f32.

    x: (B, S, H, hd); positions: (B, S). Pairs are interleaved
    (dims 2i and 2i+1 rotate together), as in the reference.
    """
    hd = x.shape[-1]
    rot = int(hd * frac)
    rot -= rot % 2
    if rot == 0:
        return x
    cos, sin = rope_angles(positions, rot, theta)   # (B, S, rot/2)
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    xr = x[..., :rot].to(torch.float32)
    x1 = xr[..., 0::2]
    x2 = xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    y = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([y.to(x.dtype), x[..., rot:]], dim=-1)

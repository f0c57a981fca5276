"""Domain decomposition bookkeeping for distributed stencils.

The port's copy of ``repro.core.decomp``, on tensors. A ringed grid
``(Hi+2, Wi+2)`` is split into

  * ``interior``  (Hi, Wi)  — sharded over mesh axes,
  * ``bc``        dict of four Dirichlet edge vectors (top/bottom: (Wi,),
                  left/right: (Hi,)) — sharded along their own length.

Corners of the ring are irrelevant for face-neighbour stencils and dropped.
The split returns views of the grid; the joins build new tensors.
"""
from __future__ import annotations

from typing import Dict

import torch


def split_ringed(u: torch.Tensor):
    """(Hi+2, Wi+2) ringed grid -> (interior, bc dict)."""
    interior = u[1:-1, 1:-1]
    bc = {
        "top": u[0, 1:-1],
        "bottom": u[-1, 1:-1],
        "left": u[1:-1, 0],
        "right": u[1:-1, -1],
    }
    return interior, bc


def join_ringed(interior: torch.Tensor, bc: Dict[str, torch.Tensor],
                corner: float = 0.0) -> torch.Tensor:
    """Inverse of :func:`split_ringed` (corners filled with ``corner``)."""
    return join_ringed_bands(
        interior, {"top": bc["top"][None, :], "bottom": bc["bottom"][None, :],
                   "left": bc["left"][:, None], "right": bc["right"][:, None]},
        r=1, corner=corner)


def check_divisible(hi: int, wi: int, px: int, py: int) -> None:
    if hi % px or wi % py:
        raise ValueError(
            f"interior {hi}x{wi} not divisible by process grid {px}x{py}")


def split_ringed_bands(u: torch.Tensor, r: int = 1):
    """Radius-``r`` generalization of :func:`split_ringed`.

    A ringed grid ``(Hi + 2r, Wi + 2r)`` is split into the ``(Hi, Wi)``
    interior plus four Dirichlet *bands* of thickness ``r`` (top/bottom:
    ``(r, Wi)``, left/right: ``(Hi, r)``) — 2-D tensors rather than vectors,
    so deep-radius stencils keep their full boundary data. Ring corners are
    dropped, as in :func:`split_ringed` (irrelevant for face-neighbour taps).
    """
    interior = u[r:-r, r:-r]
    bc = {
        "top": u[:r, r:-r],
        "bottom": u[-r:, r:-r],
        "left": u[r:-r, :r],
        "right": u[r:-r, -r:],
    }
    return interior, bc


def join_ringed_bands(interior: torch.Tensor, bc: Dict[str, torch.Tensor],
                      r: int = 1, corner: float = 0.0) -> torch.Tensor:
    """Inverse of :func:`split_ringed_bands` (corners filled with
    ``corner``)."""
    hi, wi = interior.shape
    u = torch.full((hi + 2 * r, wi + 2 * r), corner, dtype=interior.dtype,
                   device=interior.device)
    u[r:-r, r:-r] = interior
    u[:r, r:-r] = bc["top"]
    u[-r:, r:-r] = bc["bottom"]
    u[r:-r, :r] = bc["left"]
    u[r:-r, -r:] = bc["right"]
    return u

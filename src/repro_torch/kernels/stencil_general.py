"""DEPRECATED — thin wrapper over the spec-driven stencil engine
(twin of ``repro.kernels.stencil_general``).

``stencil_rowchunk`` (the general row-chunk kernel) is
``repro_torch.engine.stencil_rowchunk`` (K2), one of four policies the
engine applies to any 2-D ``StencilSpec``. New code should use
``engine.run(u, spec, policy=...)`` and get the double-buffered and
temporal-blocked movers too.
"""
from __future__ import annotations

import warnings

import torch

from repro_torch import engine
from repro_torch.core.stencil import StencilSpec


def stencil_rowchunk(u: torch.Tensor, spec: StencilSpec, *,
                     bm: int | None = None) -> torch.Tensor:
    """One sweep of an arbitrary 2-D stencil; ring of width spec.radius
    held fixed (Dirichlet). ``bm=None`` takes the planner's tile."""
    warnings.warn(
        "repro_torch.kernels.stencil_general.stencil_rowchunk is "
        "deprecated; use repro_torch.engine.stencil_rowchunk (or engine.run "
        "with a policy name)", DeprecationWarning, stacklevel=2)
    return engine.stencil_rowchunk(u, spec, bm=bm)

"""DEPRECATED — thin wrappers over the spec-driven stencil engine
(twin of ``repro.kernels.jacobi``).

The four 5-point Jacobi kernel generations of the paper (v0 shifted
copies, v1 row-chunk, v1db double-buffered, v2 temporal) are the four
*policies* of ``repro_torch.engine``, for any 2-D ``StencilSpec``. These
wrappers keep the historical entry points alive for one deprecation
cycle; each warns and launches its policy's kernel once:

    jacobi_v0_shifted   -> engine.stencil_shifted(u, jacobi_2d_5pt())   K4
    jacobi_v1_rowchunk  -> engine.stencil_rowchunk(u, jacobi_2d_5pt())  K2
    jacobi_v1_dbuf      -> engine.stencil_dbuf(u, jacobi_2d_5pt())      K3
    jacobi_v2_temporal  -> engine.stencil_temporal(u, jacobi_2d_5pt())  K1

``bm=None`` takes the planner's tile for the device (see
``kernels.ops.jacobi_step``). New code should call ``engine.run`` /
``engine.step`` with a policy name, or the ``engine.stencil_*``
functions directly with an explicit spec.
"""
from __future__ import annotations

import warnings

import torch

from repro_torch import engine
from repro_torch.core.stencil import jacobi_2d_5pt


def _warn(old: str, policy: str) -> None:
    warnings.warn(
        f"repro_torch.kernels.jacobi.{old} is deprecated; use "
        f"repro_torch.engine.run(u, spec, policy={policy!r}) or "
        f"repro_torch.engine.stencil_{policy}(u, spec)",
        DeprecationWarning, stacklevel=3)


def jacobi_v0_shifted(u: torch.Tensor, *,
                      bm: int | None = None) -> torch.Tensor:
    """One sweep via four materialized shifted copies (paper §IV)."""
    _warn("jacobi_v0_shifted", "shifted")
    return engine.stencil_shifted(u, jacobi_2d_5pt(), bm=bm)


def jacobi_v1_rowchunk(u: torch.Tensor, *,
                       bm: int | None = None) -> torch.Tensor:
    """One sweep via contiguous row-chunk loads + on-chip shifts (§VI)."""
    _warn("jacobi_v1_rowchunk", "rowchunk")
    return engine.stencil_rowchunk(u, jacobi_2d_5pt(), bm=bm)


def jacobi_v1_dbuf(u: torch.Tensor, *, bm: int | None = None) -> torch.Tensor:
    """One sweep with a double-buffered load/compute/store loop (Table I)."""
    _warn("jacobi_v1_dbuf", "dbuf")
    return engine.stencil_dbuf(u, jacobi_2d_5pt(), bm=bm)


def jacobi_v2_temporal(u: torch.Tensor, *, t: int = 8,
                       bm: int | None = None) -> torch.Tensor:
    """Advance the grid by exactly ``t`` Jacobi sweeps in one round-trip."""
    _warn("jacobi_v2_temporal", "temporal")
    return engine.stencil_temporal(u, jacobi_2d_5pt(), t=t, bm=bm)

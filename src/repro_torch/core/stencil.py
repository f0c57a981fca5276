"""Stencil specification and the plain PyTorch oracle.

The PyTorch twin of ``repro.core.stencil``: the same ``StencilSpec`` and
spec builders (identical offset and weight tuples), and ``apply_stencil``,
the oracle every policy kernel is held against. The oracle sums the taps
in f32 in tap order, one rounded multiply and one rounded add per tap, and
casts once to the grid dtype, so it equals the JAX oracle bit for bit.

Grids are stored *including* their boundary ring: a domain of ``ny x nx``
interior points is a tensor of shape ``(ny + 2r, nx + 2r)`` where ``r`` is
the stencil radius. The ring holds Dirichlet values and is never written.
Functions that take a grid also take leading batch dimensions; the stencil
acts on the last ``spec.ndim`` axes.
"""
from __future__ import annotations

import dataclasses
import struct

import torch


@dataclasses.dataclass(frozen=True)
class StencilSpec:
    """A linear stencil: ``out[p] = sum_k w[k] * u[p + off[k]]``.

    offsets: relative grid offsets, one per tap, each of length ndim.
    weights: one weight per tap.
    """

    offsets: tuple[tuple[int, ...], ...]
    weights: tuple[float, ...]

    def __post_init__(self):
        if len(self.offsets) != len(self.weights):
            raise ValueError("offsets and weights must have equal length")
        nd = {len(o) for o in self.offsets}
        if len(nd) != 1:
            raise ValueError("all offsets must have the same dimensionality")

    @property
    def ndim(self) -> int:
        return len(self.offsets[0])

    @property
    def radius(self) -> int:
        """Maximum |offset| over all taps and dims (halo depth)."""
        return max(abs(c) for off in self.offsets for c in off)

    @property
    def taps(self) -> int:
        return len(self.offsets)


def jacobi_2d_5pt() -> StencilSpec:
    """The paper's stencil: average of the four face neighbours (Laplace)."""
    return StencilSpec(
        offsets=((-1, 0), (1, 0), (0, -1), (0, 1)),
        weights=(0.25, 0.25, 0.25, 0.25),
    )


def laplace_2d_9pt() -> StencilSpec:
    """9-point compact Laplacian (used to show generality beyond the paper)."""
    return StencilSpec(
        offsets=(
            (-1, -1), (-1, 0), (-1, 1),
            (0, -1), (0, 1),
            (1, -1), (1, 0), (1, 1),
        ),
        weights=(0.05, 0.2, 0.05, 0.2, 0.2, 0.05, 0.2, 0.05),
    )


def advection_1d_3pt(c: float = 0.2) -> StencilSpec:
    """Upwind-ish 1-D advection stencil (paper's stated future work)."""
    return StencilSpec(offsets=((-1,), (0,), (1,)),
                       weights=(0.5 * c + 0.25, 0.5, 0.25 - 0.5 * c))


def advection_2d_3pt(c: float = 0.2) -> StencilSpec:
    """The 1-D advection stencil embedded as a 2-D row stencil."""
    base = advection_1d_3pt(c)
    return StencilSpec(offsets=tuple((0, o[0]) for o in base.offsets),
                       weights=base.weights)


def f32(w: float) -> float:
    """``w`` rounded to the nearest f32, as a Python float (exact in f64).

    Every weight enters the arithmetic through here, so the plain versions
    and the CUDA kernels multiply by the same f32 value.
    """
    return struct.unpack("f", struct.pack("f", w))[0]


def interior(u: torch.Tensor, r: int, ndim: int = 2) -> torch.Tensor:
    """View of the interior (non-boundary) region of a ringed grid."""
    return u[(...,) + tuple(slice(r, s - r) for s in u.shape[-ndim:])]


def tap_sum(c: torch.Tensor, spec: StencilSpec) -> torch.Tensor:
    """f32 weighted sum of the shifted interior views of ``c``, in tap order.

    ``c`` must already be f32. Returns the interior-shaped sum; one rounded
    multiply and one rounded add per tap (no fused multiply-add).
    """
    r = spec.radius
    shape = c.shape[-spec.ndim:]
    acc = None
    for off, w in zip(spec.offsets, spec.weights):
        idx = (...,) + tuple(slice(r + o, s - r + o)
                             for o, s in zip(off, shape))
        term = c[idx] * f32(w)
        acc = term if acc is None else acc + term
    return acc


def apply_stencil(u: torch.Tensor, spec: StencilSpec) -> torch.Tensor:
    """One stencil sweep. Returns a new grid; boundary ring copied through."""
    r = spec.radius
    if any(s <= 2 * r for s in u.shape[-spec.ndim:]):
        raise ValueError(f"grid {tuple(u.shape)} too small for radius {r}")
    out = u.clone()
    interior(out, r, spec.ndim).copy_(
        tap_sum(u.to(torch.float32), spec).to(u.dtype))
    return out


def residual(u: torch.Tensor, spec: StencilSpec) -> torch.Tensor:
    """Max-norm update delta ``|apply(u) - u|_inf`` over the interior.

    A 0-d f32 tensor for one grid; for a batch, one value per leading index.
    """
    v = apply_stencil(u, spec)
    r = spec.radius
    d = (interior(v, r, spec.ndim).to(torch.float32)
         - interior(u, r, spec.ndim).to(torch.float32)).abs()
    return d.amax(dim=tuple(range(-spec.ndim, 0)))


def require_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run the plain versions")
    return dev


def make_laplace_problem(
    ny: int,
    nx: int,
    dtype=torch.float32,
    left: float = 1.0,
    right: float = 0.0,
    top: float = 0.0,
    bottom: float = 0.0,
    init: float = 0.0,
    *,
    device="cuda",
) -> torch.Tensor:
    """Build the paper's test problem: Laplace diffusion with fixed sides.

    Returns a ``(ny+2, nx+2)`` grid (radius-1 ring) with Dirichlet boundary
    values on each side and ``init`` in the interior, on ``device``.
    """
    u = torch.full((ny + 2, nx + 2), init, dtype=dtype,
                   device=require_device(device))
    u[:, 0] = left
    u[:, -1] = right
    u[0, :] = top
    u[-1, :] = bottom
    return u

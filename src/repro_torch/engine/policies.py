"""The four stencil engine policies: CUDA kernels and their plain versions.

The PyTorch twin of ``repro.engine.policies``. Each policy is a wrapper
that follows the device of the tensor it is given: on a CUDA tensor it
launches its hand-written kernel from ``repro_torch/csrc/stencil.cu`` (or
raises); on a CPU tensor it runs its plain PyTorch version, which computes
the same f32 operations in the same order, so the two agree bit for bit.

  ``shifted``   — paper §IV: one materialized shifted copy per tap, each
      read as a separate operand (K4).
  ``rowchunk``  — paper §VI: one window per tile, every tap served from it
      (K2).
  ``dbuf``      — rowchunk with a two-stage prefetching data mover (K3).
  ``temporal``  — ``t`` sweeps fused per round-trip through device memory,
      with a ``t·r`` halo (K1).

K1, K2 and K3 each run a kernel compiled for a spec's tap geometry when
its offsets equal one of ``plan.TEMPORAL_GEOMETRIES`` in order, else
their general kernel; :data:`TEMPORAL_VARIANTS`,
:data:`ROWCHUNK_VARIANTS` and :data:`DBUF_VARIANTS` count which.

All grids are ringed ``(..., H, W)`` tensors; leading dimensions are a
batch (one kernel launch, batch along ``gridDim.z``). Kernels accumulate
in f32 and store in the grid dtype (float32 or bfloat16 on the card).
Launch parameters come from :func:`~repro_torch.engine.plan.plan_for`.

Every wrapper takes ``out=``: a buffer of the grid's shape, distinct from
``u``, whose ring already equals ``u``'s; the kernel overwrites its
interior. ``engine.run`` passes its ping-pong buffers this way so that the
ring is copied once per run, not once per launch. :data:`LAUNCHES` counts
the kernel launches of each policy (never the plain versions).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core.stencil import StencilSpec, f32, interior, tap_sum
from repro_torch.engine.device import DeviceModel  # noqa: F401
from repro_torch.engine.plan import (DEFAULT_T, TEMPORAL_GEOMETRIES,
                                     ExecutionPlan, PlanError, plan_for,
                                     temporal_variant, window_pitch)

#: Kernel launches per policy since the last :func:`reset_launch_counts`.
LAUNCHES: dict[str, int] = {"shifted": 0, "rowchunk": 0, "dbuf": 0,
                            "temporal": 0}
#: K1 launches by kernel: each compiled geometry, and the general kernel.
#: Their sum is ``LAUNCHES["temporal"]``.
TEMPORAL_VARIANTS: dict[str, int] = {**{name: 0 for name in
                                        TEMPORAL_GEOMETRIES}, "general": 0}
#: The same for K2 (sum ``LAUNCHES["rowchunk"]``) and K3 (``"dbuf"``).
ROWCHUNK_VARIANTS: dict[str, int] = dict(TEMPORAL_VARIANTS)
DBUF_VARIANTS: dict[str, int] = dict(TEMPORAL_VARIANTS)
_VARIANTS = {"temporal": TEMPORAL_VARIANTS, "rowchunk": ROWCHUNK_VARIANTS,
             "dbuf": DBUF_VARIANTS}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: The launcher's geometry code: its place in TEMPORAL_GEOMETRIES.
_GEOMETRY_CODE = {name: i for i, name in enumerate(TEMPORAL_GEOMETRIES)}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, *_VARIANTS.values()):
        for k in counts:
            counts[k] = 0


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and what the kernels are held against)
# ---------------------------------------------------------------------------

def _sweep_plain(u: torch.Tensor, spec: StencilSpec,
                 out: torch.Tensor | None) -> torch.Tensor:
    if out is None:
        out = u.clone()
    interior(out, spec.radius).copy_(
        tap_sum(u.to(torch.float32), spec).to(u.dtype))
    return out


def stencil_shifted_plain(u: torch.Tensor, spec: StencilSpec, *,
                          bm: int | None = None, device=None,
                          out: torch.Tensor | None = None) -> torch.Tensor:
    """One sweep: f32 sum of the shifted interior copies, stored in dtype."""
    return _sweep_plain(u, spec, out)


def stencil_rowchunk_plain(u: torch.Tensor, spec: StencilSpec, *,
                           bm: int | None = None, device=None,
                           out: torch.Tensor | None = None) -> torch.Tensor:
    """One sweep: f32 tap sum over the grid, stored in dtype."""
    return _sweep_plain(u, spec, out)


def stencil_dbuf_plain(u: torch.Tensor, spec: StencilSpec, *,
                       bm: int | None = None, device=None,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """One sweep: the same function as :func:`stencil_rowchunk_plain`."""
    return _sweep_plain(u, spec, out)


def ring_mask(shape, r: int, device) -> torch.Tensor:
    """Bool ``(H, W)`` mask of the r-deep boundary ring."""
    h, w = shape[-2:]
    m = torch.ones((h, w), dtype=torch.bool, device=device)
    m[r:h - r, r:w - r] = False
    return m


def stencil_temporal_plain(u: torch.Tensor, spec: StencilSpec, *,
                           t: int | None = None, bm: int | None = None,
                           device=None, mask: torch.Tensor | None = None,
                           out: torch.Tensor | None = None) -> torch.Tensor:
    """``t`` sweeps in f32 with the pin set held, rounded once to dtype.

    Pinned cells keep their input value every sweep: the r-deep ring, and
    with ``mask`` also every cell where ``mask != 0``.
    """
    t = t if t is not None else DEFAULT_T
    r = spec.radius
    c0 = u.to(torch.float32)
    pin = ring_mask(u.shape, r, u.device)
    if mask is not None:
        pin = pin | (mask.to(u.device) != 0)
    c = c0
    for _ in range(t):
        nxt = c.clone()
        interior(nxt, r).copy_(tap_sum(c, spec))
        c = torch.where(pin, c0, nxt)
    if out is None:
        return c.to(u.dtype)
    return out.copy_(c)


# ---------------------------------------------------------------------------
# Launch plumbing
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _tap_args(spec: StencilSpec):
    n = spec.taps
    dy = (ctypes.c_int * n)(*(o[0] for o in spec.offsets))
    dx = (ctypes.c_int * n)(*(o[1] for o in spec.offsets))
    w = (ctypes.c_float * n)(*(f32(x) for x in spec.weights))
    return n, dy, dx, w


def copy_ring(src: torch.Tensor, dst: torch.Tensor, r: int) -> None:
    """Copy the r-deep ring of ``src`` into ``dst`` (same shape)."""
    dst[..., :r, :] = src[..., :r, :]
    dst[..., -r:, :] = src[..., -r:, :]
    dst[..., r:-r, :r] = src[..., r:-r, :r]
    dst[..., r:-r, -r:] = src[..., r:-r, -r:]


def _on_cpu(u: torch.Tensor) -> bool:
    if u.device.type == "cpu":
        return True
    if u.device.type != "cuda":
        raise ValueError(f"policies run on CUDA or CPU tensors; got "
                         f"{u.device}")
    return False


def _cuda_out(u: torch.Tensor, out: torch.Tensor | None, plan: ExecutionPlan
              ) -> torch.Tensor:
    """Check ``u`` for the kernels and return the output buffer."""
    if u.dtype not in _DTYPE_CODE:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16; got "
                        f"{u.dtype}")
    if not u.is_contiguous():
        raise ValueError("the CUDA kernels take contiguous grids")
    if not plan.tiled_2d:
        raise PlanError(f"a CUDA tensor needs a 2-D tile plan; "
                        f"{plan.device.name} plans row blocks (pass "
                        f"device='gpu_sm90' or None)")
    if out is None:
        out = torch.empty_like(u)
        copy_ring(u, out, plan.radius)
    elif (out.shape != u.shape or out.dtype != u.dtype
          or out.device != u.device or not out.is_contiguous()
          or out.data_ptr() == u.data_ptr()):
        raise ValueError("out= must be a contiguous buffer of u's shape, "
                         "dtype and device, distinct from u")
    return out


def _batch_hw(u: torch.Tensor) -> tuple[int, int, int]:
    return math.prod(u.shape[:-2]), u.shape[-2], u.shape[-1]


def _checked(name: str, err: int, variant: str | None = None) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    LAUNCHES[name] += 1
    if variant is not None:
        _VARIANTS[name][variant] += 1


def _stream(u: torch.Tensor) -> int:
    return torch.cuda.current_stream(u.device).cuda_stream


def _lib():
    from repro_torch.kernels.build import load
    return load("stencil")


def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


# ---------------------------------------------------------------------------
# Launchers: one per kernel, all driven by a 2-D tile plan
# ---------------------------------------------------------------------------

def shifted_views(u: torch.Tensor, spec: StencilSpec) -> list[torch.Tensor]:
    """K4's operands: one shifted interior copy of ``u`` per tap, in tap
    order, each materialized as a separate contiguous buffer (as XLA
    materialized them): the paper's replicated-read traffic."""
    r = spec.radius
    h, w = u.shape[-2:]
    return [u[..., r + dy:h - r + dy, r + dx:w - r + dx].contiguous()
            for dy, dx in spec.offsets]


def launch_shifted_views(plan: ExecutionPlan, views: list[torch.Tensor],
                         out: torch.Tensor) -> torch.Tensor:
    """Launch K4 alone on ``views`` (:func:`shifted_views` of the grid):
    write their weighted sum into ``out``'s interior; return ``out``."""
    spec, r = plan.spec, plan.radius
    hi, wi = plan.interior_shape
    if out.device.type != "cuda" or not out.is_contiguous():
        raise ValueError("out must be a contiguous CUDA grid")
    if (tuple(out.shape[-2:]) != plan.shape
            or out.dtype != getattr(torch, plan.dtype)):
        raise ValueError(f"plan is for {plan.shape} {plan.dtype}; out is "
                         f"{tuple(out.shape)} {out.dtype}")
    want = (*out.shape[:-2], hi, wi)
    if len(views) != spec.taps or any(
            tuple(v.shape) != want or v.dtype != out.dtype
            or v.device != out.device or not v.is_contiguous()
            for v in views):
        raise ValueError(f"K4 takes {spec.taps} contiguous views of shape "
                         f"{want} and out's dtype and device")
    b, _, w = _batch_hw(out)
    n, _, _, wts = _tap_args(spec)
    ptrs = (ctypes.c_void_p * n)(*(v.data_ptr() for v in views))
    blocks = min(-(-hi * wi // 256), 8 * _sm_count(out.device))
    _checked("shifted", _lib().repro_shifted(
        ptrs, out.data_ptr(), _DTYPE_CODE[out.dtype], b, hi, wi, w, r,
        blocks, n, wts, _stream(out)))
    return out


def _launch_shifted(plan: ExecutionPlan, u, out, mask) -> None:
    launch_shifted_views(plan, shifted_views(u, plan.spec), out)


def _sweep_args(plan: ExecutionPlan) -> tuple[str, int, int]:
    """K2's and K3's kernel: its variant, the launcher's geometry code (-1
    for the general kernel) and the window's row pitch in bytes."""
    variant = temporal_variant(plan.spec)
    return (variant, _GEOMETRY_CODE.get(variant, -1),
            window_pitch(plan.bn, plan.radius, plan.dtype_bytes))


def _launch_rowchunk(plan: ExecutionPlan, u, out, mask) -> None:
    b, h, w = _batch_hw(u)
    n, dy, dx, wts = _tap_args(plan.spec)
    variant, geometry, pitch = _sweep_args(plan)
    _checked("rowchunk", _lib().repro_rowchunk(
        u.data_ptr(), out.data_ptr(), geometry, _DTYPE_CODE[u.dtype], b, h,
        w, plan.radius, plan.bm, plan.bn, plan.row_tiles, plan.col_tiles,
        pitch, n, dy, dx, wts, plan.vmem_bytes, _stream(u)), variant)


def _launch_dbuf(plan: ExecutionPlan, u, out, mask) -> None:
    b, h, w = _batch_hw(u)
    n, dy, dx, wts = _tap_args(plan.spec)
    variant, geometry, pitch = _sweep_args(plan)
    # Tiles a block walks: 0 lets the launcher fill the card's resident
    # blocks (it knows the kernel's occupancy).
    _checked("dbuf", _lib().repro_dbuf(
        u.data_ptr(), out.data_ptr(), geometry, _DTYPE_CODE[u.dtype], b, h,
        w, plan.radius, plan.bm, plan.bn, plan.row_tiles, plan.col_tiles, 0,
        pitch, n, dy, dx, wts, plan.vmem_bytes, _stream(u)), variant)


def _launch_temporal(plan: ExecutionPlan, u, out, mask) -> None:
    b, h, w = _batch_hw(u)
    mask_ptr = None
    if mask is not None:
        mask = (mask.to(u.device) != 0).to(torch.uint8).expand(u.shape)
        mask = mask.contiguous()
        mask_ptr = mask.data_ptr()
    n, dy, dx, wts = _tap_args(plan.spec)
    variant = temporal_variant(plan.spec)
    if variant == "general":
        err = _lib().repro_temporal(
            u.data_ptr(), mask_ptr, out.data_ptr(), _DTYPE_CODE[u.dtype], b,
            h, w, plan.radius, plan.t, plan.bm, plan.bn, plan.row_tiles,
            plan.col_tiles, n, dy, dx, wts, plan.vmem_bytes, _stream(u))
    else:
        err = _lib().repro_temporal_geo(
            u.data_ptr(), mask_ptr, out.data_ptr(), _GEOMETRY_CODE[variant],
            _DTYPE_CODE[u.dtype], b, h, w, plan.radius, plan.t, plan.bm,
            plan.bn, plan.row_tiles, plan.col_tiles, n, wts,
            plan.vmem_bytes, _stream(u))
    _checked("temporal", err, variant)


_LAUNCHERS = {"shifted": _launch_shifted, "rowchunk": _launch_rowchunk,
              "dbuf": _launch_dbuf, "temporal": _launch_temporal}


def launch(plan: ExecutionPlan, u: torch.Tensor, *,
           out: torch.Tensor | None = None,
           mask: torch.Tensor | None = None) -> torch.Tensor:
    """Launch ``plan``'s kernel on the CUDA grid ``u``; return ``out``.

    The plan must be a 2-D tile plan for ``u``'s shape and dtype (the
    wrappers below make one; a tile sweep passes its own). ``mask`` is
    for a masked temporal plan only.
    """
    if tuple(u.shape[-2:]) != plan.shape or u.dtype != getattr(
            torch, plan.dtype):
        raise ValueError(f"plan is for {plan.shape} {plan.dtype}; grid is "
                         f"{tuple(u.shape)} {u.dtype}")
    if (mask is not None) != plan.masked:
        raise ValueError("pass a mask exactly when the plan is masked")
    out = _cuda_out(u, out, plan)
    _LAUNCHERS[plan.policy](plan, u, out, mask)
    return out


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------

def stencil_shifted(u: torch.Tensor, spec: StencilSpec, *,
                    bm: int | None = None,
                    device: "str | DeviceModel | None" = None,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """One sweep via one materialized shifted copy per tap (baseline, K4)."""
    plan = plan_for(u.shape[-2:], u.dtype, spec, "shifted", bm=bm,
                    device=device)
    if _on_cpu(u):
        return stencil_shifted_plain(u, spec, out=out)
    return launch(plan, u, out=out)


def stencil_rowchunk(u: torch.Tensor, spec: StencilSpec, *,
                     bm: int | None = None,
                     device: "str | DeviceModel | None" = None,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """One sweep; each tile loaded once with an r halo (K2)."""
    plan = plan_for(u.shape[-2:], u.dtype, spec, "rowchunk", bm=bm,
                    device=device)
    if _on_cpu(u):
        return stencil_rowchunk_plain(u, spec, out=out)
    return launch(plan, u, out=out)


def stencil_dbuf(u: torch.Tensor, spec: StencilSpec, *,
                 bm: int | None = None,
                 device: "str | DeviceModel | None" = None,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """One sweep with a two-stage prefetching tile walk (K3)."""
    plan = plan_for(u.shape[-2:], u.dtype, spec, "dbuf", bm=bm,
                    device=device)
    if _on_cpu(u):
        return stencil_dbuf_plain(u, spec, out=out)
    return launch(plan, u, out=out)


def stencil_temporal(u: torch.Tensor, spec: StencilSpec, *,
                     t: int | None = None, bm: int | None = None,
                     device: "str | DeviceModel | None" = None,
                     mask: torch.Tensor | None = None,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """Advance the grid by exactly ``t`` sweeps in one round-trip (K1).

    ``mask`` (optional, ``(H, W)`` or the grid's shape, nonzero = pinned)
    adds cells to the pin set, which is always the grid's r-deep ring.
    Unmasked cells within ``t·r`` of an unpinned edge are computed from
    neighbours that do not evolve (the ring); callers that pin less than
    the ring crop them.
    """
    plan = plan_for(u.shape[-2:], u.dtype, spec, "temporal", bm=bm, t=t,
                    device=device, masked=mask is not None)
    if _on_cpu(u):
        return stencil_temporal_plain(u, spec, t=plan.t, mask=mask, out=out)
    return launch(plan, u, out=out, mask=mask)

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
ring is copied once per run, not once per launch, and hands a schedule's
fused K1 blocks to the library in one call (:func:`launch_chain`).
:data:`LAUNCHES` counts the kernel launches of each policy (never the
plain versions).
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
from repro_torch.obs import metrics as _metrics

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


def _check_grid(u: torch.Tensor, plan: ExecutionPlan) -> None:
    """Check that ``u`` is a grid ``plan`` was made for, and one the
    kernels take."""
    if tuple(u.shape[-2:]) != plan.shape or u.dtype != getattr(
            torch, plan.dtype):
        raise ValueError(f"plan is for {plan.shape} {plan.dtype}; grid is "
                         f"{tuple(u.shape)} {u.dtype}")
    if u.dtype not in _DTYPE_CODE:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16; got "
                        f"{u.dtype}")
    if not u.is_contiguous():
        raise ValueError("the CUDA kernels take contiguous grids")
    if not plan.tiled_2d:
        raise PlanError(f"a CUDA tensor needs a 2-D tile plan; "
                        f"{plan.device.name} plans row blocks (pass "
                        f"device='gpu_sm90' or None)")


def _cuda_out(u: torch.Tensor, out: torch.Tensor | None, plan: ExecutionPlan
              ) -> torch.Tensor:
    """The output buffer for ``u`` (checked by :func:`_check_grid`):
    ``out``, checked, or a new one with ``u``'s ring."""
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


def _checked(name: str, err: int, variant: str | None = None,
             n: int = 1) -> None:
    """Raise on a launcher's error, else count its ``n`` launches."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    LAUNCHES[name] += n
    if variant is not None:
        _VARIANTS[name][variant] += n


def _lib():
    from repro_torch.kernels.build import load
    return load("stencil")


def _on_card(*operands):
    """``kernels.build.on_card``: the operands' card current around a
    launch; yields its stream handle."""
    from repro_torch.kernels.build import on_card
    return on_card(*operands)


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
    if not out.is_contiguous():  # the card: on_card refuses any other
        raise ValueError("out must be a contiguous grid")
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
    with _on_card(out, *views) as stream:
        blocks = min(-(-hi * wi // 256), 8 * _sm_count(out.device))
        err = _lib().repro_shifted(
            ptrs, out.data_ptr(), _DTYPE_CODE[out.dtype], b, hi, wi, w, r,
            blocks, n, wts, stream)
    _checked("shifted", err)
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
    with _on_card(u, out) as stream:
        err = _lib().repro_rowchunk(
            u.data_ptr(), out.data_ptr(), geometry, _DTYPE_CODE[u.dtype], b,
            h, w, plan.radius, plan.bm, plan.bn, plan.row_tiles,
            plan.col_tiles, pitch, n, dy, dx, wts, plan.vmem_bytes, stream)
    _checked("rowchunk", err, variant)


def _launch_dbuf(plan: ExecutionPlan, u, out, mask) -> None:
    b, h, w = _batch_hw(u)
    n, dy, dx, wts = _tap_args(plan.spec)
    variant, geometry, pitch = _sweep_args(plan)
    # Tiles a block walks: 0 lets the launcher fill the card's resident
    # blocks (it knows the kernel's occupancy).
    with _on_card(u, out) as stream:
        err = _lib().repro_dbuf(
            u.data_ptr(), out.data_ptr(), geometry, _DTYPE_CODE[u.dtype], b,
            h, w, plan.radius, plan.bm, plan.bn, plan.row_tiles,
            plan.col_tiles, 0, pitch, n, dy, dx, wts, plan.vmem_bytes,
            stream)
    _checked("dbuf", err, variant)


def _temporal_args(plan: ExecutionPlan, u: torch.Tensor) -> tuple:
    """K1's launcher arguments after its operands: the geometry code (-1
    for the general kernel), the grid, the plan's tile, the taps and the
    shared memory."""
    b, h, w = _batch_hw(u)
    n, dy, dx, wts = _tap_args(plan.spec)
    return (_GEOMETRY_CODE.get(temporal_variant(plan.spec), -1),
            _DTYPE_CODE[u.dtype], b, h, w, plan.radius, plan.t, plan.bm,
            plan.bn, plan.row_tiles, plan.col_tiles, n, dy, dx, wts,
            plan.vmem_bytes)


def _launch_temporal(plan: ExecutionPlan, u, out, mask) -> None:
    mask_ptr = None
    if mask is not None:
        # The kernel reads one byte a cell (nonzero = pinned) over the
        # whole grid; a mask already in that form is passed as it is. A
        # mask on the CPU is moved to the grid's card; one on another card
        # is refused below.
        if mask.device.type == "cpu":
            mask = mask.to(u.device)
        if not (mask.dtype == torch.uint8 and mask.shape == u.shape
                and mask.is_contiguous()):
            mask = (mask != 0).to(torch.uint8).expand(u.shape).contiguous()
        mask_ptr = mask.data_ptr()
    with _on_card(u, out, mask) as stream:
        err = _lib().repro_temporal(u.data_ptr(), mask_ptr, out.data_ptr(),
                                    *_temporal_args(plan, u), stream)
    _checked("temporal", err, temporal_variant(plan.spec))


def launch_chain(plan: ExecutionPlan, u: torch.Tensor, buf_a: torch.Tensor,
                 buf_b: torch.Tensor | None, launches: int) -> torch.Tensor:
    """Enqueue ``launches`` unmasked K1 blocks of ``plan`` in one call: the
    first reads ``u`` and writes ``buf_a``, each next one reads the last
    one's output and writes the other of ``buf_a`` and ``buf_b``
    (``buf_b`` may be ``u``, or None for one launch). Returns the last
    output. Each launch counts in :data:`LAUNCHES`, under its variant and
    in the ``engine.launches.chained`` counter."""
    bufs = [buf_a] if buf_b is None else [buf_a, buf_b]
    if plan.policy != "temporal" or plan.masked or launches < 1 or (
            buf_b is None and launches > 1):
        raise ValueError(f"a chain takes {launches} unmasked temporal "
                         f"launches over {len(bufs)} buffers; got "
                         f"{plan.describe()}")
    if buf_b is not None and buf_b.data_ptr() == buf_a.data_ptr():
        raise ValueError("buf_a and buf_b must be distinct buffers")
    _check_grid(u, plan)
    for buf in bufs:
        if buf is not u:  # buf_b may be u: a donated grid
            _cuda_out(u, buf, plan)
    with _on_card(u, *bufs) as stream:
        err = _lib().repro_temporal_chain(
            u.data_ptr(), buf_a.data_ptr(),
            None if buf_b is None else buf_b.data_ptr(), launches,
            *_temporal_args(plan, u), stream)
    _checked("temporal", err, temporal_variant(plan.spec), launches)
    _metrics.counter("engine.launches.chained").inc(launches)
    return bufs[(launches - 1) % 2]


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
    _check_grid(u, plan)
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
    adds cells to the pin set, which is always the grid's r-deep ring. A
    contiguous ``uint8`` mask of the grid's shape on its device goes to
    the kernel as it is; any other is converted once a launch.
    Unmasked cells within ``t·r`` of an unpinned edge are computed from
    neighbours that do not evolve (the ring); callers that pin less than
    the ring crop them.
    """
    plan = plan_for(u.shape[-2:], u.dtype, spec, "temporal", bm=bm, t=t,
                    device=device, masked=mask is not None)
    if _on_cpu(u):
        return stencil_temporal_plain(u, spec, t=plan.t, mask=mask, out=out)
    return launch(plan, u, out=out, mask=mask)

"""Execution planning for the stencil engine.

The port's copy of ``repro.engine.plan``. A *plan* is everything that must
be decided before a policy kernel can be launched: the output tile, the
fast-memory window that tile implies, the temporal fusion depth, and
whether the whole thing fits the device's per-core fast-memory budget.
Plans are pure functions of static arguments, memoized in an in-process
cache (``engine.plan.hit`` / ``engine.plan.miss`` count the lookups).

Two rules, chosen by the device model:

* **Row blocks** (every model but a GPU): the JAX package's rule
  unchanged. A block is ``bm`` interior rows at full width, its window
  ``(bm + 2·halo) x W``; plans equal the reference's field for field.
* **2-D tiles** (``backend == "gpu"``, i.e. ``gpu_sm90``): a full-width
  window of a 9218-wide row cannot fit 227 KiB of shared memory, so the
  output is cut into ``(bm, bn)`` tiles, each loaded with its halo on all
  four sides (``r`` for one sweep, ``t·r`` for ``t`` fused sweeps). The
  shared-memory footprint is exactly what the CUDA launchers allocate
  (:func:`smem_2d`). Tiles need not divide the interior: the kernels mask
  the ragged edge.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings

import torch

from repro_torch.core.stencil import StencilSpec
from repro_torch.engine.device import DeviceModel, get_device
from repro_torch.obs import metrics as _metrics

# Knob defaults shared by every policy.
DEFAULT_BM = 256   # interior rows per block
DEFAULT_T = 8      # temporal fusion depth (sweeps per HBM round-trip)
#: Default (bm, bn) output tile of the 2-D plan, per policy: the fastest
#: tile of ``python -m repro_torch.launch.tiles`` on an H100 at 1026 x 9218
#: (see PERF.md). ``shifted`` streams without a tile; its tile only counts
#: blocks for ``auto``. ``temporal``'s is the register pipeline's (a
#: warp's segment of rows and its strip's output columns; see
#: :func:`register_pipeline`).
GPU_TILES = {"shifted": (32, 128), "rowchunk": (8, 1016),
             "dbuf": (16, 504), "temporal": (41, 112)}
#: Default tile of the K1 kernels that run from shared memory: every plan
#: but the register pipeline's.
GPU_TILE_TEMPORAL_SMEM = (40, 112)
#: Most taps a CUDA kernel takes (the tap table is a kernel argument).
MAX_TAPS = 32
#: Tap geometries K1, K2 and K3 are compiled for (``csrc/stencil.cu``:
#: ``Jacobi5``, ``Laplace9``, ``Radius2``, in this order): offsets in tap
#: order. A spec whose offsets equal one of these, in order, runs that
#: compiled kernel; every other spec runs the general one
#: (:func:`temporal_variant`).
TEMPORAL_GEOMETRIES = {
    "jacobi5": ((-1, 0), (1, 0), (0, -1), (0, 1)),
    "laplace9": ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1),
                 (1, 0), (1, 1)),
    "radius2": ((-2, 0), (-1, 0), (0, 0), (0, -2), (0, 1)),
}
#: Cells a row of a compiled K1 geometry holds (one warp of 4-column
#: quads): a warp's strip in the register pipeline, or a row of the
#: shared-memory kernel's tile. Its window, ``bn + 2·t·r``, must fit in it.
TEMPORAL_ROW = 128
#: Sweeps the register pipeline carries: the one ``t`` it takes
#: (``csrc/stencil.cu``: ``LEVELS``).
TEMPORAL_LEVELS = 8
#: Geometries the register pipeline is compiled for (``csrc/stencil.cu``:
#: ``PIPE``). The 9-point one ran no faster there than from shared memory
#: (PERF.md).
TEMPORAL_PIPELINE = ("jacobi5", "radius2")
#: Bytes of slack before and after each row of a K2/K3 window in shared
#: memory (``csrc/stencil.cu``: ``WIN_LEAD``, ``WIN_TAIL``).
WINDOW_LEAD, WINDOW_TAIL = 16, 32
#: K3's ring: windows a block keeps in flight, and the bytes of mbarriers
#: ahead of them (``DBUF_STAGES``, ``DBUF_BARS``).
DBUF_STAGES, DBUF_BARS = 2, 64


class PlanError(ValueError):
    """A (shape, dtype, spec, policy, device) combination that cannot be
    planned."""


def pick_bm(h_int: int, bm: int) -> int:
    """Largest divisor of ``h_int`` that is <= ``bm`` (keeps the grid exact).

    Warns when the request degrades all the way to ``bm=1``.
    """
    req = min(bm, h_int)
    bm = req
    while h_int % bm:
        bm -= 1
    if bm == 1 and req > 1:
        warnings.warn(
            f"pick_bm: interior height {h_int} has no divisor <= {req}; "
            f"realized bm=1 (one grid step per row — expect poor DMA "
            f"efficiency; pad the grid or pick a height with small factors)",
            stacklevel=2)
    return bm


def dtype_name(dtype) -> str:
    """``torch.float32`` or ``"float32"`` -> ``"float32"``."""
    if isinstance(dtype, str):
        if not isinstance(getattr(torch, dtype, None), torch.dtype):
            raise PlanError(f"unknown dtype {dtype!r}")
        return dtype
    return str(dtype).removeprefix("torch.")


def tiles_2d(device: DeviceModel) -> bool:
    """Whether ``device`` is planned in 2-D tiles (a GPU's shared memory)."""
    return device.backend == "gpu"


def window_pitch(bn: int, r: int, dtype_bytes: int) -> int:
    """Bytes a row of a K2/K3 window takes in shared memory.

    A window row is copied raw as the 16-byte chunks that cover its
    ``bn + 2r`` cells, from the 16-byte boundary at or below its first
    cell, wherever in its chunk that cell falls, with slack either side for
    the kernels' aligned reads.
    """
    span = (bn + 2 * r) * dtype_bytes
    return (WINDOW_LEAD + -(-(span + 16 - dtype_bytes) // 16) * 16
            + WINDOW_TAIL)


def sweep_bn(policy: str, dtype_bytes: int, spec: StencilSpec, bm: int,
             bn: int, device: DeviceModel) -> int:
    """K2's or K3's default tile width for ``bm`` rows: ``bn`` halved until
    the shared memory leaves room for four blocks on a core (an SM), so
    a tall requested tile does not leave the card a block an SM."""
    while bn > 1 and smem_2d(policy, dtype_bytes, spec, bm, bn,
                             1)[1] > device.fast_memory_bytes // 4:
        bn //= 2
    return bn


def temporal_variant(spec: StencilSpec) -> str:
    """The K1 kernel that runs ``spec`` (and the K2 and K3 kernel): the
    compiled geometry whose offsets equal ``spec.offsets`` in order, else
    ``"general"``."""
    for name, offsets in TEMPORAL_GEOMETRIES.items():
        if tuple(spec.offsets) == offsets:
            return name
    return "general"


def register_pipeline(spec: StencilSpec, t: int, masked: bool) -> bool:
    """Whether K1 runs as the register pipeline (``csrc/stencil.cu``:
    ``temporal_pipe_kernel``): unmasked, ``t`` equal to
    :data:`TEMPORAL_LEVELS`, a geometry of :data:`TEMPORAL_PIPELINE`.
    Every other K1 plan runs from shared memory, which was as fast or
    faster there (PERF.md)."""
    return (not masked and t == TEMPORAL_LEVELS
            and temporal_variant(spec) in TEMPORAL_PIPELINE)


def smem_2d(policy: str, dtype_bytes: int, spec: StencilSpec, bm: int,
            bn: int, t: int, masked: bool = False) -> tuple[int, int]:
    """(halo, shared-memory bytes) of one 2-D tile of ``policy``.

    The bytes are the dynamic shared memory the CUDA launcher allocates:
    one window of ``bm + 2r`` rows of :func:`window_pitch` bytes in the
    grid dtype (rowchunk), :data:`DBUF_STAGES` of them behind their
    mbarriers (dbuf), or two f32 tiles (temporal). A compiled K1
    geometry's tiles have rows of :data:`TEMPORAL_ROW` cells whatever
    ``bn``; the register pipeline takes none.
    """
    r = spec.radius
    if policy == "shifted":
        # Streams the per-tap copies straight from device memory.
        return 0, 0
    window = (bm + 2 * r) * window_pitch(bn, r, dtype_bytes)
    if policy == "rowchunk":
        return r, window
    if policy == "dbuf":
        return r, DBUF_BARS + DBUF_STAGES * window
    if policy == "temporal":
        if register_pipeline(spec, t, masked):
            return t * r, 0
        # Two f32 ping-pong tiles; a masked run adds one byte per cell.
        width = (TEMPORAL_ROW if temporal_variant(spec) != "general"
                 else bn + 2 * t * r)
        cells = (bm + 2 * t * r) * width
        return t * r, 8 * cells + (cells if masked else 0)
    raise PlanError(f"unknown policy {policy!r}")


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Fully-resolved launch parameters for one policy on one problem.

    shape/dtype describe the ringed grid (boundary included); ``bm`` x
    ``bn`` is the interior tile each block produces (``bn`` is the full
    interior width under the row-block rule); ``window_rows`` is the height
    of the fast-memory window that tile needs; ``t`` is the number of
    sweeps fused per round-trip (1 unless the policy is temporal);
    ``vmem_bytes`` the fast-memory footprint; ``device`` the model whose
    budget validated the plan.
    """

    policy: str
    shape: tuple[int, int]
    dtype: str
    spec: StencilSpec
    bm: int
    bn: int
    t: int
    window_rows: int
    vmem_bytes: int
    device: DeviceModel
    #: Temporal only: the kernel reads a per-cell pin mask beside the grid.
    masked: bool = False

    @property
    def radius(self) -> int:
        return self.spec.radius

    @property
    def interior_shape(self) -> tuple[int, int]:
        r = self.spec.radius
        return (self.shape[0] - 2 * r, self.shape[1] - 2 * r)

    @property
    def tiled_2d(self) -> bool:
        return tiles_2d(self.device)

    @property
    def halo(self) -> int:
        """Depth of the halo a tile loads on each side."""
        return (self.window_rows - self.bm) // 2 if self.tiled_2d else 0

    @property
    def window_cols(self) -> int:
        return self.bn + 2 * self.halo if self.tiled_2d else self.shape[1]

    @property
    def row_tiles(self) -> int:
        return -(-self.interior_shape[0] // self.bm)

    @property
    def col_tiles(self) -> int:
        return -(-self.interior_shape[1] // self.bn)

    @property
    def nblocks(self) -> int:
        return self.row_tiles * self.col_tiles

    @property
    def dtype_bytes(self) -> int:
        return getattr(torch, self.dtype).itemsize

    def describe(self) -> str:
        return (f"{self.policy}: grid={self.shape} dtype={self.dtype} "
                f"taps={self.spec.taps} r={self.radius} bm={self.bm} "
                f"bn={self.bn} t={self.t} "
                f"window={self.window_rows}x{self.window_cols} "
                f"vmem={self.vmem_bytes / 1024:.0f}KiB blocks={self.nblocks} "
                f"device={self.device.name}")


def _window_and_vmem(policy: str, shape, dtype_bytes: int, spec: StencilSpec,
                     bm: int, t: int, masked: bool = False) -> tuple[int, int]:
    """Row-block rule: window height and scratch/operand footprint, as
    ``repro.engine.plan._window_and_vmem`` computes them."""
    h, w = shape
    r = spec.radius
    wi = w - 2 * r
    if policy == "shifted":
        win = bm
        vmem = 2 * (spec.taps + 1) * bm * wi * dtype_bytes
    elif policy == "rowchunk":
        win = min(bm + 2 * r, h)
        vmem = win * w * dtype_bytes + 2 * bm * wi * dtype_bytes
    elif policy == "dbuf":
        win = min(bm + 2 * r, h)
        vmem = 2 * win * w * dtype_bytes + 2 * bm * wi * dtype_bytes
    elif policy == "temporal":
        win = min(bm + 2 * t * r, h)
        vmem = win * w * (dtype_bytes + 8) + bm * w * dtype_bytes
        if masked:
            vmem += win * w * dtype_bytes
    else:
        raise PlanError(f"unknown policy {policy!r}")
    return win, vmem


@functools.lru_cache(maxsize=1024)
def _plan_cached(shape: tuple[int, int], dtype: str, spec: StencilSpec,
                 policy: str, bm_req: int, bn_req: int, t: int,
                 device: DeviceModel, masked: bool) -> ExecutionPlan:
    # Executed only on a cache miss, so this counter plus the request
    # counter in plan_for gives the hit/miss split.
    _metrics.counter("engine.plan.miss").inc()
    h, w = shape
    r = spec.radius
    if spec.ndim != 2:
        raise PlanError(f"engine policies are 2-D; spec has ndim={spec.ndim} "
                        "(embed 1-D stencils as 2-D row stencils)")
    if h <= 2 * r or w <= 2 * r:
        raise PlanError(f"grid {shape} too small for stencil radius {r}")
    if t < 1:
        raise PlanError(f"temporal depth t={t} must be >= 1")
    if masked and policy != "temporal":
        raise PlanError(f"policy {policy!r} takes no pin mask; only the "
                        f"temporal kernel streams one")
    hi, wi = h - 2 * r, w - 2 * r
    dtype_bytes = getattr(torch, dtype).itemsize
    if tiles_2d(device):
        if spec.taps > MAX_TAPS:
            raise PlanError(f"spec has {spec.taps} taps; the CUDA kernels "
                            f"take at most {MAX_TAPS}")
        bm, bn = min(bm_req, hi), min(bn_req, wi)
        if policy == "temporal" and temporal_variant(spec) != "general":
            # The compiled K1's window spans at most one tile row.
            bn = min(bn, TEMPORAL_ROW - 2 * t * r)
            if bn < 1:
                raise PlanError(
                    f"policy 'temporal' for grid {shape} (t={t}) on "
                    f"{device.name}: a {2 * t * r}-column halo leaves no "
                    f"room in the compiled kernel's {TEMPORAL_ROW}-cell "
                    f"tile row — lower t")
        halo, vmem = smem_2d(policy, dtype_bytes, spec, bm, bn, t, masked)
        win = bm + 2 * halo
        what = f"policy {policy!r} for grid {shape} (bm={bm}, bn={bn}, t={t})"
    else:
        bm, bn = pick_bm(hi, bm_req), wi
        win, vmem = _window_and_vmem(policy, shape, dtype_bytes, spec, bm, t,
                                     masked)
        what = f"policy {policy!r} for grid {shape} (bm={bm}, t={t})"
    if vmem > device.fast_memory_bytes:
        from repro_torch.analysis.diagnostics import budget_message
        raise PlanError(
            budget_message(what, vmem, device)
            + " — lower bm or t, or plan for a device with more fast memory")
    return ExecutionPlan(policy=policy, shape=shape, dtype=dtype, spec=spec,
                         bm=bm, bn=bn, t=t, window_rows=win, vmem_bytes=vmem,
                         device=device, masked=masked)


def plan_for(shape, dtype, spec: StencilSpec, policy: str, *,
             bm: int | None = None, t: int | None = None,
             device: str | DeviceModel | None = None,
             masked: bool = False, bn: int | None = None) -> ExecutionPlan:
    """Resolve (and cache) an :class:`ExecutionPlan` for static arguments.

    ``bm``/``bn``/``t`` are requests; the plan holds the realized values.
    Under the row-block rule ``bm`` snaps to the largest interior-row
    divisor and ``bn`` is the interior width; under the 2-D rule both are
    clipped to the interior and default to :data:`GPU_TILES` (K2's and
    K3's ``bn`` then halved by :func:`sweep_bn` for a tall ``bm``; a K1
    that runs from shared memory to :data:`GPU_TILE_TEMPORAL_SMEM`); a
    compiled K1 geometry also clips ``bn`` to ``TEMPORAL_ROW - 2·t·r``.
    ``t`` is forced to 1 for non-temporal policies. ``device`` is a
    registry name or model; None plans against
    :func:`~repro_torch.engine.device.detect`.
    """
    dev = get_device(device)
    t_eff = (t if t is not None else DEFAULT_T) if policy == "temporal" else 1
    tile = GPU_TILES.get(policy, GPU_TILES["rowchunk"])
    if policy == "temporal" and not register_pipeline(spec, t_eff, masked):
        tile = GPU_TILE_TEMPORAL_SMEM
    if bm is None:
        bm = tile[0] if tiles_2d(dev) else DEFAULT_BM
    if bn is None:
        bn = tile[1]
        if tiles_2d(dev) and policy in ("rowchunk", "dbuf"):
            bn = sweep_bn(policy, getattr(torch, dtype_name(dtype)).itemsize,
                          spec, bm, bn, dev)
    misses0 = _metrics.counter("engine.plan.miss").value
    plan = _plan_cached(tuple(int(s) for s in shape), dtype_name(dtype),
                        spec, policy, int(bm), int(bn), int(t_eff), dev,
                        bool(masked))
    if _metrics.counter("engine.plan.miss").value == misses0:
        _metrics.counter("engine.plan.hit").inc()
    return plan


def plan_cache_info():
    """lru_cache statistics for the plan cache (hits/misses/currsize)."""
    return _plan_cached.cache_info()


def plan_cache_clear() -> None:
    _plan_cached.cache_clear()

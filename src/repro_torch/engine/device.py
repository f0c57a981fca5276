"""Device models: plan against the hardware you're on, not a constant.

The port's copy of ``repro.engine.device``: the same :class:`DeviceModel`
fields and the same four registered models with the same values, so a
plan for ``tpu_v5e``, ``grayskull_e150`` or ``cpu_ref`` equals the JAX
package's. :func:`detect` asks PyTorch instead of JAX: a CUDA card of
compute capability (9, 0) is ``gpu_sm90``; anything else, or no CUDA, is
``cpu_ref``.

All numbers are *modeling constants* (vendor peaks, paper-quoted
figures), not measurements.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """Everything the planning/model stack needs to know about one chip.

    ``fast_memory_bytes`` is the per-core budget the planner validates
    kernel windows against (TPU VMEM, Tensix SRAM, GPU shared memory, CPU
    last-level cache slice). ``peak_flops`` is the per-chip peak at
    ``preferred_dtype``; ``vector_flops`` is the elementwise (non-matmul)
    throughput stencil math actually runs at. Bandwidths are bytes/s:
    ``dram_bw`` per chip, ``interconnect_bw`` per on-board/pod link (ICI,
    NVLink, PCIe), ``inter_node_bw`` across nodes/pods (DCI, Ethernet).

    The trailing defaulted fields describe the on-chip transport fabric the
    :mod:`repro.backends` simulator steps over: the native fast-memory tile
    (32x32 for Tensix, (8,128) for a TPU lane tile), how many circular
    buffers one core's SRAM can host, how many NoCs carry DRAM traffic,
    per-hop latency, the effective per-core streaming bandwidth
    (``noc_bw``; 0 means "no separate NoC constraint, use ``dram_bw``"),
    the per-DMA-descriptor issue cost, and the physical core grid
    (``core_grid``; None derives a near-square grid from ``cores``).
    """

    name: str
    backend: str              # the backend tag this model stands for
    description: str
    cores: int                # compute units each owning a fast-memory bank
    fast_memory_bytes: int
    preferred_dtype: str
    peak_flops: float
    vector_flops: float
    dram_bw: float
    interconnect_bw: float
    inter_node_bw: float
    tdp_watts: float
    # --- NoC / tile fabric (consumed by repro.backends) -------------------
    tile_rows: int = 32
    tile_cols: int = 32
    cb_count: int = 16        # circular buffers a core's SRAM can host
    noc_count: int = 1        # independent NoCs usable for DRAM streams
    noc_hop_latency_s: float = 1e-8
    noc_bw: float = 0.0       # per-core streaming bytes/s; 0 -> dram_bw
    txn_overhead_s: float = 1e-6  # per-DMA-descriptor issue cost
    core_grid: tuple[int, int] | None = None
    # Whether mesh neighbours exchange halos over the direct interconnect
    # (ICI/NVLink). False means the paper's §VII situation: isolated cards
    # whose inter-device traffic must bounce through the host, so halo
    # exchange is billed at ``inter_node_bw`` instead.
    mesh_direct_links: bool = True

    @property
    def stream_bw(self) -> float:
        """Effective per-core DRAM streaming bandwidth (bytes/s)."""
        return self.noc_bw if self.noc_bw > 0 else self.dram_bw

    @property
    def grid(self) -> tuple[int, int]:
        """Physical (rows, cols) core layout; derived near-square if unset."""
        if self.core_grid is not None:
            return self.core_grid
        rows = max(1, int(self.cores ** 0.5))
        while self.cores % rows:
            rows -= 1
        return (rows, self.cores // rows)

    @property
    def halo_link_bw(self) -> float:
        """Bytes/s one mesh halo exchange rides: the direct interconnect,
        or the host-mediated inter-node pipe when neighbour devices cannot
        read each other's memory (``mesh_direct_links=False``)."""
        return self.interconnect_bw if self.mesh_direct_links \
            else self.inter_node_bw


_REGISTRY: dict[str, DeviceModel] = {}


def register_device(model: DeviceModel) -> DeviceModel:
    if model.name in _REGISTRY:
        raise ValueError(f"device {model.name!r} already registered")
    _REGISTRY[model.name] = model
    return model


def available_devices() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def device_registry() -> tuple[DeviceModel, ...]:
    return tuple(_REGISTRY.values())


def get_device(device: str | DeviceModel | None = None) -> DeviceModel:
    """Resolve a registry name (or pass a model through); None -> detect()."""
    if device is None:
        return detect()
    if isinstance(device, DeviceModel):
        return device
    try:
        return _REGISTRY[device]
    except KeyError:
        raise ValueError(
            f"unknown device model {device!r}; registered: "
            f"{available_devices()}") from None


def detect() -> DeviceModel:
    """The registered model for the card this process would launch on.

    ``gpu_sm90`` when CUDA is available and device 0 has compute
    capability (9, 0) (H100, H200); ``cpu_ref`` otherwise, including a
    CUDA card of another generation, whose kernels this port does not
    build.
    """
    if torch.cuda.is_available() and \
            torch.cuda.get_device_capability(0) == (9, 0):
        return _REGISTRY["gpu_sm90"]
    return _REGISTRY["cpu_ref"]


# ---------------------------------------------------------------------------
# The registry. Order matters only for detect()'s first-match rule.
# ---------------------------------------------------------------------------

TPU_V5E = register_device(DeviceModel(
    name="tpu_v5e",
    backend="tpu",
    description="TPU v5e chip (the repo's reproduction substrate)",
    cores=1,
    # Conservative per-kernel VMEM window budget (the chip has far more;
    # this is the planning headroom the kernels were validated under, and
    # the legacy plan.VMEM_BUDGET_BYTES value).
    fast_memory_bytes=16 * 2**20,
    preferred_dtype="bfloat16",
    peak_flops=197e12,         # bf16 MXU peak
    vector_flops=197e12 / 50,  # VPU elementwise planning number
    dram_bw=819e9,
    interconnect_bw=50e9,      # ICI per link, one direction
    inter_node_bw=6.25e9,      # DCI (assumed 50 Gbit)
    tdp_watts=215.0,
    tile_rows=8,               # native VMEM lane tile for f32
    tile_cols=128,
    cb_count=16,               # staging-buffer file modeled as Tensix-equivalent
    noc_count=1,
    noc_hop_latency_s=5e-9,
    noc_bw=0.0,                # monolithic chip: DRAM bw is the constraint
    txn_overhead_s=1e-6,       # the legacy benchmarks TXN_OVERHEAD_S value
    core_grid=(1, 1),
))

GRAYSKULL_E150 = register_device(DeviceModel(
    name="grayskull_e150",
    backend="tt",
    description="Tenstorrent Grayskull e150 (the paper's accelerator)",
    cores=108,                 # Tensix cores the paper could use
    fast_memory_bytes=int(1.5 * 2**20),  # per-core Tensix SRAM
    preferred_dtype="bfloat16",
    peak_flops=92e12,          # vendor-quoted BF16 matmul peak
    # Paper Table II compute-only: 1.387 GPt/s/core x 5 flops/pt -> ~7
    # GFLOP/s per core of non-matmul stencil math, x108 cores.
    vector_flops=0.75e12,
    dram_bw=118.4e9,           # 8 ch LPDDR4
    interconnect_bw=32e9,      # PCIe gen4 x16 to the host
    # The paper's cards cannot exchange halos directly (§VII); anything
    # inter-card rides host PCIe+memory, modeled as a thin pipe.
    inter_node_bw=1.25e9,
    tdp_watts=200.0,
    tile_rows=32,              # Tensix math works on 32x32 bf16 tiles
    tile_cols=32,
    cb_count=16,               # tt-metal exposes 16 circular buffers per core
    noc_count=2,               # two NoCs; page interleaving can split streams
    # Effective constants fit to the paper's Table III single-core access
    # sweep: a 4096^2 int32 read+write stream lands at 0.011 s (~12 GB/s
    # through one core), the 4 B-batch row implies ~105 ns per descriptor,
    # and the per-access-sync row a ~33 ns/hop round-trip share.
    noc_hop_latency_s=3.3e-8,
    noc_bw=12e9,
    txn_overhead_s=1.05e-7,
    core_grid=(9, 12),         # the 108 usable cores of the e150
    mesh_direct_links=False,   # cards can't read each other's DRAM (§VII)
))

GPU_SM90 = register_device(DeviceModel(
    name="gpu_sm90",
    backend="gpu",
    description="H100-class SM90 GPU",
    cores=132,                 # SMs
    fast_memory_bytes=227 * 2**10,  # usable shared memory per SM
    preferred_dtype="bfloat16",
    peak_flops=989e12,         # bf16 tensor-core dense
    vector_flops=67e12,        # fp32 CUDA-core throughput
    dram_bw=3.35e12,
    interconnect_bw=450e9,     # NVLink per direction
    inter_node_bw=50e9,        # 400 Gbit NIC
    tdp_watts=700.0,
    tile_rows=32,
    tile_cols=32,
    cb_count=16,
    noc_count=1,
    noc_hop_latency_s=2e-9,
    noc_bw=25e9,               # ~per-SM share of HBM at full occupancy
    txn_overhead_s=2e-7,
    core_grid=(11, 12),
))

CPU_REF = register_device(DeviceModel(
    name="cpu_ref",
    backend="cpu",
    description="24-core Xeon (the paper's CPU baseline class)",
    cores=24,
    fast_memory_bytes=32 * 2**20,  # shared L3
    preferred_dtype="float32",
    peak_flops=1.8e12,         # 24 cores x AVX-512 fp32
    vector_flops=1.8e12,       # the vector units *are* the peak on CPU
    dram_bw=128e9,             # 6-channel DDR4
    interconnect_bw=41.6e9,    # UPI
    inter_node_bw=12.5e9,      # 100 Gbit NIC
    tdp_watts=205.0,
    tile_rows=1,               # AVX-512 f32 vector as the "tile"
    tile_cols=16,
    cb_count=16,
    noc_count=1,
    noc_hop_latency_s=1e-8,
    noc_bw=12e9,               # per-core share of DRAM under all-core load
    txn_overhead_s=1e-7,
    core_grid=(4, 6),
))

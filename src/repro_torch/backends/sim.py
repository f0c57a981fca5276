"""Functional simulator for :class:`~repro_torch.backends.ir.TensixProgram`.

Runs a lowered program over a grid of virtual Tensix cores and returns
*both* the numeric result and the cost of producing it: every DRAM
descriptor, NoC hop, tile repack, and f32 tap flop is counted per kernel
(reader / compute / writer), and a step model prices them against the
device's NoC/DRAM parameters (:mod:`repro_torch.engine.device`).

Execution is block-serial but *accounted* as the decoupled pipeline the
hardware runs: each grid block passes through the reader, compute, and
writer op lists in order (circular-buffer occupancy is checked at every
push/pop — a CB sized too small overflows here, a consumer with no
producer underflows), and the block's wall-clock charge is

  * ``max(reader, compute, writer)`` when every CB has >= 2 slots (the
    kernels overlap adjacent blocks — dbuf), floor-bounded by the shared
    NoC pipe when reads and writes ride the same NoC, or
  * ``reader + compute + writer`` when any CB is single-slot (the
    producer must wait for the consumer — rowchunk/temporal).

Blocks round-robin over ``min(nblocks, device.cores)`` cores placed on the
device's physical ``core_grid``; the chip-level time is the busiest core's
pipeline time, floor-bounded by the chip DRAM and vector-unit rooflines.
The numerics mirror the engine kernels op-for-op (f32 tap accumulation in
spec order, Dirichlet re-pinning for temporal), so the row-major path is
bit-exact against ``engine.run`` in fp32 and the tilized path agrees to
bf16 tolerance — the equivalence tier-1 asserts.

``simulate(mesh_shape=...)`` extends the step model across a device mesh:
the counters-derived chip rate prices each shard's compute and every halo
round is billed over the device's halo link, either serially or
double-buffered (``overlap=True`` — exchange hidden under the
halo-independent interior, rind strips patched in after), so the paper's
multi-card what-if is visible from the simulator too.

The port's copy of ``repro.backends.sim``. The numerics run in torch on
the input tensor's device, op for op as the reference runs them in numpy
(f32 tap accumulation in spec order, ``torch.roll``'s wrap in the local
sweeps, re-pinning through the fixed set, subnormals flushed in the
finished sum only), so a simulated grid equals the JAX simulator's bit
for bit on the CPU and the card alike. The simulator flushes less than
the engine does (the engine flushes every operation, as XLA does): the
two agree until a diffusion front's tail goes subnormal.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.stencil import (F32_TINY, StencilSpec, f32,
                                      jacobi_2d_5pt)
from repro_torch.engine.device import DeviceModel
from repro_torch.engine.schedule import (DEFAULT_REMAINDER_POLICY,
                                         ExchangeBill, build_schedule,
                                         price_exchange)
from repro_torch.backends.lower import lower as _lower
from repro_torch.backends.ir import (BackendError, CBOverflowError,
                                     CBUnderflowError, LocalSweeps,
                                     ReadBlock, TapCombine, TapReduce,
                                     TensixProgram, Tilize, Untilize,
                                     WriteBlock, tile_grid, tilize,
                                     torch_dtype, untilize)
from repro_torch.obs.trace import get_tracer, span as _obs_span


@dataclasses.dataclass
class KernelCounters:
    """What one kernel class (reader/compute/writer) did, summed."""

    bytes: int = 0
    txns: int = 0
    tiles: int = 0
    flops: int = 0
    hops: int = 0
    seconds: float = 0.0

    def merge(self, other: "KernelCounters") -> None:
        self.bytes += other.bytes
        self.txns += other.txns
        self.tiles += other.tiles
        self.flops += other.flops
        self.hops += other.hops
        self.seconds += other.seconds


@dataclasses.dataclass
class SimCounters:
    reader: KernelCounters = dataclasses.field(default_factory=KernelCounters)
    compute: KernelCounters = dataclasses.field(default_factory=KernelCounters)
    writer: KernelCounters = dataclasses.field(default_factory=KernelCounters)
    sweeps: int = 0
    blocks: int = 0

    def merge(self, other: "SimCounters") -> None:
        self.reader.merge(other.reader)
        self.compute.merge(other.compute)
        self.writer.merge(other.writer)
        self.sweeps += other.sweeps
        self.blocks += other.blocks

    @property
    def dram_bytes(self) -> int:
        return self.reader.bytes + self.writer.bytes

    def as_dict(self) -> dict:
        return {k: dataclasses.asdict(getattr(self, k))
                for k in ("reader", "compute", "writer")} | {
                    "sweeps": self.sweeps, "blocks": self.blocks}


@dataclasses.dataclass
class SimResult:
    """Numeric result + the modeled cost of producing it."""

    grid: torch.Tensor
    counters: SimCounters
    model_time_s: float
    device: DeviceModel
    cores_used: int
    programs: tuple[TensixProgram, ...]
    #: Mesh runs only (``simulate(mesh_shape=...)``): the per-shard halo
    #: exchange bill, serial vs overlapped, priced at this simulation's
    #: counters-derived compute rate. ``model_time_s`` is then the chosen
    #: side of the bill instead of the single-chip time.
    exchange_model: ExchangeBill | None = None

    @property
    def interior_points(self) -> int:
        r = self.programs[0].spec.radius
        h, w = self.grid.shape
        return (h - 2 * r) * (w - 2 * r)


class _CBState:
    """Occupancy-checked circular buffers for one core's SRAM."""

    def __init__(self, prog: TensixProgram):
        self.caps = {cb.name: cb.capacity_tiles for cb in prog.cbs}
        self.dtypes = {cb.name: cb.dtype for cb in prog.cbs}
        self.layouts = {cb.name: cb.layout for cb in prog.cbs}
        self.occ = {cb.name: 0 for cb in prog.cbs}
        self.peak = {cb.name: 0 for cb in prog.cbs}
        self.data: dict[str, dict] = {}
        self.prog = prog

    def push(self, name: str, entry: dict) -> None:
        n = entry["tiles"]
        if self.occ[name] + n > self.caps[name]:
            raise CBOverflowError(
                f"CB {name!r} overflow: pushing {n} tiles onto "
                f"{self.occ[name]} resident exceeds capacity "
                f"{self.caps[name]} (program {self.prog.policy!r})")
        self.occ[name] += n
        self.peak[name] = max(self.peak[name], self.occ[name])
        self.data.setdefault(name, []).append(entry)  # FIFO ring order

    def pop(self, name: str) -> dict:
        queue = self.data.get(name)
        if not queue:
            raise CBUnderflowError(
                f"CB {name!r} underflow: consumer popped with "
                f"{self.occ[name]} tiles resident and no pending block "
                f"(program {self.prog.policy!r})")
        entry = queue.pop(0)
        self.occ[name] -= entry["tiles"]
        return entry


def _ftz(a: torch.Tensor) -> torch.Tensor:
    """Flush f32 subnormals to zero in a finished tap sum (the reference
    simulator's rule: the sum only, not each operation)."""
    return a.masked_fill_(a.abs() < F32_TINY, 0.0)


def _entry_2d(entry: dict) -> torch.Tensor:
    if entry["tilized"]:
        return untilize(entry["tiles_arr"], entry["rows"], entry["cols"])
    return entry["data"]


def _block_entry(data: torch.Tensor, dev: DeviceModel) -> dict:
    nty, ntx = tile_grid(*data.shape, dev.tile_rows, dev.tile_cols)
    return {"data": data, "rows": data.shape[0], "cols": data.shape[1],
            "tiles": nty * ntx, "tilized": False, "row_start": None}


def _vector_rate(dev: DeviceModel) -> float:
    """Per-core elementwise op rate (ops/s)."""
    return max(dev.vector_flops / max(dev.cores, 1), 1.0)


def _xfer_seconds(bytes_: int, txns: int, hops: int, dev: DeviceModel,
                  pipe_bw: float, sync: bool) -> float:
    if sync:
        seg = bytes_ / max(txns, 1)
        return txns * (dev.txn_overhead_s + seg / pipe_bw
                       + 2 * hops * dev.noc_hop_latency_s)
    return max(bytes_ / pipe_bw, txns * dev.txn_overhead_s) \
        + hops * dev.noc_hop_latency_s


def _run_block(prog: TensixProgram, u: torch.Tensor, out: torch.Tensor,
               block: int, hops: int, counters: SimCounters,
               pipe_bw: float, mask: torch.Tensor | None = None
               ) -> tuple[float, float, float, int, dict]:
    """Execute one grid block through reader -> compute -> writer.

    Returns the three stage times, the block's DRAM byte count, and the
    per-CB peak tile occupancy this block reached; numeric effects land
    in ``out``. ``mask`` is the second DRAM stream masked-temporal
    programs read their pin cells from.
    """
    dev = prog.plan.device
    plan = prog.plan
    r = plan.spec.radius
    h, w = plan.shape
    row0 = r + block * plan.bm
    gdtype = torch_dtype(plan.dtype)
    db = gdtype.itemsize
    cbs = _CBState(prog)
    vec = _vector_rate(dev)
    tr = tc = tw = 0.0
    blk_bytes = 0

    for op in prog.reader:
        if isinstance(op, ReadBlock):
            if op.src == "mask":
                if mask is None:
                    raise BackendError(
                        f"program {prog.policy!r} reads a pin-mask stream "
                        f"but the simulator was given no mask")
                src_arr = mask
            else:
                src_arr = u
            start = row0 + op.dy
            if op.clamp:
                start = min(max(start, 0), h - op.rows)
            data = src_arr[start:start + op.rows, op.col0:op.col0 + op.cols]
            entry = _block_entry(data, dev)
            entry["row_start"] = start
            cbs.push(op.cb, entry)
            nbytes = op.reads * op.rows * op.cols * db
            txns = op.txns()
            counters.reader.bytes += nbytes
            counters.reader.txns += txns
            counters.reader.hops += hops * txns if op.sync else hops
            blk_bytes += nbytes
            tr += _xfer_seconds(nbytes, txns, hops, dev, pipe_bw, op.sync)
        elif isinstance(op, Tilize):
            tr += _do_tilize(op, cbs, dev, counters.reader, vec)
    for op in prog.compute:
        if isinstance(op, TapReduce):
            e = cbs.pop(op.src)
            c = _entry_2d(e).to(torch.float32)
            acc = None
            for (dy, dx), wt in zip(prog.spec.offsets, prog.spec.weights):
                tap = c[op.row_off + dy:op.row_off + dy + op.out_rows,
                        op.col_off + dx:op.col_off + dx + op.out_cols]
                term = tap * f32(wt)
                acc = term if acc is None else acc + term
            _push_result(cbs, op.dst, _ftz(acc), dev)
            flops = 2 * prog.spec.taps * op.out_rows * op.out_cols
            counters.compute.flops += flops
            tc += flops / vec
        elif isinstance(op, TapCombine):
            acc = None
            for name, wt in zip(op.srcs, prog.spec.weights):
                tap = _entry_2d(cbs.pop(name)).to(torch.float32)
                term = tap * f32(wt)
                acc = term if acc is None else acc + term
            _push_result(cbs, op.dst, _ftz(acc), dev)
            flops = 2 * prog.spec.taps * acc.numel()
            counters.compute.flops += flops
            tc += flops / vec
        elif isinstance(op, LocalSweeps):
            e = cbs.pop(op.src)
            c0 = _entry_2d(e).to(torch.float32)
            ws = e["row_start"]
            win = e["rows"]
            if op.mask is not None:
                # Explicit pin set (distributed-shard form): the mask CB
                # holds the same window of the mask stream.
                fixed = _entry_2d(cbs.pop(op.mask)) != 0
            else:
                grow = ws + torch.arange(win, device=c0.device)[:, None]
                gcol = torch.arange(w, device=c0.device)[None, :]
                fixed = ((grow < r) | (grow >= h - r)
                         | (gcol < r) | (gcol >= w - r))
            c = c0
            for _ in range(op.t):
                acc = None
                for (dy, dx), wt in zip(prog.spec.offsets, prog.spec.weights):
                    term = torch.roll(c, (-dy, -dx), dims=(0, 1)) * f32(wt)
                    acc = term if acc is None else acc + term
                c = torch.where(fixed, c0, _ftz(acc))
            lo = row0 - ws
            _push_result(cbs, op.dst, c[lo:lo + plan.bm, :], dev)
            # Full-window sweeps: the redundant halo compute is the price
            # of the t-fold traffic cut, so it is charged, not hidden.
            flops = 2 * prog.spec.taps * win * w * op.t
            counters.compute.flops += flops
            tc += flops / vec
        elif isinstance(op, Tilize):
            tc += _do_tilize(op, cbs, dev, counters.compute, vec)
        elif isinstance(op, Untilize):
            tc += _do_untilize(op, cbs, dev, counters.compute, vec)
    for op in prog.writer:
        if isinstance(op, Untilize):
            tw += _do_untilize(op, cbs, dev, counters.writer, vec)
        elif isinstance(op, WriteBlock):
            e = cbs.pop(op.cb)
            data = _entry_2d(e).to(gdtype)
            out[row0 + op.dy:row0 + op.dy + op.rows,
                op.col0:op.col0 + op.cols] = data
            nbytes = op.rows * op.cols * db
            txns = op.txns()
            counters.writer.bytes += nbytes
            counters.writer.txns += txns
            counters.writer.hops += hops * txns if op.sync else hops
            blk_bytes += nbytes
            tw += _xfer_seconds(nbytes, txns, hops, dev, pipe_bw, op.sync)
    return tr, tc, tw, blk_bytes, dict(cbs.peak)


def _push_result(cbs: _CBState, dst: str, acc: torch.Tensor,
                 dev: DeviceModel, row_start: int | None = None) -> None:
    """Pack a compute result into ``dst`` in that CB's declared layout
    (the packer writes tiles directly when the CB holds tiles)."""
    data = acc.to(torch_dtype(cbs.dtypes[dst]))
    if cbs.layouts[dst] == "tiles":
        tiles_arr = tilize(data, dev.tile_rows, dev.tile_cols)
        entry = {"tiles_arr": tiles_arr, "rows": data.shape[0],
                 "cols": data.shape[1],
                 "tiles": tiles_arr.shape[0] * tiles_arr.shape[1],
                 "tilized": True, "row_start": row_start}
    else:
        entry = _block_entry(data, dev)
        entry["row_start"] = row_start
    cbs.push(dst, entry)


def _do_tilize(op: Tilize, cbs: _CBState, dev: DeviceModel,
               kc: KernelCounters, vec: float) -> float:
    e = cbs.pop(op.src)
    arr = _entry_2d(e)
    tiles_arr = tilize(arr, dev.tile_rows, dev.tile_cols,
                       dtype=cbs.dtypes[op.dst])
    nty, ntx = tiles_arr.shape[:2]
    entry = {"tiles_arr": tiles_arr, "rows": arr.shape[0],
             "cols": arr.shape[1], "tiles": nty * ntx, "tilized": True,
             "row_start": e["row_start"]}
    cbs.push(op.dst, entry)
    padded = nty * ntx * dev.tile_rows * dev.tile_cols
    kc.tiles += nty * ntx
    return padded / vec


def _do_untilize(op: Untilize, cbs: _CBState, dev: DeviceModel,
                 kc: KernelCounters, vec: float) -> float:
    e = cbs.pop(op.src)
    arr = untilize(e["tiles_arr"], e["rows"], e["cols"],
                   dtype=cbs.dtypes[op.dst])
    entry = _block_entry(arr, dev)
    entry["row_start"] = e["row_start"]
    cbs.push(op.dst, entry)
    kc.tiles += e["tiles"]
    return e["tiles"] * dev.tile_rows * dev.tile_cols / vec


def run_program(u: torch.Tensor, prog: TensixProgram, *,
                core_times: dict[int, float] | None = None,
                mask: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, SimCounters, dict[int, float]]:
    """Advance ``u`` by one execution of ``prog`` over the virtual cores.

    Returns (new grid, counters for this execution, per-core busy seconds —
    cumulative when ``core_times`` is passed in). ``mask`` supplies the
    pin-mask DRAM stream masked-temporal programs read.
    """
    from repro_torch.analysis.verify import raise_if_rejected
    raise_if_rejected(prog)
    dev = prog.plan.device
    nblocks = prog.plan.nblocks
    ncores = min(nblocks, dev.cores)
    gy, gx = dev.grid
    pipe_bw = dev.stream_bw * (dev.noc_count if prog.interleaved else 1)
    counters = SimCounters()
    core_times = {} if core_times is None else core_times
    out = u.clone()
    tracer = get_tracer()
    for i in range(nblocks):
        core = i % ncores
        cy, cx = divmod(core % (gy * gx), gx)
        # Manhattan distance to the DRAM controller column/row at the grid
        # center (Grayskull's controllers sit mid-die; corner cores pay the
        # longest NoC path, which is what per-access sync exposes).
        hops = abs(cy - (gy - 1) // 2) + abs(cx - (gx - 1) // 2) + 1
        tr, tc, tw, blk_bytes, cb_peaks = _run_block(prog, u, out, i, hops,
                                                     counters, pipe_bw,
                                                     mask=mask)
        counters.reader.seconds += tr
        counters.compute.seconds += tc
        counters.writer.seconds += tw
        if prog.double_buffered:
            # Overlapped kernels: the slowest stage paces the pipeline, but
            # reads and writes share the core's NoC pipe, so the block's
            # combined DRAM traffic over that pipe is a hard floor.
            blk = max(tr, tc, tw, blk_bytes / pipe_bw)
        else:
            blk = tr + tc + tw
        core_times[core] = core_times.get(core, 0.0) + blk
        counters.blocks += 1
        if tracer is not None:
            # Counter tracks, one sample per block: cumulative modeled
            # busy time per core and this block's per-CB peak tiles.
            tracer.counter("sim.core_busy_s",
                           {f"core{c}": v
                            for c, v in sorted(core_times.items())})
            tracer.counter("sim.cb_occupancy", cb_peaks)
    counters.sweeps += prog.plan.t if prog.policy == "temporal" else 1
    return out, counters, core_times


def _chip_time(counters: SimCounters, core_times: dict[int, float],
               dev: DeviceModel) -> float:
    """Busiest-core pipeline time, floored by the chip-level rooflines."""
    per_core = max(core_times.values()) if core_times else 0.0
    dram = counters.dram_bytes / dev.dram_bw
    vector = counters.compute.flops / max(dev.vector_flops, 1.0)
    return max(per_core, dram, vector)


def simulate(u: torch.Tensor, spec: StencilSpec | None = None, *,
             policy: str = "auto", iters: int = 1, bm: int | None = None,
             t: int | None = None, device: str | DeviceModel | None = None,
             tilized: bool | None = None, interleaved: bool = False,
             mask=None,
             remainder_policy: str = DEFAULT_REMAINDER_POLICY,
             mesh_shape: tuple | None = None,
             overlap: bool = False) -> SimResult:
    """Advance a ringed grid ``iters`` sweeps through the lowered backend.

    The contract mirrors :func:`repro_torch.engine.run` exactly — same
    policy names (``"auto"`` resolves the device-aware heuristic), and the
    *same* :class:`~repro_torch.engine.schedule.SweepSchedule` decides how
    ``iters`` split into fused round-trips plus a non-fused remainder —
    but execution goes through lowering and the functional simulator, so
    the result carries per-kernel counters and a modeled chip time
    alongside the numbers. ``u`` is a torch tensor; the numerics run on
    its device and ``SimResult.grid`` lies there too. ``device`` names
    the modeled chip (a registry name or model). ``mask`` (optional,
    grid-shaped, nonzero = pinned) lowers fused blocks in their masked
    distributed-shard form, with the pin set streamed from DRAM instead
    of derived from the ring geometry.

    ``mesh_shape`` (e.g. ``(4,)`` for the paper's four cards) extends the
    step model across a device mesh: the grid decomposes into shards, the
    simulated chip's counters-derived rate (seconds per point per sweep,
    already embodying the NoC/DRAM/vector step model) prices each shard's
    compute, and every halo round is billed over
    :attr:`~repro_torch.engine.device.DeviceModel.halo_link_bw` through
    :func:`~repro_torch.engine.schedule.price_exchange`. ``overlap``
    selects the double-buffered bill — exchange hidden under the
    halo-independent interior, ``max(exchange, interior) + rind`` —
    instead of the serial ``exchange + compute`` sum; ``model_time_s``
    becomes the chosen side and ``exchange_model`` carries the whole
    bill. Numerics are untouched (the simulated grid is the full-grid
    result either way).
    """
    spec = spec if spec is not None else jacobi_2d_5pt()
    shape, dtype = tuple(u.shape), u.dtype
    with _obs_span("sim.simulate", iters=iters, shape=shape,
                   requested_policy=policy) as sp:
        mask_t = None if mask is None else torch.as_tensor(
            mask, device=u.device).to(dtype)
        sched = build_schedule(iters, spec=spec, shape=shape, dtype=dtype,
                               policy=policy, t=t, bm=bm, device=device,
                               remainder_policy=remainder_policy,
                               torch_device=u.device.type)
        # Feasibility gates (masked-remainder, remainder policy, mesh
        # decomposition) live in the shared static checker; refuse with its
        # diagnostics rather than model the wrong schedule.
        from repro_torch.analysis.feasibility import check_schedule
        check_schedule(sched, shape=shape, dtype=dtype, spec=spec,
                       device=device, mesh_shape=mesh_shape,
                       masked=mask_t is not None
                       ).raise_if_errors(BackendError)

        programs = []
        prog_reps: list[tuple[TensixProgram, int]] = []
        if sched.fused:
            if sched.fused_blocks:
                prog = _lower(shape, dtype, spec, sched.policy, bm=bm,
                              t=sched.t, device=device, tilized=tilized,
                              masked=mask_t is not None)
                prog = dataclasses.replace(prog, interleaved=interleaved)
                prog_reps.append((prog, sched.fused_blocks))
            if sched.remainder or not prog_reps:
                # remainder == 0 with no program yet is iters == 0: lower
                # the remainder program with zero reps so the grid passes
                # through unchanged, like engine.run's zero-length loop.
                prog = _lower(shape, dtype, spec, sched.remainder_policy,
                              bm=bm, device=device, tilized=tilized)
                prog = dataclasses.replace(prog, interleaved=interleaved)
                prog_reps.append((prog, sched.remainder))
        else:
            prog = _lower(shape, dtype, spec, sched.policy, bm=bm,
                          device=device, tilized=tilized)
            prog = dataclasses.replace(prog, interleaved=interleaved)
            prog_reps.append((prog, sched.iters))

        total = SimCounters()
        core_times: dict[int, float] = {}
        for prog, reps in prog_reps:
            programs.append(prog)
            for _ in range(reps):
                u, counters, core_times = run_program(
                    u, prog, core_times=core_times, mask=mask_t)
                total.merge(counters)
        dev = programs[0].plan.device
        ncores = min(programs[0].plan.nblocks, dev.cores)
        model_time = _chip_time(total, core_times, dev)
        bill = None
        if mesh_shape is not None and math.prod(mesh_shape) > 1:
            bill = _mesh_exchange_bill(sched, shape, dtype, spec, dev,
                                       mesh_shape, model_time)
            model_time = bill.overlapped_s if overlap else bill.serial_s
        # model_s is the modeled chip time: reconcile joins it against the
        # span's measured host-sim wall time, whose drift IS the
        # simulation-overhead factor.
        sp.set(policy=sched.policy, device=dev.name, cores_used=ncores,
               blocks=total.blocks, dram_bytes=total.dram_bytes,
               model_s=model_time)
        return SimResult(grid=u, counters=total, model_time_s=model_time,
                         device=dev, cores_used=ncores,
                         programs=tuple(programs), exchange_model=bill)


def _mesh_exchange_bill(sched, shape, dtype, spec: StencilSpec,
                        dev: DeviceModel, mesh_shape: tuple,
                        chip_time_s: float) -> ExchangeBill:
    """Price the simulated schedule's halo rounds over a device mesh.

    The single-chip simulation already stepped the whole grid through the
    NoC/DRAM model; its per-point-per-sweep rate carries that cost model
    into the per-shard interior/rind pricing, so the exchange-vs-compute
    tradeoff the distributed executor faces is visible from the backend
    simulator with the same geometry ``engine.price_exchange`` uses.
    """
    r = spec.radius
    hi, wi = shape[0] - 2 * r, shape[1] - 2 * r
    px = int(mesh_shape[0])
    py = int(mesh_shape[1]) if len(mesh_shape) > 1 else 1
    if hi % px or wi % py:
        raise BackendError(
            f"interior {hi}x{wi} does not decompose over mesh "
            f"{tuple(mesh_shape)}")
    d = sched.halo_depth
    ext_shard = (hi // px + 2 * d, wi // py + 2 * d)
    rate = chip_time_s / max(hi * wi * max(sched.iters, 1), 1)
    return price_exchange(sched, shard_shape=ext_shard, dtype=dtype,
                          spec=spec, device=dev, mesh_shape=mesh_shape,
                          compute_rate=rate)


def simulate_program(u: torch.Tensor, prog: TensixProgram, *,
                     reps: int = 1) -> SimResult:
    """Run an explicit program (e.g. a hand-built or copy program)."""
    total = SimCounters()
    core_times: dict[int, float] = {}
    for _ in range(reps):
        u, counters, core_times = run_program(u, prog,
                                              core_times=core_times)
        total.merge(counters)
    dev = prog.plan.device
    return SimResult(grid=u, counters=total,
                     model_time_s=_chip_time(total, core_times, dev),
                     device=dev,
                     cores_used=min(prog.plan.nblocks, dev.cores),
                     programs=(prog,))


def _smoke(device: str = "grayskull_e150", torch_device: str = "cuda"
           ) -> int:
    """Small-grid sim of every lowerable policy vs the plain oracle.

    The backends smoke: exercises lowering, CB bookkeeping, the step
    model, and numeric equivalence in a few seconds, on ``torch_device``
    (the card unless the caller asks for the CPU). Returns a process exit
    code.
    """
    from repro_torch.backends.lower import lowerable_policies
    from repro_torch.backends.report import summarize
    from repro_torch.core.stencil import apply_stencil, make_laplace_problem

    u = make_laplace_problem(32, 64, dtype=torch.float32, left=1.0,
                             right=0.0, device=torch_device)
    spec = jacobi_2d_5pt()
    want = u
    for _ in range(4):
        want = apply_stencil(want, spec)
    failures = 0
    for policy in lowerable_policies():
        res = simulate(u, spec, policy=policy, iters=4, t=2, device=device)
        ok = torch.equal(res.grid, want)
        failures += not ok
        s = summarize(res)
        print(f"{'ok  ' if ok else 'FAIL'} {policy:9s} "
              f"bytes/pt={s['bytes_per_point']:6.2f} "
              f"model={s['model_time_s'] * 1e6:8.1f}us "
              f"gpts={s['gpts']:7.3f} on {s['device']}")

    # Masked-temporal: the distributed-shard form. Pin a t*r-deep band on
    # the top/left (the shard's slice of the global ring); the bottom/right
    # edges play exchanged halo and must evolve with the fused sweeps.
    # Valid region = everything at least t*r away from an unpinned edge.
    t, d = 2, 2 * spec.radius
    h, w = u.shape
    mask = torch.zeros((h, w), dtype=torch.bool, device=u.device)
    mask[:d, :] = True
    mask[:, :d] = True
    res = simulate(u, spec, policy="temporal", iters=t, t=t, device=device,
                   mask=mask)
    wantm = u
    for _ in range(t):
        wantm = torch.where(mask, u, apply_stencil(wantm, spec))
    ok = torch.equal(res.grid[:h - d, :w - d], wantm[:h - d, :w - d])
    failures += not ok
    s = summarize(res)
    print(f"{'ok  ' if ok else 'FAIL'} {'temporal+mask':13s} "
          f"bytes/pt={s['bytes_per_point']:6.2f} "
          f"model={s['model_time_s'] * 1e6:8.1f}us on {s['device']}")
    print("BACKENDS SMOKE " + ("OK" if not failures else "FAILED"))
    return 1 if failures else 0

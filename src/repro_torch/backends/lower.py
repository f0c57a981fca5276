"""Lowering: ``StencilSpec x ExecutionPlan`` -> :class:`TensixProgram`.

Each registry policy lowers to the three-kernel program its Pallas twin
implies — the mapping *is* the paper's §IV→§VI arc, stated as IR:

  ``shifted``   one DRAM read per tap through a shared staging CB into
                per-tap operand CBs, combined tile-by-tile (§IV, the
                replicated-read design Table V prices);
  ``rowchunk``  one contiguous full-width window read, every tap served by
                a read-pointer view of the resident window (§VI);
  ``dbuf``      rowchunk with 2-slot CBs — reader fills block i+1 while
                compute drains block i (Table I "double buffering");
  ``temporal``  the window carries t*r extra halo rows and compute sweeps
                it t times in SRAM before one write-back (beyond paper).

Lowering is where the *device* becomes binding a second time: the plan
already proved the policy's working set fits fast memory, but the CB
layout adds tile padding, staging buffers, and slot replication, so the
summed CB footprint is re-validated against the DeviceModel SRAM budget
and the CB count against the device's CB file. Tilized programs hold CB
payloads as native (tile_rows x tile_cols) tiles in the device's preferred
compute dtype (bf16 on Tensix) with explicit Tilize/Untilize ops at the
unpacker/packer boundaries; row-major programs keep the grid dtype.

The port's copy of ``repro.backends.lower``. One rule is the port's own: a
Tensix program is row-blocked, and the port plans a GPU (``gpu_sm90``) in
2-D tiles. A 2-D plan lowers as the row-block plan of the same ``bm``
when its tile spans the whole interior width and ``bm`` divides the
interior height; any other 2-D plan raises :class:`LoweringError`, so no
lowering drops columns or rows.
"""
from __future__ import annotations

import dataclasses

from repro_torch.analysis.diagnostics import budget_message
from repro_torch.core.stencil import StencilSpec
from repro_torch.engine.device import DeviceModel, get_device
from repro_torch.engine.plan import (ExecutionPlan, _window_and_vmem,
                                     dtype_name, plan_for)
from repro_torch.backends.ir import (BackendError, CircularBuffer,
                                     LocalSweeps, ReadBlock, TapCombine,
                                     TapReduce, TensixProgram, Tilize,
                                     Untilize, WriteBlock, tile_grid,
                                     torch_dtype)


class LoweringError(BackendError):
    """A plan whose CB layout cannot be hosted by the target device."""


def _ntiles(rows: int, cols: int, dev: DeviceModel) -> int:
    nty, ntx = tile_grid(rows, cols, dev.tile_rows, dev.tile_cols)
    return nty * ntx


def _cb(name: str, rows: int, cols: int, dev: DeviceModel, dtype: str,
        slots: int = 1, layout: str = "row_major") -> CircularBuffer:
    return CircularBuffer(name=name, tile_rows=dev.tile_rows,
                          tile_cols=dev.tile_cols, dtype=dtype, slots=slots,
                          layout=layout,
                          capacity_tiles=slots * _ntiles(rows, cols, dev))


def _lower_shifted(spec, plan, dev, dtype, cdtype, tilized):
    bm, wi = plan.bm, plan.interior_shape[1]
    r = plan.radius
    cbs = [_cb("stage", bm, wi, dev, dtype)] if tilized else []
    reader, taps = [], []
    for k, (dy, dx) in enumerate(spec.offsets):
        name = f"tap{k}"
        taps.append(name)
        cbs.append(_cb(name, bm, wi, dev, cdtype if tilized else dtype,
                       slots=2,
                       layout="tiles" if tilized else "row_major"))
        # Each tap is an interior-shaped view at offset (dy, dx): rows
        # shift with the block, columns start at r+dx < full width, so
        # every tap stream is strided — the §IV design's traffic shape.
        reader.append(ReadBlock(cb="stage" if tilized else name, dy=dy,
                                rows=bm, col0=r + dx, cols=wi,
                                contiguous=False))
        if tilized:
            reader.append(Tilize(src="stage", dst=name))
    compute = [TapCombine(srcs=tuple(taps), dst="out")]
    cbs.append(_cb("out", bm, wi, dev, cdtype if tilized else dtype, slots=2,
                   layout="tiles" if tilized else "row_major"))
    writer = []
    if tilized:
        cbs.append(_cb("out_raw", bm, wi, dev, dtype, slots=2))
        writer.append(Untilize(src="out", dst="out_raw"))
    writer.append(WriteBlock(cb="out_raw" if tilized else "out", dy=0,
                             rows=bm, col0=r, cols=wi, contiguous=False))
    return cbs, tuple(reader), tuple(compute), tuple(writer)


def _lower_window(spec, plan, dev, dtype, cdtype, tilized, *, slots: int):
    """Shared rowchunk/dbuf lowering; ``slots`` is the CB depth."""
    bm, (_, wi) = plan.bm, plan.interior_shape
    r = plan.radius
    w = plan.shape[1]
    win = plan.window_rows
    cbs, reader, writer = [], [], []
    in_cb, out_cb = "in", "out"
    if tilized:
        cbs.append(_cb("in_raw", win, w, dev, dtype, slots=slots))
        reader.append(ReadBlock(cb="in_raw", dy=-r, rows=win, col0=0,
                                cols=w, contiguous=True))
        reader.append(Tilize(src="in_raw", dst="in"))
    else:
        reader.append(ReadBlock(cb="in", dy=-r, rows=win, col0=0, cols=w,
                                contiguous=True))
    cbs.append(_cb("in", win, w, dev, cdtype if tilized else dtype,
                   slots=slots, layout="tiles" if tilized else "row_major"))
    compute = [TapReduce(src=in_cb, dst=out_cb, row_off=r, col_off=r,
                         out_rows=bm, out_cols=wi)]
    cbs.append(_cb("out", bm, wi, dev, cdtype if tilized else dtype,
                   slots=slots, layout="tiles" if tilized else "row_major"))
    if tilized:
        cbs.append(_cb("out_raw", bm, wi, dev, dtype, slots=slots))
        writer.append(Untilize(src="out", dst="out_raw"))
    writer.append(WriteBlock(cb="out_raw" if tilized else "out", dy=0,
                             rows=bm, col0=r, cols=wi, contiguous=False))
    return cbs, tuple(reader), tuple(compute), tuple(writer)


def _lower_temporal(spec, plan, dev, dtype, cdtype, tilized):
    bm, r, t = plan.bm, plan.radius, plan.t
    h, w = plan.shape
    win = plan.window_rows
    cbs, reader, writer = [], [], []
    if tilized:
        cbs.append(_cb("in_raw", win, w, dev, dtype))
        reader.append(ReadBlock(cb="in_raw", dy=-t * r, rows=win, col0=0,
                                cols=w, contiguous=True, clamp=True))
        reader.append(Tilize(src="in_raw", dst="in"))
    else:
        reader.append(ReadBlock(cb="in", dy=-t * r, rows=win, col0=0,
                                cols=w, contiguous=True, clamp=True))
    cbs.append(_cb("in", win, w, dev, cdtype if tilized else dtype,
                   layout="tiles" if tilized else "row_major"))
    mask_cb = None
    if plan.masked:
        # The distributed-shard form: the pin mask streams in beside the
        # grid window (row-major bookkeeping data, never tilized) and the
        # sweeps re-pin exactly the cells it marks — the shard's slice of
        # the global Dirichlet ring, not the whole block edge.
        mask_cb = "mask"
        cbs.append(_cb(mask_cb, win, w, dev, dtype))
        reader.append(ReadBlock(cb=mask_cb, dy=-t * r, rows=win, col0=0,
                                cols=w, contiguous=True, clamp=True,
                                src="mask"))
    compute = [LocalSweeps(src="in", dst="out", t=t, mask=mask_cb)]
    cbs.append(_cb("out", bm, w, dev, cdtype if tilized else dtype,
                   layout="tiles" if tilized else "row_major"))
    if tilized:
        cbs.append(_cb("out_raw", bm, w, dev, dtype))
        writer.append(Untilize(src="out", dst="out_raw"))
    # t sweeps' central rows go back in one contiguous full-width write.
    writer.append(WriteBlock(cb="out_raw" if tilized else "out", dy=0,
                             rows=bm, col0=0, cols=w, contiguous=True))
    return cbs, tuple(reader), tuple(compute), tuple(writer)


_LOWERINGS = {
    "shifted": _lower_shifted,
    "rowchunk": lambda *a: _lower_window(*a, slots=1),
    "dbuf": lambda *a: _lower_window(*a, slots=2),
    "temporal": _lower_temporal,
}


def lowerable_policies() -> tuple[str, ...]:
    return tuple(_LOWERINGS)


def _row_blocks(plan: ExecutionPlan) -> ExecutionPlan:
    """``plan`` under the row-block rule: a 2-D plan whose tile spans the
    interior's width and whose ``bm`` divides its height becomes the
    row-block plan of that ``bm`` (window and footprint recomputed, and
    held to the device's fast memory as the row-block planner holds them);
    any other 2-D plan raises."""
    if not plan.tiled_2d:
        return plan
    hi, wi = plan.interior_shape
    if plan.bn < wi or hi % plan.bm:
        raise LoweringError(
            f"a Tensix program is row-blocked: the {plan.device.name} plan "
            f"for {plan.policy!r} tiles the {hi}x{wi} interior in "
            f"{plan.bm}x{plan.bn} blocks, and a row-block program needs "
            f"bn = {wi} and a bm that divides {hi}")
    win, vmem = _window_and_vmem(plan.policy, plan.shape, plan.dtype_bytes,
                                 plan.spec, plan.bm, plan.t, plan.masked)
    if vmem > plan.device.fast_memory_bytes:
        raise LoweringError(budget_message(
            f"policy {plan.policy!r} for grid {plan.shape} (bm={plan.bm}, "
            f"t={plan.t}) in row blocks", vmem, plan.device))
    return dataclasses.replace(plan, window_rows=win, vmem_bytes=vmem)


def lower_plan(plan: ExecutionPlan, *, tilized: bool | None = None
               ) -> TensixProgram:
    """Lower a resolved plan to a validated three-kernel program.

    ``tilized=None`` picks the native layout: tiles when the grid dtype is
    already the device's preferred compute dtype (bf16 grids on Tensix run
    tilized for free), row-major otherwise (the fp32-exact path).
    """
    try:
        build = _LOWERINGS[plan.policy]
    except KeyError:
        raise LoweringError(
            f"no lowering for policy {plan.policy!r}; lowerable: "
            f"{lowerable_policies()}") from None
    plan = _row_blocks(plan)
    dev = plan.device
    dtype = plan.dtype
    cdtype = dev.preferred_dtype
    if tilized is None:
        tilized = dtype == cdtype if cdtype == "bfloat16" else False
    cbs, reader, compute, writer = build(plan.spec, plan, dev, dtype,
                                         cdtype, tilized)
    prog = TensixProgram(policy=plan.policy, spec=plan.spec, plan=plan,
                         cbs=tuple(cbs), reader=reader, compute=compute,
                         writer=writer, tilized=bool(tilized))
    prog.validate()
    # Every lowering is gated on the static verifier: CB protocol
    # (overflow/underflow/deadlock), address bounds for all block indices,
    # and the device SRAM/CB-file budgets that used to be inline here.
    from repro_torch.analysis.verify import verify_program
    report = verify_program(prog)
    if not report.ok:
        raise LoweringError(report.describe())
    return prog


def lower(shape, dtype, spec: StencilSpec, policy: str, *,
          bm: int | None = None, t: int | None = None,
          device: str | DeviceModel | None = None,
          tilized: bool | None = None, masked: bool = False
          ) -> TensixProgram:
    """Plan (cached, device-validated) then lower in one call.

    ``masked`` lowers the temporal policy's distributed-shard form: an
    explicit pin-mask stream feeds the local sweeps instead of the
    geometric ring mask.
    """
    plan = plan_for(shape, dtype, spec, policy, bm=bm, t=t, device=device,
                    masked=masked)
    return lower_plan(plan, tilized=tilized)


# ---------------------------------------------------------------------------
# Pure data-movement programs (the paper's §V access-pattern experiments).
# ---------------------------------------------------------------------------

_IDENTITY = StencilSpec(offsets=((0, 0),), weights=(1.0,))


def make_copy_program(shape, dtype, *, bm: int = 256,
                      seg_cols: int | None = None, sync: bool = False,
                      reads: int = 1, interleaved: bool = False,
                      device: str | DeviceModel | None = None
                      ) -> TensixProgram:
    """A reader/writer-only stream program over ``shape``.

    ``seg_cols`` splits each row into per-descriptor segments of that many
    columns (the paper's Table III batch-size knob: 4096 int32 cols with
    ``seg_cols=4096`` is one 16 KB request per row, ``seg_cols=1`` is the
    4-byte-batch regime); ``sync`` waits out each descriptor round-trip
    (per-access synchronization); ``reads`` replays the stream (Table V
    replication); ``interleaved`` lets the stream spread over all of the
    device's NoCs (Table VI page interleaving).

    Like the paper's §V microbenchmarks, the stream runs through a single
    core (the device model is narrowed to ``cores=1``), so the result
    isolates the access pattern rather than core-count parallelism.
    """
    dev = dataclasses.replace(get_device(device), cores=1)
    h, w = (int(s) for s in shape)
    bm = min(bm, h)
    while h % bm:
        bm -= 1
    name = dtype_name(dtype)
    plan = ExecutionPlan(policy="copy", shape=(h, w), dtype=name,
                         spec=_IDENTITY, bm=bm, bn=w, t=1, window_rows=bm,
                         vmem_bytes=2 * bm * w * torch_dtype(name).itemsize,
                         device=dev)
    cbs = (_cb("in", bm, w, dev, plan.dtype, slots=2),)
    reader = (ReadBlock(cb="in", dy=0, rows=bm, col0=0, cols=w,
                        contiguous=seg_cols is None, seg_cols=seg_cols,
                        sync=sync, reads=reads),)
    writer = (WriteBlock(cb="in", dy=0, rows=bm, col0=0, cols=w,
                         contiguous=seg_cols is None, seg_cols=seg_cols,
                         sync=sync),)
    prog = TensixProgram(policy="copy", spec=_IDENTITY, plan=plan, cbs=cbs,
                         reader=reader, compute=(), writer=writer,
                         tilized=False, interleaved=interleaved)
    prog.validate()
    return prog

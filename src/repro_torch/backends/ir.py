"""Dataflow IR for decoupled data-movement/compute stencil programs.

The port's copy of ``repro.backends.ir``: the same ops, circular buffers,
validation and ``describe()`` text, with the layout transforms over torch
tensors (bf16 as ``torch.bfloat16``) instead of numpy arrays.

Grayskull's defining trait (paper §II–III) is that each Tensix core runs
*three* cooperating kernels — a reader moving DRAM→SRAM, a compute kernel,
and a writer moving SRAM→DRAM — that communicate only through named
*circular buffers* of fixed-size tiles in the core's SRAM. This module is
the executable description of such a program: a :class:`TensixProgram`
holds one op list per kernel plus the circular buffers they share, and the
tile layout ops (:class:`Tilize` / :class:`Untilize`, 32x32 bf16 tiles on
Tensix) are first-class citizens rather than an invisible host-side detail
— the paper's §V shows the tilized-vs-row-major choice is a performance
decision, so the IR must be able to express both.

Ops are frozen dataclasses with only static fields, so programs are
hashable values: the same ``StencilSpec x ExecutionPlan`` always lowers to
the same program, and a program can key caches exactly like a plan does.
Addressing is block-relative: the simulator executes a program once per
grid block ``i``, and every memory op resolves its region against the
block's first interior row ``row0 = r + i*bm`` (rows) and absolute column
offsets (columns — the engine's grids are row-blocked only).

``tilize``/``untilize`` at the bottom are the reference layout
transformations the simulator (and the round-trip tests) use.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.stencil import StencilSpec
from repro_torch.engine.plan import ExecutionPlan, dtype_name


def torch_dtype(name) -> torch.dtype:
    """torch dtype for a registry dtype name (or a torch dtype)."""
    return getattr(torch, dtype_name(name))


class BackendError(ValueError):
    """A program that cannot be built or executed."""


class CBOverflowError(BackendError):
    """A producer pushed more tiles than the circular buffer can hold."""


class CBUnderflowError(BackendError):
    """A consumer popped from a circular buffer with no resident data."""


@dataclasses.dataclass(frozen=True)
class CircularBuffer:
    """A named ring of ``capacity_tiles`` tile slots in one core's SRAM.

    ``slots`` is the block-level depth: 1 means the producer and consumer
    alternate on a single block's worth of tiles (no overlap), 2 means the
    classic double-buffer (producer fills slot ``i+1`` while the consumer
    drains slot ``i``) — the paper's Table I "double buffering" row is
    exactly a ``slots=1 -> slots=2`` change here.
    """

    name: str
    capacity_tiles: int
    tile_rows: int
    tile_cols: int
    dtype: str
    slots: int = 1
    layout: str = "row_major"  # "row_major" | "tiles" (payload layout)

    @property
    def tile_bytes(self) -> int:
        return self.tile_rows * self.tile_cols * torch_dtype(self.dtype).itemsize

    @property
    def sram_bytes(self) -> int:
        return self.capacity_tiles * self.tile_bytes


# ---------------------------------------------------------------------------
# Ops. reader := DRAM -> CB; compute := CB -> CB; writer := CB -> DRAM.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReadBlock:
    """DRAM -> CB: rows ``[row0+dy, row0+dy+rows)`` x cols ``[col0, col0+cols)``.

    ``contiguous`` marks full-width (single-descriptor-per-block) streams;
    a strided region costs one DRAM transaction per row instead, and
    ``seg_cols`` further splits each row into per-descriptor segments of
    that many columns (the paper's Table III request-size knob). ``clamp``
    clips the row window into the array (the temporal policy's boundary
    blocks). ``sync`` waits for each transaction round-trip before issuing
    the next (the paper's Table III per-access synchronization mode).
    ``reads`` > 1 replays the same region (Table V replicated reads).
    ``src`` names the DRAM stream the region comes from: ``"grid"`` (the
    stencil state) or ``"mask"`` (the masked-temporal shard program's
    pin-mask operand, supplied to the simulator alongside the grid).
    """

    cb: str
    dy: int
    rows: int
    col0: int
    cols: int
    contiguous: bool = True
    seg_cols: int | None = None
    clamp: bool = False
    sync: bool = False
    reads: int = 1
    src: str = "grid"

    def txns(self) -> int:
        """DRAM descriptors one execution of this op issues."""
        if self.seg_cols:
            return self.reads * self.rows * (-(-self.cols // self.seg_cols))
        return self.reads * (1 if self.contiguous else self.rows)


@dataclasses.dataclass(frozen=True)
class Tilize:
    """Repack a CB's row-major block into native (tile_rows x tile_cols)
    tiles, casting to the CB's compute dtype (bf16 on Tensix)."""

    src: str
    dst: str


@dataclasses.dataclass(frozen=True)
class Untilize:
    """Repack tiles back into a row-major block (output dtype of ``dst``)."""

    src: str
    dst: str


@dataclasses.dataclass(frozen=True)
class TapReduce:
    """Weighted sum of shifted in-SRAM views of one resident window.

    The §VI "CB read-pointer aliasing" op: every tap of the program's spec
    is served by a view of ``src`` at offset ``(row_off+dy, col_off+dx)``;
    the result is the ``(out_rows, out_cols)`` output block pushed to
    ``dst``. Accumulates in f32 like the engine kernels.
    """

    src: str
    dst: str
    row_off: int
    col_off: int
    out_rows: int
    out_cols: int


@dataclasses.dataclass(frozen=True)
class TapCombine:
    """Weighted sum across per-tap CBs (the §IV shifted-copy design: one
    operand stream per tap, combined tile-by-tile)."""

    srcs: tuple[str, ...]
    dst: str


@dataclasses.dataclass(frozen=True)
class LocalSweeps:
    """Advance the resident window ``t`` sweeps entirely in SRAM (temporal
    blocking), re-pinning Dirichlet cells between sweeps. The valid
    region shrinks by ``r`` rows/cols per sweep; the simulator charges the
    full-window redundant halo compute, which is the cost the schedule
    trades for DRAM traffic.

    Without ``mask`` the pinned set is the grid's own radius-``r`` ring
    (computed from geometry). With ``mask`` naming a CB, the pinned set is
    streamed in explicitly — the distributed-shard form, where only the
    shard's slice of the *global* ring is pinned and exchanged halo cells
    evolve with the fused sweeps."""

    src: str
    dst: str
    t: int
    mask: str | None = None


@dataclasses.dataclass(frozen=True)
class WriteBlock:
    """CB -> DRAM: the mirror of :class:`ReadBlock` (no clamp; writers
    always target the block's exact output rows)."""

    cb: str
    dy: int
    rows: int
    col0: int
    cols: int
    contiguous: bool = True
    seg_cols: int | None = None
    sync: bool = False

    def txns(self) -> int:
        if self.seg_cols:
            return self.rows * (-(-self.cols // self.seg_cols))
        return 1 if self.contiguous else self.rows


ReaderOp = (ReadBlock, Tilize)
ComputeOp = (TapReduce, TapCombine, LocalSweeps, Tilize, Untilize)
WriterOp = (WriteBlock, Untilize)


@dataclasses.dataclass(frozen=True)
class TensixProgram:
    """One stencil sweep (or ``t`` fused sweeps) as a three-kernel program.

    ``plan`` carries the block geometry the ops are relative to; ``tilized``
    says whether CB payloads live as native tiles in the compute dtype
    (bf16 on Tensix) or as row-major blocks of the grid dtype;
    ``double_buffered`` says whether the three kernels overlap block ``i``
    with block ``i±1`` (all input/output CBs have >= 2 slots);
    ``interleaved`` lets DRAM traffic spread over all of the device's NoCs
    (DRAM page interleaving — the paper's Table VI layout knob; without it
    a core's whole stream rides the one NoC its DRAM controller binds to).
    """

    policy: str
    spec: StencilSpec
    plan: ExecutionPlan
    cbs: tuple[CircularBuffer, ...]
    reader: tuple = ()
    compute: tuple = ()
    writer: tuple = ()
    tilized: bool = False
    interleaved: bool = False

    def cb(self, name: str) -> CircularBuffer:
        for cb in self.cbs:
            if cb.name == name:
                return cb
        raise BackendError(f"program {self.policy!r} has no CB {name!r}; "
                           f"declared: {[c.name for c in self.cbs]}")

    @property
    def sram_bytes(self) -> int:
        return sum(cb.sram_bytes for cb in self.cbs)

    @property
    def double_buffered(self) -> bool:
        return all(cb.slots >= 2 for cb in self.cbs)

    def validate(self) -> None:
        """Structural checks: every op reads/writes a declared CB and every
        compute input has a producer (static underflow detection)."""
        names = {cb.name for cb in self.cbs}
        produced = set()
        for op in self.reader:
            if isinstance(op, ReadBlock):
                _need(names, op.cb, "reader")
                produced.add(op.cb)
            elif isinstance(op, Tilize):
                _need(names, op.src, "reader"), _need(names, op.dst, "reader")
                if op.src not in produced:
                    raise CBUnderflowError(
                        f"reader tilize pops {op.src!r} before any push")
                produced.add(op.dst)
        for op in self.compute:
            srcs = (op.srcs if isinstance(op, TapCombine)
                    else (op.src,) if hasattr(op, "src") else ())
            if isinstance(op, LocalSweeps) and op.mask is not None:
                srcs = srcs + (op.mask,)
            for s in srcs:
                _need(names, s, "compute")
                if s not in produced:
                    raise CBUnderflowError(
                        f"compute op {type(op).__name__} pops {s!r} but no "
                        f"upstream op pushes to it")
            _need(names, op.dst, "compute")
            produced.add(op.dst)
        for op in self.writer:
            name = op.cb if isinstance(op, WriteBlock) else op.src
            _need(names, name, "writer")
            if name not in produced:
                raise CBUnderflowError(
                    f"writer pops {name!r} but no upstream op pushes to it")
            if isinstance(op, Untilize):
                produced.add(op.dst)

    def describe(self) -> str:
        """Human-readable IR dump (the README example is one of these).

        Each CB line carries its feeding DRAM stream when that stream is
        not the grid (the masked-temporal pin stream reads distinctly from
        the data path) and, when the static verifier can interpret the
        program, its exact occupancy interval ``occ[min,max]/capacity``.
        """
        p = self.plan
        lines = [f"program {self.policy} grid={p.shape} dtype={p.dtype} "
                 f"bm={p.bm} t={p.t} "
                 f"{'tilized' if self.tilized else 'row-major'} "
                 f"sram={self.sram_bytes / 1024:.0f}KiB"]
        streams = {op.cb: op.src for op in self.reader
                   if isinstance(op, ReadBlock) and op.src != "grid"}
        try:  # deferred: analysis imports this module
            from repro_torch.analysis.verify import occupancy_bounds
            bounds = occupancy_bounds(self) or {}
        except Exception:
            bounds = {}
        for cb in self.cbs:
            line = (f"  cb {cb.name:8s} {cb.capacity_tiles:4d} tiles "
                    f"({cb.tile_rows}x{cb.tile_cols} {cb.dtype}, "
                    f"{cb.slots} slot{'s' if cb.slots > 1 else ''}, "
                    f"{cb.sram_bytes / 1024:.0f}KiB)")
            if cb.name in streams:
                line += f" <- {streams[cb.name]} stream"
            if cb.name in bounds:
                line += f" {bounds[cb.name].describe()}"
            lines.append(line)
        for kname, ops in (("reader", self.reader), ("compute", self.compute),
                           ("writer", self.writer)):
            lines.append(f"  {kname}:")
            for op in ops:
                lines.append(f"    {_op_str(op)}")
        return "\n".join(lines)


def _need(names: set, name: str, kernel: str) -> None:
    if name not in names:
        raise BackendError(f"{kernel} op references undeclared CB {name!r}")


def _op_str(op) -> str:
    if isinstance(op, ReadBlock):
        mode = "contig" if op.contiguous else "strided"
        extra = "".join([" clamp" if op.clamp else "",
                         " sync" if op.sync else "",
                         f" x{op.reads}" if op.reads > 1 else "",
                         f" src={op.src}" if op.src != "grid" else ""])
        return (f"read_block  -> {op.cb:8s} rows={op.rows} dy={op.dy:+d} "
                f"cols=[{op.col0},{op.col0 + op.cols}) {mode}{extra}")
    if isinstance(op, WriteBlock):
        mode = "contig" if op.contiguous else "strided"
        return (f"write_block <- {op.cb:8s} rows={op.rows} dy={op.dy:+d} "
                f"cols=[{op.col0},{op.col0 + op.cols}) {mode}")
    if isinstance(op, Tilize):
        return f"tilize      {op.src} -> {op.dst}"
    if isinstance(op, Untilize):
        return f"untilize    {op.src} -> {op.dst}"
    if isinstance(op, TapReduce):
        return (f"tap_reduce  {op.src} -> {op.dst} "
                f"out={op.out_rows}x{op.out_cols} "
                f"off=({op.row_off},{op.col_off})")
    if isinstance(op, TapCombine):
        return f"tap_combine {'+'.join(op.srcs)} -> {op.dst}"
    if isinstance(op, LocalSweeps):
        masked = f" mask={op.mask}" if op.mask else ""
        return f"local_sweeps {op.src} -> {op.dst} t={op.t}{masked}"
    return repr(op)


# ---------------------------------------------------------------------------
# Reference tile layout transforms (and their round-trip contract).
# ---------------------------------------------------------------------------

def tile_grid(rows: int, cols: int, tile_rows: int, tile_cols: int
              ) -> tuple[int, int]:
    """How many (tile_rows x tile_cols) tiles cover a (rows x cols) block."""
    return (-(-rows // tile_rows), -(-cols // tile_cols))


def tilize(a: torch.Tensor, tile_rows: int = 32, tile_cols: int = 32,
           dtype=None) -> torch.Tensor:
    """Row-major block -> (nty, ntx, tile_rows, tile_cols) tile array.

    Ragged edges are zero-padded to whole tiles (the padding is real SRAM
    the layout wastes — the simulator's tile counters include it, which is
    what the Table VI alignment sweep measures). ``dtype`` casts on the way
    in (bf16 on Tensix: this is the op where f32 grids lose precision).
    """
    if dtype is not None:
        a = a.to(torch_dtype(dtype))
    rows, cols = a.shape
    nty, ntx = tile_grid(rows, cols, tile_rows, tile_cols)
    padded = a.new_zeros((nty * tile_rows, ntx * tile_cols))
    padded[:rows, :cols] = a
    return (padded.reshape(nty, tile_rows, ntx, tile_cols)
            .permute(0, 2, 1, 3))


def untilize(tiles: torch.Tensor, rows: int, cols: int,
             dtype=None) -> torch.Tensor:
    """(nty, ntx, tr, tc) tile array -> row-major (rows x cols) block."""
    nty, ntx, tr, tc = tiles.shape
    a = tiles.permute(0, 2, 1, 3).reshape(nty * tr, ntx * tc)[:rows, :cols]
    return a.to(torch_dtype(dtype)) if dtype is not None else a

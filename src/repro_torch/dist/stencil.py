"""Mesh-aware stencil decomposition: depth-``t`` halo exchange around *any*
local sweep function.

The port's copy of ``repro.dist.stencil``. The reference runs a per-shard
body under ``shard_map`` and moves halos with ``ppermute``; here one
process holds every shard of a :class:`~repro_torch.dist.mesh.ShardMesh`
and loops the same body over the shards, moving halos between shard
tensors with ``copy_`` — or, over a
:class:`~repro_torch.dist.process.ProcessMesh`, each rank holds one shard
and the same strips (:func:`_halo_strips`) move as point-to-point
messages (:mod:`repro_torch.dist.process`). The local computation is a
*block callable* ``block(ext, fixed, t, out=None)`` on an extended
(haloed) shard:
:func:`masked_block` around any single-sweep callable obeying the engine's
ringed contract, or a fused kernel that takes the pin mask itself
(``engine.stencil_temporal`` with ``mask=``: all ``t`` sweeps in one
round-trip through device memory).

Scheme per exchange, for ``t`` sweeps of a radius-``r`` spec (``d = t*r``):

* each shard lives inside a depth-``d`` extended block, built once per
  depth by :func:`_assemble_ext`: the shard at its centre, the Dirichlet
  bands replicated outward across the halo band on physical domain edges
  (their halo rows ride a row exchange of the bands: cells beyond the
  first ``r`` ring are pinned and never reach the valid region), and the
  four ``r x r`` physical ring corners on the corner shards, so
  diagonal-tap specs are exact too;
* every round :func:`_exchange` moves the neighbours' halos into the
  blocks in place — rows first, then the columns of the row-extended
  blocks, so shard-corner halos ride along (needed once ``d > r``) —
  through view pairs made once a depth (:func:`_halo_pairs`). The bands
  are constant, so only these halos move;
* the block callable advances each extended block ``t`` sweeps into a
  spare buffer, and the exact central block is the new shard.

In **overlap** mode the block launch splits in two: each shard's interior
(independent of any incoming halo) launches on the raw shard *before* the
exchange, on a side CUDA stream, and four rind strips of width ``3*t*r``
launch on the arrived extended block after the main stream has joined
the side one, stitched around the interior. The result is bit-identical
to the serial round (the kept cells' dependency cones and tap order are
the same); what changes is the wall-clock bill, ``max(exchange,
interior) + rind`` instead of ``exchange + full block``
(:func:`repro_torch.engine.schedule.price_exchange`). On the CPU the
phases run in order.

What the port leaves out of the reference: ``jax.jit``, ``lax.scan``, the
``cache_key`` of its cached single launch and buffer donation into that
launch. The rounds are a Python loop of launches (a CUDA graph of a
round is later speed work); ``run_sharded(donate=True)`` only re-attaches
the ring into ``u`` itself. The reference re-attaches the ring with
``u.at[r:-r, r:-r].set(interior)`` on a sharded interior, which raises
under newer jax; the port assigns each shard's centre into a copy of
``u``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Dict

import torch

from repro_torch.core.decomp import check_divisible, split_ringed_bands
from repro_torch.core.stencil import StencilSpec
from repro_torch.engine.schedule import overlap_feasible
from repro_torch.obs.trace import get_tracer
from repro_torch.obs.trace import span as _obs_span


def _pad_outward(band: torch.Tensor, d: int, axis: int, leading: bool):
    """Grow a thickness-``r`` Dirichlet band to thickness ``d`` by
    replicating its outermost row/col on the outward (``leading``) side."""
    r = band.shape[axis]
    if d == r:
        return band
    outer = band.narrow(axis, 0 if leading else r - 1, 1)
    reps = [1, 1]
    reps[axis] = d - r
    pad = outer.repeat(*reps)
    return torch.cat([pad, band] if leading else [band, pad], dim=axis)


def masked_block(sweep: Callable) -> Callable:
    """Lift a single-sweep callable into the block contract.

    ``block(ext, fixed, t, out=None)`` advances the extended block ``t``
    sweeps, re-pinning the ``fixed`` (nonzero: global-Dirichlet) cells to
    their pre-sweep values between sweeps — one kernel launch per sweep.
    The last sweep is written into ``out`` when one is given. Fused
    policies skip this wrapper and take the mask directly, which is the
    whole point of temporal blocking.
    """
    def block(ext, fixed, t: int, out=None):
        orig, pin = ext, fixed != 0
        for i in range(t):
            ext = torch.where(pin, orig, sweep(ext),
                              out=out if i == t - 1 else None)
        return ext
    return block


@dataclasses.dataclass(frozen=True)
class _Layout:
    """How a ``(Hi, Wi)`` interior splits over a ``px x py`` shard grid:
    shard ``k = ix * py + iy`` holds rows ``ix*hl:(ix+1)*hl`` and columns
    ``iy*wl:(iy+1)*wl`` on ``devices[k]``."""

    px: int
    py: int
    hl: int
    wl: int
    devices: tuple

    @classmethod
    def of(cls, mesh, row_axis: str | None, col_axis: str | None,
           interior_shape) -> "_Layout":
        px = mesh.shape[row_axis] if row_axis else 1
        py = mesh.shape[col_axis] if col_axis else 1
        hi, wi = interior_shape
        check_divisible(hi, wi, px, py)

        def coords(ix, iy):
            return {a: i for a, i in ((row_axis, ix), (col_axis, iy)) if a}
        return cls(px, py, hi // px, wi // py,
                   tuple(mesh.device(**coords(ix, iy))
                         for ix in range(px) for iy in range(py)))

    def blocks(self):
        """``(k, ix, iy, rows, cols)`` of every shard, in shard order."""
        for ix in range(self.px):
            for iy in range(self.py):
                yield (ix * self.py + iy, ix, iy,
                       slice(ix * self.hl, (ix + 1) * self.hl),
                       slice(iy * self.wl, (iy + 1) * self.wl))

    def split(self, interior: torch.Tensor) -> list:
        """Each shard's block of ``interior`` on its device (a view when
        the device is the interior's)."""
        return [interior[rs, cs].to(self.devices[k])
                for k, _, _, rs, cs in self.blocks()]

    def join_into(self, out: torch.Tensor, shards) -> torch.Tensor:
        """Assign each shard into its block of ``out``; return ``out``."""
        for k, _, _, rs, cs in self.blocks():
            out[rs, cs] = shards[k]
        return out

    @property
    def positions(self) -> list:
        """The ``(ix, iy)`` of the shards this process holds: all."""
        return _grid_positions(self.px, self.py)

    def exchanger(self, d: int) -> Callable:
        return _pair_exchanger(self.px, self.py, d)


def _assemble_one(u, top, bottom, left, right, tl, tr, bl, br, *, ix: int,
                  iy: int, px: int, py: int, r: int, d: int) -> torch.Tensor:
    """The depth-``d`` extended block of the ``(hl, wl)`` shard ``u`` at
    position ``(ix, iy)`` of a ``px x py`` grid, on ``u``'s device.

    ``top``/``bottom`` (``(r, Wi)``), ``left``/``right`` (``(Hi, r)``)
    are the global Dirichlet bands and ``tl``..``br`` the ``r x r`` ring
    corners. The block gets the shard at the centre, the bands padded
    outward on physical domain edges — the left/right bands span the halo
    rows too, and those rows are the row neighbours' slices of the band
    (zeros past the domain: the reference's packed ``[left | grid |
    right]`` row exchange, less the grid, which the exchange moves every
    round) — and the physical ring corners on the corner shards. Cells
    that neighbours' halos fill are zero until the first exchange.
    """
    hl, wl = u.shape
    if d > min(hl, wl):
        raise ValueError(
            f"halo depth {d} (t={d // r} sweeps x radius {r}) exceeds local "
            f"block {(hl, wl)}; lower t or use more rows/cols per shard")

    def here(x):
        return x.to(device=u.device, dtype=u.dtype)

    def band_col(band):  # the shard's rows of a column band, with halos
        up = band[ix * hl - d:ix * hl] if ix > 0 else band.new_zeros((d, r))
        down = (band[(ix + 1) * hl:(ix + 1) * hl + d] if ix < px - 1
                else band.new_zeros((d, r)))
        return here(torch.cat([up, band[ix * hl:(ix + 1) * hl], down]))
    ext = u.new_zeros((hl + 2 * d, wl + 2 * d))
    ext[d:d + hl, d:d + wl] = u
    cols = slice(iy * wl, (iy + 1) * wl)
    if ix == 0:
        ext[:d, d:d + wl] = _pad_outward(here(top[:, cols]), d, 0,
                                         leading=True)
    if ix == px - 1:
        ext[hl + d:, d:d + wl] = _pad_outward(here(bottom[:, cols]), d, 0,
                                              leading=False)
    if iy == 0:
        ext[:, :d] = _pad_outward(band_col(left), d, 1, leading=True)
    if iy == py - 1:
        ext[:, wl + d:] = _pad_outward(band_col(right), d, 1, leading=False)
    # Physical ring corners (read by diagonal taps; the bands drop them):
    # the true r x r corner blocks on the four corner shards.
    rows_top, rows_bot = slice(d - r, d), slice(hl + d, hl + d + r)
    cols_lef, cols_rig = slice(d - r, d), slice(wl + d, wl + d + r)
    for cond, corner, rs, cs in (
        (ix == 0 and iy == 0, tl, rows_top, cols_lef),
        (ix == 0 and iy == py - 1, tr, rows_top, cols_rig),
        (ix == px - 1 and iy == 0, bl, rows_bot, cols_lef),
        (ix == px - 1 and iy == py - 1, br, rows_bot, cols_rig),
    ):
        if cond:
            ext[rs, cs] = here(corner)
    return ext


def _grid_positions(px: int, py: int) -> list:
    """Every ``(ix, iy)`` of a ``px x py`` grid, in shard order."""
    return [(ix, iy) for ix in range(px) for iy in range(py)]


def _assemble_ext(shards, *bands, px: int, py: int, r: int, d: int,
                  positions=None) -> list:
    """Build the extended block of each shard in ``shards`` (at
    ``positions``, default: every shard of the grid in shard order), once
    per depth (:func:`_assemble_one`; ``bands`` are its ``top`` ..
    ``br``)."""
    positions = positions or _grid_positions(px, py)
    return [_assemble_one(u, *bands, ix=ix, iy=iy, px=px, py=py, r=r, d=d)
            for u, (ix, iy) in zip(shards, positions)]


def _halo_strips(ix: int, iy: int, *, px: int, py: int, hl: int, wl: int,
                 d: int) -> tuple[list, list]:
    """One extended block's halos, by phase: ``(rows, columns)``.

    Each strip is ``(peer, recv, send)``: the neighbour ``(ix, iy)``,
    the slices of this block its halo fills, and the slices of this block
    that fill the neighbour's halo facing this one. Phase 1, rows: the
    top/bottom halo rows over the shard's columns. Phase 2, columns of the
    row-extended block: the left/right halo columns, all rows of them, so
    the diagonal shard corners ride along. Physical edges have no strip:
    they keep the bands :func:`_assemble_one` put there.
    """
    inner = slice(d, d + wl)
    rows, cols = [], []
    if ix > 0:
        rows.append(((ix - 1, iy), (slice(0, d), inner),
                     (slice(d, 2 * d), inner)))
    if ix < px - 1:
        rows.append(((ix + 1, iy), (slice(hl + d, hl + 2 * d), inner),
                     (slice(hl, hl + d), inner)))
    every = slice(None)
    if iy > 0:
        cols.append(((ix, iy - 1), (every, slice(0, d)),
                     (every, slice(d, 2 * d))))
    if iy < py - 1:
        cols.append(((ix, iy + 1), (every, slice(wl + d, wl + 2 * d)),
                     (every, slice(wl, wl + d))))
    return rows, cols


def _halo_pairs(exts, *, px: int, py: int, d: int) -> list:
    """The exchange over every shard's extended block as ``(destination,
    source)`` view pairs, in the order they must be copied: every row
    strip of :func:`_halo_strips`, then every column strip. The views are
    made once a depth; a round only copies (:func:`_exchange`)."""
    hl, wl = exts[0].shape[0] - 2 * d, exts[0].shape[1] - 2 * d
    strips = [_halo_strips(ix, iy, px=px, py=py, hl=hl, wl=wl, d=d)
              for ix, iy in _grid_positions(px, py)]
    pairs = ([], [])
    for k, e in enumerate(exts):
        for phase, own in zip(pairs, strips[k]):
            for (pix, piy), recv, _ in own:
                peer = pix * py + piy
                phase.append((e[recv], exts[peer][_facing(
                    strips[peer], (k // py, k % py))]))
    return pairs[0] + pairs[1]


def _facing(strips, pos) -> tuple:
    """The ``send`` slices of the strip in ``strips`` whose peer is
    ``pos``."""
    return next(send for phase in strips for peer, _, send in phase
                if peer == pos)


def _exchange(pairs) -> None:
    """Move the neighbours' halos into the extended blocks, in place."""
    for dst, src in pairs:
        dst.copy_(src)


def _pin_mask(hl: int, wl: int, d: int, ix: int, iy: int, px: int, py: int,
              device) -> torch.Tensor:
    """The pin mask on the extended block, a contiguous ``uint8`` tensor:
    physical Dirichlet bands stay fixed across all ``t`` sweeps; every
    other edge cell is exchanged halo that must evolve (its staleness
    grows ``r`` per sweep and is cropped by the caller)."""
    m = torch.zeros((hl + 2 * d, wl + 2 * d), dtype=torch.uint8,
                    device=device)
    if ix == 0:
        m[:d] = 1
    if ix == px - 1:
        m[hl + d:] = 1
    if iy == 0:
        m[:, :d] = 1
    if iy == py - 1:
        m[:, wl + d:] = 1
    return m


def _rind_strips(hl: int, wl: int, d: int):
    """The four rind strips of an extended block, as (rows, cols) slices:
    top/bottom span the full width at height ``3d``; left/right fill the
    shard's rows at width ``3d``."""
    return ((slice(0, 3 * d), slice(None)),
            (slice(hl - d, hl + 2 * d), slice(None)),
            (slice(d, hl + d), slice(0, 3 * d)),
            (slice(d, hl + d), slice(wl - d, wl + 2 * d)))


def _interior_keep(u, zeros, block: Callable, t: int, d: int):
    """The interior phase: advance the raw (un-haloed) shard ``t`` sweeps
    and keep the cells >= ``d`` from the shard edge — exact without any
    halo data (the near-edge cells are covered by the rind strips).
    ``zeros`` is the shard's all-zero pin mask."""
    hl, wl = u.shape
    inner = block(u, zeros, t)
    return inner[d:hl - d, d:wl - d]


def _rind_stitch(ext, fixed_strips, inner_keep, *, block: Callable, t: int,
                 d: int, out) -> None:
    """The rind phase: four strip launches on the arrived extended block,
    stitched around the interior result into ``out`` (the new shard).

    Each strip is wide enough (``3d``) that its kept cells sit >= ``d``
    from every strip edge that is not ``ext``'s own (pinned or
    cropped-anyway) boundary. Top/bottom strips keep the first/last ``d``
    shard rows; left/right strips keep the first/last ``d`` columns of
    the rows between. ``fixed_strips`` are the pin mask's strips, each
    contiguous.
    """
    hl, wl = ext.shape[0] - 2 * d, ext.shape[1] - 2 * d
    outs = [block(ext[rs, cs].contiguous(), f, t)
            for (rs, cs), f in zip(_rind_strips(hl, wl, d), fixed_strips)]
    out[:d] = outs[0][d:2 * d, d:wl + d]
    out[hl - d:] = outs[1][d:2 * d, d:wl + d]
    out[d:hl - d, :d] = outs[2][d:hl - d, d:2 * d]
    out[d:hl - d, wl - d:] = outs[3][d:hl - d, d:2 * d]
    out[d:hl - d, d:wl - d] = inner_keep


class _Shards:
    """One depth's extended blocks and their spare buffers (the blocks a
    round writes into; the two swap every round), each set with its
    exchange: ``exchanger(exts)`` returns the call that moves the halos
    into ``exts``."""

    def __init__(self, exts: list, exchanger: Callable):
        self.exts = exts
        self.spares = [e.clone() for e in exts]
        self.halos = exchanger(exts)
        self.spare_halos = exchanger(self.spares)

    def swap(self) -> None:
        self.exts, self.spares = self.spares, self.exts
        self.halos, self.spare_halos = self.spare_halos, self.halos


def _pair_exchanger(px: int, py: int, d: int) -> Callable:
    """The in-process exchange: ``exts`` (every shard's block, in shard
    order) -> the call that copies their :func:`_halo_pairs`."""
    def make(exts):
        return functools.partial(_exchange, _halo_pairs(exts, px=px, py=py,
                                                        d=d))
    return make


class _Phases:
    """The phases of one round at one depth, over one shard grid.

    ``exchange``, ``compute`` (the serial full-block round), ``interior``
    and ``rind`` (the overlapped round) act on a :class:`_Shards`. The pin
    masks, their rind strips and the interior's all-zero mask depend only
    on a shard's position and ``d``: they are built once, as contiguous
    ``uint8`` tensors on each shard's device, at the first :meth:`start`.
    ``positions`` are the ``(ix, iy)`` of the shards this process holds
    (default: all of them, in shard order) and ``exchanger`` makes their
    exchange (default: :func:`_pair_exchanger`; one process a shard passes
    :mod:`repro_torch.dist.process`'s).
    """

    def __init__(self, block: Callable, *, px: int, py: int, r: int, t: int,
                 positions=None, exchanger: Callable | None = None):
        self.block, self.px, self.py, self.t, self.d = block, px, py, t, t * r
        self.positions = positions or _grid_positions(px, py)
        self.exchanger = exchanger or _pair_exchanger(px, py, self.d)
        self._masks = None

    def start(self, exts: list) -> _Shards:
        d = self.d
        hl, wl = exts[0].shape[0] - 2 * d, exts[0].shape[1] - 2 * d
        key = (hl, wl, tuple(e.device for e in exts))
        if self._masks is None or self._masks[0] != key:
            fixed = [_pin_mask(hl, wl, d, ix, iy, self.px, self.py, e.device)
                     for (ix, iy), e in zip(self.positions, exts)]
            strips = [tuple(f[rs, cs].contiguous()
                            for rs, cs in _rind_strips(hl, wl, d))
                      for f in fixed]
            zeros = [torch.zeros((hl, wl), dtype=torch.uint8, device=e.device)
                     for e in exts]
            self._masks = (key, fixed, strips, zeros)
        return _Shards(exts, self.exchanger)

    def shard_shape(self, s: _Shards) -> tuple[int, int]:
        return (s.exts[0].shape[0] - 2 * self.d,
                s.exts[0].shape[1] - 2 * self.d)

    def centers(self, s: _Shards) -> list:
        d = self.d
        return [e[d:-d, d:-d] for e in s.exts]

    def exchange(self, s: _Shards) -> None:
        s.halos()

    def compute(self, s: _Shards) -> None:
        fixed = self._masks[1]
        for k, e in enumerate(s.exts):
            self.block(e, fixed[k], self.t, out=s.spares[k])
        s.swap()

    def interior(self, s: _Shards) -> list:
        d, zeros = self.d, self._masks[3]
        return [_interior_keep(e[d:-d, d:-d].contiguous(), zeros[k],
                               self.block, self.t, d)
                for k, e in enumerate(s.exts)]

    def rind(self, s: _Shards, keeps: list) -> None:
        d, strips = self.d, self._masks[2]
        for k, e in enumerate(s.exts):
            _rind_stitch(e, strips[k], keeps[k], block=self.block, t=self.t,
                         d=d, out=s.spares[k][d:-d, d:-d])
        s.swap()


def make_phase_steps(mesh, spec: StencilSpec, block: Callable, *,
                     row_axis: str | None, col_axis: str | None,
                     t: int = 1) -> dict:
    """The per-phase callables of one round at depth ``t``.

    Returns ``{"start", "exchange", "compute", "interior", "rind"}``:
    ``start(exts)`` takes the extended blocks :func:`_assemble_ext` built
    and returns the shard state the others act on; ``exchange(state)``
    moves the halos in place; ``compute(state)`` is the serial full-block
    round; ``interior(state)`` returns the halo-independent keeps and
    ``rind(state, keeps)`` stitches the overlapped round. The traced
    executor puts a span around each; :func:`_local_sweeps` runs them
    unobserved. (The reference returns jitted ``shard_map`` programs over
    global arrays; here the phases act on the list of shards.)
    """
    ph = _Phases(block, px=mesh.shape[row_axis] if row_axis else 1,
                 py=mesh.shape[col_axis] if col_axis else 1, r=spec.radius,
                 t=t)
    return {"start": ph.start, "exchange": ph.exchange,
            "compute": ph.compute, "interior": ph.interior, "rind": ph.rind}


def _cuda_streams(s: _Shards):
    """``{device: current stream}`` of the CUDA devices holding shards."""
    return {e.device: torch.cuda.current_stream(e.device)
            for e in s.exts if e.is_cuda}


def _sync(s: _Shards) -> None:
    for dev in {e.device for e in s.exts if e.is_cuda}:
        torch.cuda.synchronize(dev)


def _local_sweeps(s: _Shards, ph: _Phases, *, overlap: bool,
                  side: dict) -> None:
    """Advance every shard ``t`` sweeps with one depth-``t*r`` exchange.

    With ``overlap``, each shard's **interior** launches first on the raw
    (un-haloed) shard — on a side stream of its device (kept in ``side``,
    ``{device: stream}``, made at first use), which waits for the main
    stream's earlier work — then the exchange copies go on the main
    stream, the main stream joins the side one, and four **rind** strips
    launch on the arrived extended block. After ``t`` sweeps of radius ``r``, every cell at
    distance >= ``d = t*r`` from a strip edge has the same dependency
    cone (and the same f32 tap order) as in the one-block launch, so the
    stitched result is bit-identical to the serial round. A shard too
    small for a nonempty interior (``hl <= 2d`` or ``wl <= 2d``) runs
    the serial round. Tensors that cross streams are recorded on the
    stream that uses them (``record_stream``), so the caching allocator
    keeps them alive until it is done. On the CPU the phases run in
    order.
    """
    hl, wl = ph.shard_shape(s)
    if not (overlap and overlap_feasible(hl, wl, ph.d)):
        ph.exchange(s)
        ph.compute(s)
        return
    mains = _cuda_streams(s)
    if not mains:
        keeps = ph.interior(s)
        ph.exchange(s)
        ph.rind(s, keeps)
        return
    with contextlib.ExitStack() as stack:
        for dev, main in mains.items():
            if dev not in side:
                side[dev] = torch.cuda.Stream(dev)
            side[dev].wait_stream(main)
            stack.enter_context(torch.cuda.stream(side[dev]))
        for e in s.exts:
            e.record_stream(side[e.device])
        keeps = ph.interior(s)
        for k in keeps:
            k.record_stream(mains[k.device])
    ph.exchange(s)
    for dev, main in mains.items():
        main.wait_stream(side[dev])
    ph.rind(s, keeps)


def _traced_round(s: _Shards, ph: _Phases, *, overlap: bool, idx: int,
                  bill) -> None:
    """The span-per-phase twin of :func:`_local_sweeps`: the same phases,
    serialized and synchronized so each span measures its own device
    work, inside ``dist.round`` > ``exchange``/``interior``/``rind`` (or
    ``compute``) spans. Every phase span carries the round's
    :class:`~repro_torch.engine.schedule.ExchangeBill` attrs plus its own
    ``model_s``, the join key ``obs.reconcile`` prices drift from. With
    overlap the phases run one after another on the current stream (no
    side stream, no join), so the spans time each phase of this
    serialized twin, not the stream path an untraced run takes."""
    hl, wl = ph.shard_shape(s)
    ov = overlap and overlap_feasible(hl, wl, ph.d)

    def phase(name, model_s, fn, *args):
        attrs = dict(bill.as_attrs(), model_s=model_s) if bill else {}
        with _obs_span(name, **attrs):
            res = fn(*args)
            _sync(s)
        return res

    with _obs_span("dist.round", round=idx, t=ph.t, halo_depth=ph.d,
                   overlap=ov):
        if ov:
            keeps = phase("interior", bill and bill.interior_s, ph.interior,
                          s)
            phase("exchange", bill and bill.exchange_s, ph.exchange, s)
            phase("rind", bill and bill.rind_s, ph.rind, s, keeps)
        else:
            phase("exchange", bill and bill.exchange_s, ph.exchange, s)
            phase("compute", bill and bill.compute_s, ph.compute, s)


def make_sharded_step(mesh, spec: StencilSpec, block: Callable, *,
                      row_axis: str | None, col_axis: str | None,
                      t: int = 1, overlap: bool = False) -> Callable:
    """Build ``step(interior, bc) -> interior'`` advancing ``t`` sweeps of
    ``spec`` with one halo exchange, sharded over ``mesh``.

    ``bc`` holds the ``top``/``bottom`` (``(r, Wi)``) and ``left``/
    ``right`` (``(Hi, r)``) Dirichlet bands and, optionally, the ``r x r``
    ring corners ``tl``/``tr``/``bl``/``br`` (zeros when absent).
    ``block(ext, fixed, t, out=None)`` is the local computation on the
    extended shard — wrap a plain single-sweep callable with
    :func:`masked_block`. ``overlap`` runs the interior/rind split
    (bit-identical result; see :func:`_local_sweeps`). Each call builds
    the extended blocks afresh; the pin masks are built once.
    """
    r = spec.radius
    ph = _Phases(block, px=mesh.shape[row_axis] if row_axis else 1,
                 py=mesh.shape[col_axis] if col_axis else 1, r=r, t=t)
    side: dict = {}

    def step(interior: torch.Tensor,
             bc: Dict[str, torch.Tensor]) -> torch.Tensor:
        layout = _Layout.of(mesh, row_axis, col_axis, interior.shape)
        zc = interior.new_zeros((r, r))
        corners = [bc.get(k, zc) for k in ("tl", "tr", "bl", "br")]
        exts = _assemble_ext(layout.split(interior), bc["top"],
                             bc["bottom"], bc["left"], bc["right"], *corners,
                             px=layout.px, py=layout.py, r=r, d=t * r)
        s = ph.start(exts)
        _local_sweeps(s, ph, overlap=overlap, side=side)
        return layout.join_into(torch.empty_like(interior), ph.centers(s))

    return step


def _layout_of(mesh, row_axis, col_axis, interior_shape):
    """The shard layout of ``mesh``: every shard in this process
    (:class:`_Layout`), or this rank's one shard of a
    :class:`~repro_torch.dist.process.ProcessMesh`."""
    from repro_torch.dist.process import ProcessMesh, RankLayout
    kind = RankLayout if isinstance(mesh, ProcessMesh) else _Layout
    return kind.of(mesh, row_axis, col_axis, interior_shape)


def _execute_rounds(u, spec: StencilSpec, mesh, block: Callable, *,
                    schedule, row_axis, col_axis, remainder_block,
                    bill=None, remainder_bill=None, traced: bool = False,
                    donate: bool = False) -> torch.Tensor:
    """The executor body: band split, the fused exchange rounds, the
    remainder round, ring re-attach. ``traced`` runs each round through
    :func:`_traced_round`, else :func:`_local_sweeps`."""
    r = spec.radius
    interior, bc = split_ringed_bands(u, r)
    bands = (bc["top"], bc["bottom"], bc["left"], bc["right"], u[:r, :r],
             u[:r, -r:], u[-r:, :r], u[-r:, -r:])
    layout = _layout_of(mesh, row_axis, col_axis, interior.shape)
    shards = layout.split(interior)
    side: dict = {}
    idx = 0
    for blk, t, reps, b in (
            (block, schedule.t, schedule.fused_blocks, bill),
            (remainder_block if remainder_block is not None else block,
             schedule.remainder, 1 if schedule.remainder else 0,
             remainder_bill)):
        if not reps:
            continue
        ph = _Phases(blk, px=layout.px, py=layout.py, r=r, t=t,
                     positions=layout.positions,
                     exchanger=layout.exchanger(t * r))
        s = ph.start(_assemble_ext(shards, *bands, px=layout.px,
                                   py=layout.py, r=r, d=t * r,
                                   positions=layout.positions))
        for _ in range(reps):
            if traced:
                _traced_round(s, ph, overlap=schedule.overlap, idx=idx,
                              bill=b)
            else:
                _local_sweeps(s, ph, overlap=schedule.overlap, side=side)
            idx += 1
        shards = ph.centers(s)
    out = u if donate else u.clone()
    layout.join_into(out[r:-r, r:-r], shards)
    return out


def resolve_axes(mesh, row_axis: str | None, col_axis: str | None):
    """Default decomposition axes: the mesh's first (rows) and second
    (columns, if any) axis names."""
    if row_axis is None and col_axis is None:
        names = tuple(mesh.axis_names)
        row_axis = names[0]
        col_axis = names[1] if len(names) > 1 else None
    return row_axis, col_axis


def extended_shard_shape(shape, mesh, spec: StencilSpec, *, t: int = 1,
                         row_axis: str | None = None,
                         col_axis: str | None = None) -> tuple[int, int]:
    """Static local block a sweep sees: shard interior + depth-``t*r`` halo.

    This is the shape per-shard execution plans must be validated against
    — a policy whose window fits the *global* grid's plan can still
    overflow a device's fast memory once the exchanged halo band is
    attached, and vice versa.
    """
    row_axis, col_axis = resolve_axes(mesh, row_axis, col_axis)
    r = spec.radius
    px = mesh.shape[row_axis] if row_axis else 1
    py = mesh.shape[col_axis] if col_axis else 1
    d = 2 * t * r
    return ((shape[0] - 2 * r) // px + d, (shape[1] - 2 * r) // py + d)


def run_sharded(u: torch.Tensor, spec: StencilSpec, mesh, block: Callable, *,
                schedule, row_axis: str | None = None,
                col_axis: str | None = None,
                remainder_block: Callable | None = None,
                bill=None, remainder_bill=None,
                donate: bool = False) -> torch.Tensor:
    """Execute a :class:`~repro_torch.engine.schedule.SweepSchedule` over
    ``mesh``.

    ``schedule.fused_blocks`` exchanges of depth ``schedule.halo_depth``
    each precede ``schedule.t`` local sweeps via ``block(ext, fixed, t)``;
    a non-empty remainder runs one more (shallower) exchange through
    ``remainder_block`` (default: ``block`` again). Same contract as
    ``engine.run``: returns the full grid, boundary ring copied through
    (into ``u`` itself with ``donate=True``, else into a copy).
    ``schedule.overlap`` selects the interior/rind split.

    With a :mod:`repro_torch.obs` tracer installed, rounds run through the
    span-per-phase executor instead — bit-identical result, one
    ``exchange``/``interior``/``rind`` (or ``compute``) span per phase.
    ``bill``/``remainder_bill`` are the per-round
    :class:`~repro_torch.engine.schedule.ExchangeBill`\\ s those spans
    attach for ``obs.reconcile`` (None = spans carry no model attrs).
    """
    row_axis, col_axis = resolve_axes(mesh, row_axis, col_axis)
    return _execute_rounds(u, spec, mesh, block, schedule=schedule,
                           row_axis=row_axis, col_axis=col_axis,
                           remainder_block=remainder_block, bill=bill,
                           remainder_bill=remainder_bill,
                           traced=get_tracer() is not None, donate=donate)

"""Turn simulator counters into the numbers the benchmark tables print.

Everything here is *derived from an executed program*: bytes/point come
out of the reader/writer counters of a lowered, simulated program rather
than a hand-maintained formula, GPt/s is interior points over the modeled
chip time, and energy is TDP x that time (modeled, like every derived
number in benchmarks/ — the measured side of the house is interpret-mode
wall time). ``model_copy_seconds`` prices the paper's §V access-pattern
experiments (Tables III–VI) by building and running the corresponding
stream program — the tables regenerate their model rows by calling it
instead of hard-coding transaction constants.

The port's copy of ``repro.backends.report``; every number here is
modeled for the device model named, never measured on the card.
"""
from __future__ import annotations

import torch

from repro_torch.engine.device import DeviceModel, get_device
from repro_torch.backends import sim as S
from repro_torch.backends.ir import tile_grid, torch_dtype
from repro_torch.backends.lower import make_copy_program
from repro_torch.core.stencil import require_device


def gpts(result: S.SimResult) -> float:
    """Modeled throughput in giga interior points per second."""
    pts = result.interior_points * result.counters.sweeps
    return pts / max(result.model_time_s, 1e-30) / 1e9


def energy_j(result: S.SimResult) -> float:
    """Modeled energy: chip TDP x modeled time (labeled MODELED wherever
    printed — no RAPL/tt-smi in a simulator)."""
    return result.device.tdp_watts * result.model_time_s


def bytes_per_point(result: S.SimResult, kind: str = "dram") -> float:
    """Observed DRAM traffic per interior point per sweep.

    ``kind`` is ``"dram"`` (reader+writer), ``"read"``, or ``"write"`` —
    counted from the executed program, so the shifted policy's per-tap
    re-reads and the temporal policy's t-fold amortization show up without
    any per-policy formula.
    """
    c = result.counters
    total = {"dram": c.dram_bytes, "read": c.reader.bytes,
             "write": c.writer.bytes}[kind]
    return total / max(result.interior_points * c.sweeps, 1)


def summarize(result: S.SimResult) -> dict:
    """One dict per simulation: the row generator the tables/launchers use."""
    c = result.counters
    return {
        "device": result.device.name,
        "policy": "+".join(p.policy for p in result.programs),
        "tilized": result.programs[0].tilized,
        "cores_used": result.cores_used,
        "sweeps": c.sweeps,
        "blocks": c.blocks,
        "model_time_s": result.model_time_s,
        "gpts": gpts(result),
        "energy_j": energy_j(result),
        "bytes_per_point": bytes_per_point(result),
        "reader_s": c.reader.seconds,
        "dram_bytes": c.dram_bytes,
        "dram_txns": c.reader.txns + c.writer.txns,
        "tiles_moved": c.reader.tiles + c.compute.tiles + c.writer.tiles,
        "compute_flops": c.compute.flops,
    }


def model_copy_seconds(shape, dtype, *, seg_cols: int | None = None,
                       bm: int = 256, sync: bool = False, reads: int = 1,
                       interleaved: bool = False,
                       device: str | DeviceModel | None = None,
                       torch_device="cuda") -> float:
    """Modeled seconds to stream ``shape`` through one virtual core.

    The Table III–VI generator: a read+write stream program with the
    requested request size (``seg_cols`` columns per DRAM descriptor),
    synchronization mode, replication factor, and page-interleaving flag,
    executed by the simulator on a zero grid on ``torch_device`` — only
    the step model's output is used.
    """
    prog = make_copy_program(shape, dtype, bm=bm, seg_cols=seg_cols,
                             sync=sync, reads=reads,
                             interleaved=interleaved, device=device)
    u = torch.zeros(tuple(int(s) for s in shape), dtype=torch_dtype(dtype),
                    device=require_device(torch_device))
    return S.simulate_program(u, prog).model_time_s


def tile_efficiency(rows: int, cols: int,
                    device: str | DeviceModel | None = None) -> float:
    """Useful fraction of the tile storage a (rows x cols) block occupies
    (the Table VI alignment lesson, priced with the device's own tile)."""
    dev = get_device(device)
    nty, ntx = tile_grid(rows, cols, dev.tile_rows, dev.tile_cols)
    return (rows * cols) / (nty * ntx * dev.tile_rows * dev.tile_cols)

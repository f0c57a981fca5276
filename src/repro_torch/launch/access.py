"""The paper's memory-access study on the card: Tables II–VI, measured.

    PYTHONPATH=src python -m repro_torch.launch.access [--table 2|3|4|5|6]
        [--device cuda|cpu] [--scale N]

The counterpart of ``python -m benchmarks.run --only tableN`` for the
measured rows of Tables II–VI. It prints the same CSV,
``name,us_per_call,derived``, with the same row names:

* Table II (component ablation): ``dma_only`` (K6a), ``compute_only``
  (K6b) and ``full_<policy>`` for each non-fused engine policy (K4, K2,
  K3 through ``engine.step(bm=64)``), on the paper's §VII grid, 1026 x
  9218 bf16;
* Table III (contiguous access): ``copy_block_bn<bn>`` (K5a, bm = 256) and
  ``rowdma_sync=<b>`` (K5b, bm = 64) on 4096 x 4096 int32, the paper's
  size, with the paper's 16 KB row (bn = 4096) ahead of the JAX widths;
* Table IV (non-contiguous access): ``copy_<bm>x<bn>_<kind>`` (K5a),
  4096 x 4096 int32;
* Table V (replicated reads): ``replicated_x<f>`` (K5c, bm = 128),
  4096 x 4096 f32;
* Table VI (layout): ``width_<w>_<note>`` (K5a with full-width blocks,
  bm = 128) at the JAX widths, each array h x w f32 with h the largest
  multiple of 128 <= 2**24 / w, so about 64 MiB: past the card's 50 MB L2,
  as the 64 MiB arrays of Tables III–V are;

then the JAX tables' modeled ``sim_*`` rows, and the paper's ``paper_*``
rows as they are. ``us_per_call`` is the
median device time of one call from CUDA events
(``obs/timing.py::device_ms``). ``derived`` prices the same call with the
port's ``gpu_sm90`` device model (``engine/device.py``) as
``model_sm90_s=`` or ``model_sm90_GPt/s=``, with the JAX tables' formulas.

The ``sim_*`` rows are the JAX tables' model rows, from the same
formulas on the port's backends simulator (:mod:`repro_torch.backends`):
``sim_e150_*`` prices the paper's 4096 x 4096 int32 streams
(``report.model_copy_seconds``) and Table VI's tile alignment on the
Grayskull e150 model, and Table V's ``sim_counted_*`` counts the bytes a
point that the simulated shifted and rowchunk programs move. They are
modeled, never measured (``us_per_call`` 0), are not scaled by
``--scale``, and the simulator runs on ``--device``. Table VI's
``tpu_v5e`` (8, 128)-tile ``tile_efficiency`` is a TPU notion and stays
out.

Without ``--device cpu`` it runs on the card, and fails without one. With
``--device cpu`` the kernels' plain versions run and ``us_per_call`` is
the host's wall time (a median of three), which says nothing of a
device; ``--scale N`` divides every array's sides by N (by N² for Table
VI's heights) so that a CPU run takes seconds. A row whose block does not
divide its scaled array is left out.
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch

PAPER_ROWS = {
    2: (("paper_none", "paper_GPt/s=7.574"),
        ("paper_compute_only", "paper_GPt/s=1.387"),
        ("paper_write_only", "paper_GPt/s=0.278"),
        ("paper_read_only", "paper_GPt/s=0.205"),
        ("paper_memcpy_only", "paper_GPt/s=0.014")),
    3: (("paper_16KB_nosync", "paper_s=0.011"),
        ("paper_4B_nosync", "paper_s=1.761"),
        ("paper_4B_sync", "paper_s=12.659")),
    4: (("paper_16KB_noncontig", "paper_s=0.011"),
        ("paper_4B_noncontig", "paper_s=1.969")),
    5: (("paper_x1", "paper_s=0.011"), ("paper_x32", "paper_s=0.185")),
    6: (("paper_none_repl32", "paper_s=0.162"),
        ("paper_32KB_repl32", "paper_s=0.079")),
}
TITLES = {2: "Table II: component ablation",
          3: "Table III: contiguous access sweep",
          4: "Table IV: non-contiguous access sweep",
          5: "Table V: replicated reads",
          6: "Table VI: layout"}
GRID = (1024, 9216)   # Table II's interior, the paper's §VII domain
SIDE = 4096           # Tables III–V: the paper's 4096 x 4096 int32
COPY_BN = (4096, 1024, 512, 256, 128, 32, 8)
WIDTHS = ((1024, "aligned"), (1026, "misaligned+2"), (896, "aligned"),
          (514, "misaligned+2"), (512, "aligned"))
FACTORS = (1, 2, 4, 8, 16, 32)


def row(name: str, us: float, derived: str) -> str:
    return f"{name},{us:.3f},{derived}"


def timer(device: torch.device):
    """``fn -> microseconds of one call``: device time from CUDA events on
    the card, the host's wall time on the CPU."""
    if device.type == "cuda":
        from repro_torch.obs.timing import device_ms
        return lambda fn: device_ms(fn, reps=5, inner=10) * 1e3

    def host_us(fn) -> float:
        fn()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e6
    return host_us


def _sm90():
    from repro_torch.engine.device import get_device
    return get_device("gpu_sm90")


def model_gpts(bytes_per_point: float, flops_per_point: float) -> float:
    """Modeled stencil rate (GPt/s) on ``gpu_sm90``: min(memory, f32 math)."""
    dev = _sm90()
    return min(dev.dram_bw / max(bytes_per_point, 1e-9),
               dev.vector_flops / flops_per_point) / 1e9


def model_copy_s(nbytes: int, n_txn: int) -> float:
    """Modeled copy time on ``gpu_sm90``: bandwidth or transaction issue."""
    dev = _sm90()
    return max(nbytes / dev.dram_bw, n_txn * dev.txn_overhead_s)


def _ramp(side: int, dtype, device) -> torch.Tensor:
    return torch.arange(side * side, dtype=torch.int32,
                        device=device).reshape(side, side).to(dtype)


def table2(device, scale: int, time_us) -> list[str]:
    from repro_torch import engine
    from repro_torch.core.stencil import jacobi_2d_5pt, make_laplace_problem
    from repro_torch.kernels import components
    u = make_laplace_problem(GRID[0] // scale, GRID[1] // scale,
                             dtype=torch.bfloat16, device=device)
    spec = jacobi_2d_5pt()
    rows = [row("dma_only", time_us(lambda: components.dma_only(u, bm=64)),
                f"model_sm90_GPt/s={model_gpts(4.0, 0.01):.6g}"),
            row("compute_only",
                time_us(lambda: components.compute_only(u, bm=64)),
                f"model_sm90_GPt/s={model_gpts(0.02, 5.0):.6g}")]
    # Every non-fused policy of the engine registry, at the JAX table's 64-row
    # blocks (the fused temporal policy has no per-sweep breakdown).
    for p in engine.registry():
        if p.fused:
            continue
        us = time_us(lambda name=p.name: engine.step(u, spec, policy=name,
                                                     bm=64))
        gpts = model_gpts(p.bytes_per_point(spec, u.element_size(), 1), 5.0)
        rows.append(row(f"full_{p.name}", us,
                        f"model_sm90_GPt/s={gpts:.6g}"))
    return rows


def table3(device, scale: int, time_us) -> list[str]:
    from repro_torch.kernels.stream import stream_copy, stream_copy_rowdma
    side = SIDE // scale
    x = _ramp(side, torch.int32, device)
    nbytes = x.numel() * x.element_size()
    rows, bm = [], 256
    for bn in COPY_BN:
        if bn > side or side % bn or side % bm:
            continue
        us = time_us(lambda b=bn: stream_copy(x, bm=bm, bn=b))
        n_txn = (side // bm) * (side // bn) * bm  # one row span a txn
        rows.append(row(f"copy_block_bn{bn}", us,
                        f"txn_bytes={bn * 4};model_sm90_s="
                        f"{model_copy_s(nbytes, n_txn):.6g}"))
    dev = _sm90()
    for sync in (False, True):
        us = time_us(lambda s=sync: stream_copy_rowdma(x, bm=64, sync=s))
        model = (side * (dev.txn_overhead_s + side * 4 / dev.dram_bw)
                 if sync else model_copy_s(nbytes, side))
        rows.append(row(f"rowdma_sync={sync}", us,
                        f"model_sm90_s={model:.6g}"))
    return rows


def table4(device, scale: int, time_us) -> list[str]:
    from repro_torch.kernels.stream import stream_copy
    side = SIDE // scale
    x = _ramp(side, torch.int32, device)
    nbytes = x.numel() * x.element_size()
    rows = []
    # contiguous: full-width blocks; non-contiguous: tall narrow blocks
    for bm, bn in ((64, side), (256, 256), (1024, 64), (1024, 8)):
        if bm > side or bn > side or side % bm or side % bn:
            continue
        us = time_us(lambda a=bm, b=bn: stream_copy(x, bm=a, bn=b))
        n_txn = (side // bm) * (side // bn) * bm
        kind = "contig" if bn == side else "noncontig"
        rows.append(row(f"copy_{bm}x{bn}_{kind}", us,
                        f"txn_bytes={bn * 4};model_sm90_s="
                        f"{model_copy_s(nbytes, n_txn):.6g}"))
    return rows


def table5(device, scale: int, time_us) -> list[str]:
    from repro_torch.kernels.stream import stream_replicated
    side = SIDE // scale
    x = _ramp(side, torch.float32, device)
    nbytes = x.numel() * x.element_size()
    rows = []
    for factor in FACTORS:
        us = time_us(lambda f=factor: stream_replicated(x, bm=128, factor=f))
        rows.append(row(f"replicated_x{factor}", us,
                        f"model_sm90_s={factor * nbytes / _sm90().dram_bw:.6g}"))
    return rows


def layout_rows(w: int, scale: int = 1) -> int:
    """Table VI's height for width ``w``: the largest multiple of 128 with
    h * w <= 2**24 / scale**2 (64 MiB of f32 at scale 1), at least 128."""
    return max(128, 2**24 // w // scale**2 // 128 * 128)


def table6(device, scale: int, time_us) -> list[str]:
    from repro_torch.kernels.stream import stream_copy
    rows = []
    for w, note in WIDTHS:
        h = layout_rows(w, scale)
        x = torch.ones((h, w), dtype=torch.float32, device=device)
        us = time_us(lambda v=x, b=w: stream_copy(v, bm=128, bn=b))
        model = x.numel() * x.element_size() / _sm90().dram_bw
        rows.append(row(f"width_{w}_{note}", us,
                        f"rows={h};row_bytes={w * 4};model_sm90_s="
                        f"{model:.6g}"))
    return rows


TABLES = {2: table2, 3: table3, 4: table4, 5: table5, 6: table6}
E150 = "grayskull_e150"


def sim_rows(table: int, device) -> list[str]:
    """Table ``table``'s modeled ``sim_*`` rows (the JAX tables' formulas,
    on the port's simulator run on ``device``)."""
    from repro_torch.backends.report import (bytes_per_point,
                                             model_copy_seconds,
                                             tile_efficiency)

    def copy_s(**kw) -> float:
        return model_copy_seconds((SIDE, SIDE), "int32", device=E150,
                                  torch_device=device, **kw)

    rows = []
    if table == 3:
        for seg, sync, label in ((SIDE, False, "16KB_nosync"),
                                 (1024 // 4, False, "1KB_nosync"),
                                 (1, False, "4B_nosync"),
                                 (1, True, "4B_sync")):
            s = copy_s(seg_cols=seg, sync=sync)
            rows.append(row(f"sim_e150_{label}", 0.0,
                            f"txn_bytes={seg * 4};model_e150_s={s:.4f}"))
    elif table == 4:
        for seg, label in ((SIDE, "16KB"), (1, "4B")):
            rows.append(row(f"sim_e150_{label}_noncontig", 0.0,
                            f"model_e150_s={copy_s(seg_cols=seg):.4f}"))
    elif table == 5:
        from repro_torch import backends
        from repro_torch.core.stencil import jacobi_2d_5pt
        for factor in (1, 32):
            s = copy_s(seg_cols=SIDE, reads=factor)
            rows.append(row(f"sim_e150_x{factor}", 0.0,
                            f"model_e150_s={s:.4f}"))
        spec = jacobi_2d_5pt()
        u = torch.zeros((66, 130), dtype=torch.float32, device=device)
        for name in ("shifted", "rowchunk"):
            res = backends.simulate(u, spec, policy=name, iters=1,
                                    device=E150)
            rows.append(row(f"sim_counted_{name}", 0.0,
                            f"bytes_per_point={bytes_per_point(res):.2f};"
                            f"taps={spec.taps}"))
    elif table == 6:
        for interleaved, label in ((False, "none_repl32"),
                                   (True, "32KB_repl32")):
            s = copy_s(seg_cols=SIDE, reads=32, interleaved=interleaved)
            rows.append(row(f"sim_e150_{label}", 0.0,
                            f"model_e150_s={s:.4f}"))
        for w in (1024, 1026):
            eff = tile_efficiency(512, w, device=E150)
            rows.append(row(f"sim_e150_tile_width_{w}", 0.0,
                            f"tile_efficiency={eff:.3f}"))
    return rows


def table_rows(table: int, device="cuda", scale: int = 1) -> list[str]:
    """Table ``table``'s measured rows, its modeled ``sim_*`` rows, then
    its paper rows, as CSV."""
    from repro_torch.core.stencil import require_device
    if scale < 1:
        raise ValueError(f"scale must be positive; got {scale}")
    dev = require_device(device)
    rows = TABLES[table](dev, scale, timer(dev)) + sim_rows(table, dev)
    return rows + [row(name, 0.0, derived)
                   for name, derived in PAPER_ROWS[table]]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.access")
    ap.add_argument("--table", type=int, choices=sorted(TABLES),
                    help="one table (default: all five)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--scale", type=int, default=1,
                    help="divide every array's sides by this (CPU runs)")
    args = ap.parse_args(argv)
    from repro_torch.core.stencil import require_device
    dev = require_device(args.device)
    if dev.type == "cuda":
        print(f"# device: {torch.cuda.get_device_name(dev)} "
              f"(us_per_call: device time, CUDA events)")
    else:
        print("# device: cpu (us_per_call: host wall time of the plain "
              "versions, not a device time)")
    print("name,us_per_call,derived")
    for table in ([args.table] if args.table else sorted(TABLES)):
        print(f"# === {TITLES[table]} (table{table}, scale "
              f"{args.scale}) ===", flush=True)
        for line in table_rows(table, dev, args.scale):
            print(line, flush=True)


if __name__ == "__main__":
    main()

"""Time the tile kernels over a few (bm, bn) tiles on the card.

    PYTHONPATH=src python -m repro_torch.launch.tiles --dtype bfloat16

For each policy with a tile (rowchunk, dbuf, temporal) and each tile
that fits the ``gpu_sm90`` budget, prints the plan, the
kernel's device time on the paper's 1026 x 9218 grid (5-point Jacobi),
warm (calls back to back on one grid) and cold (the calls rotate over
grids of three times the L2: ``launch.sweep_ab.cold_ms``), and the rate
in interior points per second per sweep, warm. The default tile of the
2-D plan (``engine.plan.GPU_TILES``) is chosen from this table.
"""
from __future__ import annotations

import argparse

import torch

TILES = [(16, 128), (32, 128), (64, 128), (128, 128), (16, 256), (32, 256),
         (64, 256), (32, 64), (64, 64), (24, 112), (32, 112), (40, 112),
         (41, 112), (48, 112), (56, 112), (57, 112), (64, 112), (32, 96), (64, 96), (8, 504),
         (16, 504), (32, 504), (8, 1016), (16, 1016), (4, 2040), (8, 2040)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.tiles")
    ap.add_argument("--ny", type=int, default=1024)
    ap.add_argument("--nx", type=int, default=9216)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--t", type=int, default=8)
    args = ap.parse_args(argv)

    from repro_torch.core.stencil import jacobi_2d_5pt, make_laplace_problem
    from repro_torch.engine.plan import PlanError, plan_for
    from repro_torch.engine.policies import copy_ring, launch
    from repro_torch.launch.sweep_ab import cold_ms, cold_pairs
    from repro_torch.obs.timing import device_ms

    spec = jacobi_2d_5pt()
    u = make_laplace_problem(args.ny, args.nx, dtype=getattr(torch,
                                                             args.dtype))
    print(f"card: {torch.cuda.get_device_name(0)}  grid: {tuple(u.shape)} "
          f"{args.dtype}")
    out = torch.empty_like(u)
    copy_ring(u, out, spec.radius)
    pairs = cold_pairs(u, out)
    print("policy    bm   bn  smem_KiB  blocks  kernel_ms    cold_ms  "
          "GPt/s/sweep")
    for policy in ("rowchunk", "dbuf", "temporal"):
        timed = set()
        for bm, bn in TILES:
            try:
                plan = plan_for(u.shape, u.dtype, spec, policy, bm=bm, bn=bn,
                                t=args.t, device="gpu_sm90")
            except PlanError:
                continue
            bm, bn = plan.bm, plan.bn  # the realized tile (bn may clip)
            if (bm, bn) in timed:
                continue
            timed.add((bm, bn))
            ms = device_ms(lambda: launch(plan, u, out=out))
            cold = cold_ms(lambda x, o: launch(plan, x, out=o), pairs)
            gpts = args.ny * args.nx * plan.t / (ms * 1e-3) / 1e9
            print(f"{policy:9s} {bm:4d} {bn:4d} {plan.vmem_bytes / 1024:9.1f} "
                  f"{plan.nblocks:7d} {ms:10.6f} {cold:10.6f} {gpts:12.1f}")


if __name__ == "__main__":
    main()

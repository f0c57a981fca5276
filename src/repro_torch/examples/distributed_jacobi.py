"""The paper's multi-core scaling (§VII), done with real halo exchange.

Decomposes the paper's domain into shards in 2-D (like the paper's
"cores in Y x cores in X") on an in-process
:class:`~repro_torch.dist.ShardMesh`, every shard on one device (on a
card, its shards share that card: these are shards, not cards), and runs
the *same* problem under two exchange cadences: ``t=1`` (one halo
exchange per sweep) and ``t=4`` (four fused sweeps per depth-4 exchange,
the communication-avoiding schedule, with the temporal kernel advancing
all four sweeps per shard in one round-trip). Everything routes through
``engine.run_distributed``; the shared ``SweepSchedule``
(``engine.plan_distributed``) reports how many exchanges each cadence
costs: the same bit-exact answer, a quarter of the exchanges.

    PYTHONPATH=src python -m repro_torch.examples.distributed_jacobi \
        [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import engine
from repro_torch.core.stencil import jacobi_2d_5pt, make_laplace_problem
from repro_torch.dist import ShardMesh


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "distributed_jacobi")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ny", type=int, default=512)
    ap.add_argument("--nx", type=int, default=1152)
    ap.add_argument("--iters", type=int, default=64)
    args = ap.parse_args(argv)

    u0 = make_laplace_problem(args.ny, args.nx, dtype=torch.float32,
                              left=1.0, device=args.device)
    dev, iters, spec = u0.device, args.iters, jacobi_2d_5pt()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # Single-device reference via the engine: the distributed runs must
    # match it bit for bit in fp32 whatever the exchange cadence.
    want = engine.run(u0, policy="rowchunk", iters=iters)
    print(f"engine.run reference on {dev}: "
          f"mean={float(want[1:-1, 1:-1].mean()):.6f}")

    for mesh_shape in [(2, 2), (4, 2), (8, 1)]:
        nshard = mesh_shape[0] * mesh_shape[1]
        mesh = ShardMesh(mesh_shape, ("x", "y"), [dev] * nshard)
        for t in (1, 4):
            sched, shard_shape, _ = engine.plan_distributed(
                u0.shape, u0.dtype, spec, mesh=mesh, policy="temporal",
                iters=iters, t=t, row_axis="x", col_axis="y")

            def run():
                return engine.run_distributed(
                    u0, spec, mesh=mesh, policy="temporal", iters=iters,
                    t=t, row_axis="x", col_axis="y")

            if dev.type == "cuda":
                run()  # builds the kernels, warms the allocator
            sync()
            t0 = time.perf_counter()
            out = run()
            sync()
            dt = time.perf_counter() - t0
            gpts = args.ny * args.nx * iters / dt / 1e9
            err = float((out[1:-1, 1:-1] - want[1:-1, 1:-1]).abs().max())
            # What would this cadence cost on the paper's hardware? The
            # e150's PCIe-isolated cards bill the halo over the host link,
            # so the serial-vs-overlapped gap is worth seeing next to the
            # exchange count.
            bill = engine.price_exchange(sched, shard_shape=shard_shape,
                                         dtype=u0.dtype, spec=spec,
                                         device="grayskull_e150",
                                         mesh_shape=mesh_shape)
            print(f"{nshard} shards {mesh_shape} on {dev} t={t}: "
                  f"{dt * 1e3:7.1f} ms  {gpts:6.2f} GPt/s  "
                  f"exchanges={sched.exchanges:3d} (halo depth "
                  f"{sched.halo_depth}, shard {shard_shape})  "
                  f"max|err|={err:.2e}")
            print(f"    e150 bill: {bill.describe()}")
            assert err == 0.0, err


if __name__ == "__main__":
    main()

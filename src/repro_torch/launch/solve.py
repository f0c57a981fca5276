"""Single-device Jacobi solve on the port: the paper's own workload.

Runs Laplace diffusion on a ringed grid under any engine policy and
reports wall time, GPt/s and the final residual. Runs on the card unless
``--device cpu`` is given; without a card it fails.

  PYTHONPATH=src python -m repro_torch.launch.solve --ny 1024 --nx 9216 \\
      --iters 1003 --dtype bfloat16 --check

``--check`` compares against the port's own ``reference`` policy (the
plain oracle) at the realized iteration count: max |err| < 1e-4 in f32,
5e-2 in bf16. A bf16 solve may instead be within 5e-2 of the reference
run in f32 from the same start: the reference rounds to bf16 after every
sweep and drifts from the f32 solve over many sweeps, while the fused
temporal policy rounds once per block and stays near the f32 solve.
"""
from __future__ import annotations

import argparse
import time

import torch

POLICIES = ["reference", "shifted", "rowchunk", "dbuf", "temporal", "auto"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.solve")
    ap.add_argument("--ny", type=int, default=512)
    ap.add_argument("--nx", type=int, default=512)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--kernel", default="auto", choices=POLICIES,
                    help="engine policy")
    ap.add_argument("--t", type=int, default=None,
                    help="sweeps per fused block (temporal)")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--tol", type=float, default=None,
                    help="stop at the first block of t sweeps whose "
                         "max-norm update delta is <= TOL "
                         "(engine.run_converged)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the grid lives; cuda launches the kernels")
    ap.add_argument("--check", action="store_true",
                    help="verify against the reference policy")
    args = ap.parse_args(argv)

    from repro_torch import engine
    from repro_torch.core.stencil import jacobi_2d_5pt, make_laplace_problem

    dtype = getattr(torch, args.dtype)
    u0 = make_laplace_problem(args.ny, args.nx, dtype=dtype, left=1.0,
                              right=0.0, device=args.device)
    dev = u0.device
    if dev.type == "cuda":
        print(f"card: {torch.cuda.get_device_name(dev)}")

    def solve():
        if args.tol is not None:
            return engine.run_converged(u0, tol=args.tol,
                                        max_iters=args.iters,
                                        policy=args.kernel, t=args.t)
        out = engine.run(u0, policy=args.kernel, iters=args.iters, t=args.t)
        return out, args.iters, None

    solve()  # builds the kernels and warms the allocator
    _sync(dev)
    t0 = time.perf_counter()
    out, iters_done, res = solve()
    _sync(dev)
    dt = time.perf_counter() - t0
    if res is None:
        res = float(engine.residual_for()(out))

    if args.tol is None:
        sched = engine.build_schedule(args.iters, spec=jacobi_2d_5pt(),
                                      shape=u0.shape, dtype=dtype,
                                      policy=args.kernel, t=args.t)
        print(f"schedule: {sched.describe()}")
    inner = out[1:-1, 1:-1].to(torch.float32)
    print(f"kernel={args.kernel} device={dev} grid={args.ny}x{args.nx} "
          f"dtype={args.dtype} iters={iters_done}/{args.iters}")
    gpts = args.ny * args.nx * max(iters_done, 1) / dt / 1e9
    print(f"wall={dt:.6f}s  GPt/s={gpts:.3f}  residual={res:.3e}  "
          f"mean={float(inner.mean()):.6f}  max={float(inner.max()):.6f}")

    if args.check:
        limit = 1e-4 if dtype == torch.float32 else 5e-2
        errs = {}
        starts = {args.dtype: u0, "float32": u0.float()}
        for name, start in starts.items():
            want = engine.run(start, policy="reference", iters=iters_done)
            errs[name] = float((inner - want[1:-1, 1:-1].float()).abs().max())
            print(f"max |err| vs reference in {name} at {iters_done} iters: "
                  f"{errs[name]:.3e}")
        if not min(errs.values()) < limit:
            raise SystemExit(f"CHECK FAILED: {min(errs.values()):.3e} >= "
                             f"{limit:g}")
        print("CHECK OK")


if __name__ == "__main__":
    main()

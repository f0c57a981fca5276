"""Quickstart: solve Laplace diffusion with the spec-driven stencil engine.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch import backends, engine
from repro_torch.core.jacobi import jacobi_solve
from repro_torch.core.stencil import (jacobi_2d_5pt, laplace_2d_9pt,
                                      make_laplace_problem)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "quickstart")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    # Every plan is validated against a device model; with none named,
    # the card this process launches on is detected (gpu_sm90 on an H100,
    # cpu_ref without one).
    print(f"detected device model: {engine.detect().describe()}")

    # 128x128 interior, hot (1.0) left wall, cold (0.0) right wall.
    u0 = make_laplace_problem(128, 128, left=1.0, right=0.0,
                              device=args.device)

    # Solve to 1e-5 with the paper-faithful row-chunk policy (§VI design).
    u, iters, res = jacobi_solve(u0, tol=1e-5, check_every=200,
                                 policy="rowchunk")
    print(f"converged in ~{iters} sweeps, residual {res:.2e}")

    mid = u[64, 1:-1].float().cpu()
    print("mid-row profile (should fall smoothly 1 -> 0):")
    print("  ", " ".join(f"{float(v):.2f}" for v in mid[::16]))

    # Fixed-iteration runs go through engine.run; "auto" picks a policy
    # from the fast-memory/traffic heuristic (temporal blocking here, 8
    # sweeps per round-trip). Any StencilSpec gets every policy, e.g. the
    # 9-point Laplacian.
    u9 = engine.run(u0, laplace_2d_9pt(), policy="auto", iters=100)
    u5 = engine.run(u0, jacobi_2d_5pt(), policy="temporal", iters=100, t=4)
    print(f"engine.run 9-pt auto:      mean={float(u9.mean()):.6f}")
    print(f"engine.run 5-pt temporal:  mean={float(u5.mean()):.6f}")

    # --- Backend lowering & simulation (--backend sim) -------------------
    # The same solve, lowered to a Grayskull-style decoupled three-kernel
    # program (reader/compute/writer over circular buffers of 32x32 tiles)
    # and run on the functional simulator: the same numbers in fp32, plus
    # MODELED GPt/s and per-kernel counters for the e150 device model.
    # The CLI twin is
    #   python -m repro_torch.launch.solve --ny 256 --nx 256 --iters 100 \
    #       --kernel rowchunk --backend sim --device-model grayskull_e150
    v0 = make_laplace_problem(256, 256, left=1.0, right=0.0,
                              device=args.device)
    sim = backends.simulate(v0, jacobi_2d_5pt(), policy="rowchunk",
                            iters=100, device="grayskull_e150")
    ref = engine.run(v0, jacobi_2d_5pt(), policy="rowchunk", iters=100)
    s = backends.report.summarize(sim)
    print("\nbackend sim on 256x256 Jacobi (grayskull_e150 model):")
    print(sim.programs[0].describe())
    print(f"model_GPt/s={s['gpts']:.3f}  model_energy_J={s['energy_j']:.3f} "
          f"(MODELED)  bytes/pt={s['bytes_per_point']:.2f}  "
          f"dram_txns={s['dram_txns']}")
    # Agreement is bit for bit wherever the field is in the fp32 normal
    # range; the simulator flushes only the finished tap sum (as the
    # reference's does), the engine every operation, so the far corner's
    # decaying tail may differ below the smallest normal.
    err = float((sim.grid.float() - ref.float()).abs().max())
    print(f"simulator vs engine.run max |err|: {err:.3e}")
    assert err < 1e-30


if __name__ == "__main__":
    main()

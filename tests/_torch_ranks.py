"""The rank side of ``tests/test_torch_dist_process.py``: what each of four
gloo processes runs (started by ``repro_torch.dist.process.spawn``). It
imports only the port, so the ranks start fast; the test compares what
they save against the in-process mesh, the single-device solve and the
JAX package.
"""
import contextlib
import io
import os

import numpy as np
import torch

from repro_torch import engine as TE
from repro_torch.core import stencil as TS
from repro_torch.dist import ProcessMesh
from repro_torch.obs.trace import Tracer, use_tracer

DIAG9 = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0),
         (1, 1))
ROW3 = ((0, -1), (0, 0), (0, 1))
SPECS = {"jacobi5": TS.jacobi_2d_5pt(),
         "diff3": TS.StencilSpec(offsets=ROW3, weights=(0.25, 0.5, 0.25)),
         "diag9": TS.StencilSpec(offsets=DIAG9, weights=(0.125,) * 8)}
MESHES = {"4": ((4,), ("x",)), "2x2": ((2, 2), ("x", "y"))}
POLICIES = ("reference", "shifted", "rowchunk", "temporal")
ITERS = 6
MATRIX = [(s, p, t, o) for s in SPECS for p in POLICIES for t in (1, 3)
          for o in (True, False)]
JAX_CASES = [(s, p, d) for s in ("jacobi5", "diag9")
             for p in ("temporal", "rowchunk")
             for d in ("float32", "bfloat16")]
CLI = ["--devices", "4", "--depth", "8", "--device", "cpu", "--check",
       "--ny", "64", "--nx", "128", "--iters", "19"]


def grid(ny=32, nx=64, seed=0, ring=False) -> np.ndarray:
    """A ringed grid: the Laplace problem's ring (or a random one) around
    a random interior (``tests/test_torch_dist.py``'s)."""
    rng = np.random.default_rng(seed)
    a = np.zeros((ny + 2, nx + 2), np.float32)
    a[:, 0] = 1.0
    if ring:
        a[0, :], a[-1, :] = rng.uniform(0, 1, (2, nx + 2))
        a[:, 0], a[:, -1] = rng.uniform(0, 1, (2, ny + 2))
    a[1:-1, 1:-1] = rng.uniform(0, 1, (ny, nx))
    return a


def work(rank: int, out_dir: str, mesh_name: str) -> None:
    """Run the matrix, the JAX cases, two traced runs and (on the row
    mesh) the CLI on this rank; save what came out."""
    shape, axes = MESHES[mesh_name]
    mesh = ProcessMesh(shape, axes, device="cpu")
    res = {"coords": mesh.coords, "devices": [str(d) for d in mesh.devices],
           "backend": mesh.backend}
    u = torch.from_numpy(grid(ring=True))
    for spec, policy, t, overlap in MATRIX:
        res[("matrix", spec, policy, t, overlap)] = TE.run_distributed(
            u, SPECS[spec], mesh=mesh, policy=policy, iters=ITERS, t=t,
            overlap=overlap)
    a = torch.from_numpy(grid(seed=5))
    for spec, policy, dtype in JAX_CASES:
        res[("jax", spec, policy, dtype)] = TE.run_distributed(
            a.to(getattr(torch, dtype)), SPECS[spec], mesh=mesh,
            policy=policy, iters=7, t=3)
    v = TS.make_laplace_problem(32, 128, device="cpu")
    for overlap in (False, True):
        kw = dict(mesh=mesh, policy="temporal", iters=10, t=4,
                  overlap=overlap)
        tracer = Tracer()
        with use_tracer(tracer):
            on = TE.run_distributed(v, SPECS["jacobi5"], **kw)
        names = [e.name for e in tracer.events]
        res[("traced", overlap)] = (
            torch.equal(on, TE.run_distributed(v, SPECS["jacobi5"], **kw)),
            names.count("dist.round"), names.count("exchange"))
    if mesh_name == "4":
        from repro_torch.launch import solve
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            solve.main(CLI)
        res["cli"] = buf.getvalue()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))

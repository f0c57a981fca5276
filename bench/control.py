"""The control: the plain reference put in the program's place, its taps
summed in bfloat16, the nearest precision below the f32 arithmetic every
configuration states. A run with ``--control`` must come out not
correct; the benchmark's own runs never take it.
"""
from __future__ import annotations

import time

import torch

from bench.reference import jacobi as ref

LOW = torch.bfloat16


def solve(u: torch.Tensor, cfg: dict, iters: int) -> torch.Tensor:
    st = cfg["stencil"]
    return ref.run(u, st["offsets"], st["weights"], iters, arith=LOW,
                   store_every=cfg["store_every"])


class Server:
    """A solve server's interface over the low-precision reference: each
    step finishes the oldest request, its result on the host."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.queue: list = []
        self.launches = 0
        self.completed = 0

    def submit(self, req):
        req.submitted_s = time.perf_counter()
        self.queue.append(req)
        return req

    def step(self) -> int:
        if not self.queue:
            return 0
        req = self.queue.pop(0)
        st = self.cfg["stencil"]
        t = req.t
        v, iters, res, conv = ref.run_converged(
            req.grid, st["offsets"], st["weights"], tol=req.tol,
            max_iters=req.max_iters, t=t, arith=LOW)
        req.result = v.to("cpu", copy=True)
        req.iters_done, req.residual, req.converged = iters, res, conv
        req.done = True
        req.finished_s = time.perf_counter()
        self.launches += 1
        self.completed += 1
        return 1

    def stats(self) -> dict:
        return {"launches": self.launches, "completed": self.completed}

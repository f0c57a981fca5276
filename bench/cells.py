"""The one-card runs: solves one at a time, and solves served.

Each run makes its set-up (the first call builds the kernels; then it
warms the shapes its traffic uses), measures for ``run.seconds``, reads
the device's peak memory, frees the program's state and only then runs
the reference over a sample of the answers, drawn from the seed.
"""
from __future__ import annotations

import contextlib
import random
import time

import torch

from bench import checks, control, devicetrace, roofline
from bench.harness import note
from bench.inputs import (CURVE, SAMPLE, TIMED, WARM, Mix, Reservoir,
                          make_grid, radius, stream_seed)
from bench.reference import jacobi as ref

#: A tolerance every residual meets: warm-up requests end after a block.
WARM_TOL = 1e30


def program_spec(cfg: dict):
    from repro_torch.core.stencil import StencilSpec
    st = cfg["stencil"]
    return StencilSpec(offsets=tuple(tuple(o) for o in st["offsets"]),
                       weights=tuple(st["weights"]))


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_kind(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def memory_peak(dev: torch.device) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def traced(run):
    """The profiled window of a ``--trace 1`` run, else nothing."""
    if run.trace:
        return devicetrace.window(run.device)
    return contextlib.nullcontext()


def trace_ctx(rec) -> dict:
    """What the metrics read of a traced window, and its breakdown."""
    if rec is None:
        return {}, None
    red = devicetrace.reduce(rec.events)
    return ({"busy_s": red["busy_s"], "trace_window_s": rec.window_s},
            {"device_ops": red["device_ops"],
             "idle_gaps": red["idle_gaps"]})


def work(cfg: dict, solves: int, sweeps: int, kind: str) -> dict:
    """The window's work and its least time on one card."""
    ny, nx = cfg["ny"], cfg["nx"]
    taps = len(cfg["stencil"]["offsets"])
    flops = roofline.solve_flops(ny, nx, taps, sweeps) * solves
    nbytes = roofline.solve_bytes(ny, nx, radius(cfg), cfg["dtype"]) * solves
    ctx = {"work_points": float(ny) * nx * sweeps * solves, "solves": solves}
    if kind != "cpu":
        ctx["least_time_s"], _ = roofline.least_time(flops, nbytes, kind)
    return ctx


def judge_grid(cfg: dict, got: torch.Tensor, grid: torch.Tensor,
               iters: int) -> dict:
    """``got`` against ``iters`` sweeps of the reference from ``grid``,
    stored in the grid's dtype every ``store_every`` sweeps as the
    configuration states."""
    st = cfg["stencil"]
    want = ref.run(grid, st["offsets"], st["weights"], iters,
                   store_every=cfg["store_every"])
    return checks.check("grid_max_abs_diff", checks.max_abs_diff(got, want),
                        cfg["limits"]["grid_max_abs_diff"])


def run_fixed(run) -> dict:
    """``engine.run`` back to back, one caller, synchronized after each
    solve; each solve a fresh grid."""
    from repro_torch import engine
    cfg, tr, dev = run.cfg, run.traffic, run.device
    iters = cfg["iters"]
    spec = program_spec(cfg)
    if run.control:
        def solve(u):
            return control.solve(u, cfg, iters)
    else:
        def solve(u):
            return engine.run(u, spec, policy=tr["policy"], iters=iters)
    for j in range(tr["warm"]):
        solve(make_grid(cfg, run.seed, WARM, j, dev))
        sync(dev)
        note(run.t_start, f"warm solve {j}")
    ctx = {"setup_s": time.perf_counter() - run.t_start}
    keep = Reservoir(tr["check_sample"], run.seed)
    engine.reset_launch_counts()
    rec = None
    with traced(run) as rec:
        t0 = time.perf_counter()
        n = 0
        while True:
            with devicetrace.label("bench.make_grid", run.trace):
                u = make_grid(cfg, run.seed, TIMED, n, dev)
            with devicetrace.label("bench.solve", run.trace):
                out = solve(u)
            with devicetrace.label("bench.sync", run.trace):
                sync(dev)
            keep.offer((n, out))
            n += 1
            now = time.perf_counter()
            if now - t0 >= run.seconds:
                break
        ctx["window_s"] = now - t0
    ctx["launches"] = sum(engine.LAUNCHES.values())
    peak = memory_peak(dev)
    del u, out
    kind = device_kind(dev)
    ctx.update(work(cfg, n, iters, kind))
    tctx, breakdown = trace_ctx(rec)
    ctx.update(tctx)
    found = [judge_grid(cfg, got, make_grid(cfg, run.seed, TIMED, i, dev),
                        iters) for i, got in keep.items]
    return {"ctx": ctx, "checks": checks.merge(found),
            "correct": checks.passed(found), "attempted": n, "failed": 0,
            "memory_peak_bytes": peak, "device_kind": kind,
            "breakdown": breakdown}


def residual_curve(cfg: dict, u: torch.Tensor, blocks: int,
                   t: int) -> list[float]:
    """The residual after each block of ``t`` sweeps of one solo solve,
    by the plain reference: the traffic owes nothing to the program."""
    st = cfg["stencil"]
    u = u.to(torch.float32)
    curve = []
    for _ in range(blocks):
        u = ref.run(u, st["offsets"], st["weights"], t)
        curve.append(float(ref.residual(u, st["offsets"], st["weights"])))
    return curve


class _Request:
    """A request as its caller sees it."""

    __slots__ = ("k", "req", "due", "done_s", "rejected")

    def __init__(self, k, req, due):
        self.k, self.req, self.due = k, req, due
        self.done_s = None
        self.rejected = False


def run_served(run) -> dict:
    """Requests through one ``SolveServer``: a closed loop of ``callers``,
    each submitting its next request when its last result is on the
    host; each request a fresh grid."""
    from repro_torch.serve import SolveRequest, SolveServer
    from repro_torch.serve.solve import SolveRejected
    cfg, tr, dev = run.cfg, run.traffic, run.device
    max_iters, t = tr["max_iters"], tr["t"]
    spec = program_spec(cfg)
    mix = Mix(tr, run.seed, residual_curve(
        cfg, make_grid(cfg, tr["curve_seed"], CURVE, 0, dev),
        max_iters // t, t))
    note(run.t_start, "residual curve")
    server = (control.Server(cfg) if run.control else
              SolveServer(torch_device=dev, **tr["server"]))

    def request(grid, tol):
        return SolveRequest(grid=grid, spec=spec, tol=tol,
                            max_iters=max_iters, t=t)

    def drain(reqs):
        while not all(r.done for r in reqs):
            server.step()

    j = 0
    for width in tr["warm_widths"]:
        reqs = []
        for _ in range(width):
            reqs.append(server.submit(request(
                make_grid(cfg, run.seed, WARM, j, dev), WARM_TOL)))
            j += 1
        drain(reqs)
        note(run.t_start, f"warm width {width}")
    sync(dev)
    ctx = {"setup_s": time.perf_counter() - run.t_start}
    base = server.stats()
    records: list[_Request] = []
    inflight: list[_Request] = []

    def submit(due):
        k = len(records)
        with devicetrace.label("bench.make_grid", run.trace):
            r = _Request(k, request(make_grid(cfg, run.seed, TIMED, k, dev),
                                    mix.tol(k)), due)
        records.append(r)
        try:
            with devicetrace.label("bench.submit", run.trace):
                server.submit(r.req)
            inflight.append(r)
        except SolveRejected:
            r.rejected = True

    def collect(now) -> int:
        done = [r for r in inflight if r.req.done]
        for r in done:
            r.done_s = now
            inflight.remove(r)
        return len(done)

    completed = 0
    rec = None
    with traced(run) as rec:
        t0 = time.perf_counter()
        for _ in range(tr["callers"]):
            submit(time.perf_counter())
        while True:
            with devicetrace.label("bench.step", run.trace):
                server.step()
            now = time.perf_counter()
            completed += collect(now)
            if now - t0 >= run.seconds:
                break
            for _ in range(tr["callers"] - len(inflight)):
                submit(time.perf_counter())
        ctx["window_s"] = now - t0
        stats = server.stats()
    while inflight:
        server.step()
        collect(time.perf_counter())
    peak = memory_peak(dev)
    ctx["served_completed"] = completed
    ctx["server_launches"] = stats["launches"] - base["launches"]
    ctx["server_completed"] = stats["completed"] - base["completed"]
    ctx["latencies_s"] = [r.done_s - r.due for r in records
                          if r.done_s is not None]
    kind = device_kind(dev)
    tctx, breakdown = trace_ctx(rec)
    ctx.update(tctx)
    done = [r for r in records if r.done_s is not None]
    sample = _sample(done, tr["check_sample"], run.seed)
    answers = [(r.k, r.req.tol, r.req.result, r.req.iters_done,
                r.req.residual, r.req.converged) for r in sample]
    failed = sum(r.rejected for r in records)
    del server, records, inflight, done, sample
    found = []
    st = cfg["stencil"]
    lim = cfg["limits"]
    for k, tol, result, iters, res, conv in answers:
        want, w_iters, w_res, w_conv = ref.run_converged(
            make_grid(cfg, run.seed, TIMED, k, dev).to(torch.float32),
            st["offsets"], st["weights"], tol=tol, max_iters=max_iters, t=t)
        found += [
            checks.check("grid_max_abs_diff",
                         checks.max_abs_diff(result, want),
                         lim["grid_max_abs_diff"]),
            checks.check("iters_off", abs(iters - w_iters), lim["iters_off"]),
            checks.check("residual_abs_diff", checks.abs_gap(res, w_res),
                         lim["residual_abs_diff"]),
            checks.check("converged_mismatch", float(conv != w_conv),
                         lim["converged_mismatch"])]
    return {"ctx": ctx, "checks": checks.merge(found),
            "correct": checks.passed(found) and bool(answers),
            "attempted": len(ctx["latencies_s"]) + failed, "failed": failed,
            "memory_peak_bytes": peak, "device_kind": kind,
            "breakdown": breakdown}


def _sample(done: list, k: int, seed: int) -> list:
    """``k`` finished requests drawn from the seed, the one that ran the
    most sweeps among them."""
    if not done:
        return []
    longest = max(done, key=lambda r: r.req.iters_done)
    rest = [r for r in done if r is not longest]
    rng = random.Random(stream_seed(seed, SAMPLE, 1))
    return [longest] + rng.sample(rest, min(k - 1, len(rest)))

"""Drive the PyTorch/CUDA port on one NVIDIA card and check every kernel.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
   source, all started together) and report the build time;
3. hold each kernel (K1 temporal, K2 rowchunk, K3 dbuf, K4 shifted)
   against its plain PyTorch version on the card at 1026 x 9218 (the
   paper's 1024 x 9216 domain with its ring), for the 5-point, 9-point and
   a radius-2 spec, in f32 and bf16, K1 with and without a pin mask: all
   bit for bit. Time each kernel, its plain version and, for one sweep,
   ``torch.nn.functional.conv2d`` as a yardstick (TF32 off);
4. the main path, ``engine.run(make_laplace_problem(1024, 9216),
   policy="auto", iters=1003)`` in bf16 and f32: the schedule must be 125
   temporal blocks of t=8 plus 3 rowchunk sweeps, the launch counters must
   show 125 K1 and 3 K2 launches, the result must equal the same schedule
   of plain functions bit for bit and be within f32 1e-4 / bf16 5e-2 of
   the reference policy run in f32 from the same start (the bf16 reference
   rounds after every sweep and drifts from the f32 solve; its drift is
   printed beside the error);
5. the other paths: ``step`` (auto picks dbuf, K3), the ``shifted``
   policy (K4), ``run_converged`` with a tolerance that stops early, and
   ``run_batched`` with B=4, each lane equal to its solo run bit for bit;
6. one JSON line listing the kernels, then the card's name and power
   limit, then the result line.

It imports nothing of JAX and nothing of the ``repro`` package, and exits
non-zero without a card or outside a checkout of the repository.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False; this script "
             "drives the CUDA kernels and needs a card")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch import engine  # noqa: E402
from repro_torch.core.stencil import (StencilSpec, apply_stencil,  # noqa: E402
                                      jacobi_2d_5pt, laplace_2d_9pt,
                                      make_laplace_problem)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.obs.timing import device_ms  # noqa: E402

NY, NX, ITERS, T = 1024, 9216, 1003, 8
RADIUS2 = StencilSpec(offsets=((-2, 0), (-1, 0), (0, 0), (0, -2), (0, 1)),
                      weights=(0.1, 0.3, 0.2, 0.15, 0.25))
SPECS = {"jacobi5": jacobi_2d_5pt(), "laplace9": laplace_2d_9pt(),
         "radius2": RADIUS2}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
KERNELS = {  # policy -> (id, TPU kernel it replaces)
    "temporal": ("K1", "src/repro/engine/policies.py:286"),
    "rowchunk": ("K2", "src/repro/engine/policies.py:127"),
    "dbuf": ("K3", "src/repro/engine/policies.py:203"),
    "shifted": ("K4", "src/repro/engine/policies.py:83"),
}
SOURCE = "src/repro_torch/csrc/stencil.cu"
# (memory bytes/s, f32 FLOP/s outside the tensor cores), data-sheet peaks.
PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12),
         "H200": (4.8e12, 67e12), "H100": (3.35e12, 67e12)}


def card() -> tuple[str, tuple[float, float]]:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    peaks = next((v for k, v in PEAKS.items() if k in name), PEAKS["H100"])
    return line, peaks


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def grid(spec: StencilSpec, dtype, seed: int) -> torch.Tensor:
    r = spec.radius
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.rand((NY + 2 * r, NX + 2 * r), generator=g,
                      device="cuda").to(dtype)


def bound_ms(policy: str, spec: StencilSpec, u: torch.Tensor, t: int,
             peaks) -> tuple[float, str]:
    """Least time for the function: each input byte read once and each
    output byte written once, against the f32 operations it must do."""
    bw, flops = peaks
    r = spec.radius
    hi, wi = u.shape[-2] - 2 * r, u.shape[-1] - 2 * r
    nbytes = u.numel() * u.element_size() + hi * wi * u.element_size()
    ops = (2 * spec.taps - 1) * hi * wi * (t if policy == "temporal" else 1)
    b_ms, o_ms = nbytes / bw * 1e3, ops / flops * 1e3
    return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations")


def conv_yardstick(spec: StencilSpec, u: torch.Tensor):
    """One sweep's interior as one cuDNN convolution (timed only)."""
    r = spec.radius
    w = torch.zeros((1, 1, 2 * r + 1, 2 * r + 1), dtype=u.dtype,
                    device=u.device)
    for (dy, dx), wt in zip(spec.offsets, spec.weights):
        w[0, 0, dy + r, dx + r] = wt
    x = u[None, None]
    return lambda: torch.nn.functional.conv2d(x, w)


def phase_kernels(peaks, stats) -> None:
    print("== phase 3: kernels vs plain versions, bit for bit, "
          f"{NY + 2}x{NX + 2} ==")
    for spec_name, spec in SPECS.items():
        for dname, dtype in DTYPES.items():
            u = grid(spec, dtype, seed=len(spec_name))
            out = torch.empty_like(u)
            engine.policies.copy_ring(u, out, spec.radius)
            mask = torch.rand(u.shape, device="cuda") < 0.01
            cases = [(p, {}) for p in ("rowchunk", "dbuf", "shifted")]
            cases += [("temporal", {"t": T}), ("temporal", {"t": T,
                                                           "mask": mask})]
            for policy, kw in cases:
                got = getattr(engine, f"stencil_{policy}")(u, spec, **kw)
                want = getattr(engine, f"stencil_{policy}_plain")(u, spec,
                                                                  **kw)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                label = policy + (" masked" if "mask" in kw else "")
                check(torch.equal(got, want),
                      f"{label} {spec_name} {dname}: max |err| {err}")
                s = stats.setdefault(policy, {"max_abs_err": 0.0})
                s["max_abs_err"] = max(s["max_abs_err"], err)
                if spec_name != "jacobi5" or "mask" in kw:
                    print(f"{label:16s} {spec_name:9s} {dname:8s} bitwise")
                    continue
                fn = getattr(engine, f"stencil_{policy}")
                plain = getattr(engine, f"stencil_{policy}_plain")
                k_ms = device_ms(lambda: fn(u, spec, out=out, **kw))
                p_ms = device_ms(lambda: plain(u, spec, **kw), reps=3,
                                 inner=3)
                lib_ms = None if policy == "temporal" else device_ms(
                    conv_yardstick(spec, u))
                b_ms, b_by = bound_ms(policy, spec, u, kw.get("t", 1), peaks)
                print(f"{label:16s} {spec_name:9s} {dname:8s} bitwise  "
                      f"kernel_ms={k_ms:.6f} plain_ms={p_ms:.6f} "
                      f"bound_ms={b_ms:.6f} ({b_by}) library_ms="
                      f"{'null' if lib_ms is None else f'{lib_ms:.6f}'}")
                s[dname] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                            "bound_by": b_by, "library_ms": lib_ms}


def plain_schedule(u: torch.Tensor, spec: StencilSpec, sched) -> torch.Tensor:
    for _ in range(sched.fused_blocks):
        u = engine.stencil_temporal_plain(u, spec, t=sched.t)
    for _ in range(sched.remainder):
        u = engine.stencil_rowchunk_plain(u, spec)
    return u


def counted(fn):
    """Run ``fn`` with the launch counters zeroed just before; return its
    result and the counts read just after."""
    engine.reset_launch_counts()
    res = fn()
    torch.cuda.synchronize()
    return res, dict(engine.LAUNCHES)


def phase_main(smi: str, stats) -> None:
    print("== phase 4: main path, engine.run(policy='auto', "
          f"iters={ITERS}) at {NY}x{NX} ==")
    spec = jacobi_2d_5pt()
    for dname in ("bfloat16", "float32"):
        dtype = DTYPES[dname]
        u0 = make_laplace_problem(NY, NX, dtype=dtype)
        sched = engine.build_schedule(ITERS, spec=spec, shape=u0.shape,
                                      dtype=dtype)
        print(f"[{dname}] schedule: {sched.describe()}")
        check((sched.policy, sched.t, sched.fused_blocks, sched.remainder,
               sched.remainder_policy) == ("temporal", T, 125, 3,
                                           "rowchunk"),
              f"schedule {sched}")
        engine.run(u0, policy="auto", iters=ITERS)  # warm the allocator
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, counts = counted(lambda: engine.run(u0, policy="auto",
                                                 iters=ITERS))
        wall = time.perf_counter() - t0
        print(f"[{dname}] launches: {counts}")
        check(counts == {"shifted": 0, "rowchunk": 3, "dbuf": 0,
                         "temporal": 125}, f"launch counts {counts}")
        if dname == "bfloat16":
            stats["temporal"].update(launches=counts["temporal"],
                                     path="engine.run(auto, iters=1003)")
            stats["rowchunk"].update(launches=counts["rowchunk"],
                                     path="engine.run(auto, iters=1003)")
        check(out.shape == u0.shape and bool(out.float().isfinite().all()),
              "finite output of the grid's shape")
        check(torch.equal(out, plain_schedule(u0, spec, sched)),
              "main path != the same schedule of plain functions")
        ref = engine.run(u0, policy="reference", iters=ITERS)
        ref32 = engine.run(u0.float(), policy="reference", iters=ITERS)
        err = float((out.float() - ref32).abs().max())
        err_same = float((out.float() - ref.float()).abs().max())
        drift = float((ref.float() - ref32).abs().max())
        limit = 1e-4 if dtype == torch.float32 else 5e-2
        print(f"[{dname}] max |err| vs reference in f32: {err:.6e}; vs "
              f"reference in {dname}: {err_same:.6e}; the {dname} "
              f"reference's own drift from f32: {drift:.6e}")
        check(err < limit, f"max |err| vs the f32 reference {err} >= {limit}")
        gpts = NY * NX * ITERS / wall / 1e9
        res = float(engine.residual_for(spec)(out))
        print(f"[{dname}] bitwise == plain schedule; within {limit:g} of "
              f"the f32 reference; residual {res:.6e}")
        print(f"[{dname}] wall={wall:.6f}s GPt/s={gpts:.3f} on {smi}")


def phase_paths(stats) -> None:
    print("== phase 5: step, shifted, run_converged, run_batched ==")
    spec = jacobi_2d_5pt()
    u0 = make_laplace_problem(NY, NX, dtype=torch.bfloat16)
    check(engine.resolve_auto(u0.shape, u0.dtype, spec, iters=1) == "dbuf",
          "auto single step should pick dbuf")
    out, counts = counted(lambda: engine.step(u0, spec))
    print(f"step(auto): launches {counts}")
    check(counts["dbuf"] == 1 and torch.equal(out, apply_stencil(u0, spec)),
          "step(auto) must launch dbuf once and equal the oracle")
    stats["dbuf"].update(launches=counts["dbuf"], path="engine.step(auto)")
    out, counts = counted(lambda: engine.run(u0, spec, policy="shifted",
                                             iters=3))
    print(f"run(shifted, iters=3): launches {counts}")
    want = u0
    for _ in range(3):
        want = apply_stencil(want, spec)
    check(counts["shifted"] == 3 and torch.equal(out, want),
          "shifted policy must launch 3 times and equal the oracle")
    stats["shifted"].update(launches=counts["shifted"],
                            path="engine.run(shifted, iters=3)")

    u32 = make_laplace_problem(NY, NX, dtype=torch.float32)
    tol = float(engine.residual_for(spec)(engine.run(u32, iters=400)))
    (cu, n, res), counts = counted(lambda: engine.run_converged(
        u32, spec, tol=tol, max_iters=ITERS))
    print(f"run_converged(tol={tol:.6e}): iters {n}/{ITERS}, residual "
          f"{res:.6e}, launches {counts}")
    check(n % T == 0 and 0 < n <= 400 and res <= tol,
          "run_converged must stop early on a cadence boundary")
    check(torch.equal(cu, engine.run(u32, iters=n)),
          "run_converged result != run(iters=iters_done)")

    lanes = torch.stack([make_laplace_problem(NY, NX, dtype=torch.bfloat16,
                                              left=1.0 - 0.2 * i,
                                              top=0.1 * i)
                         for i in range(4)])
    got, counts = counted(lambda: engine.run_batched(lanes, spec, iters=67))
    print(f"run_batched(B=4, iters=67): launches {counts}")
    check(counts == {"shifted": 0, "rowchunk": 3, "dbuf": 0, "temporal": 8},
          "a batch is one launch per block")
    for i in range(4):
        check(torch.equal(got[i], engine.run(lanes[i].clone(), spec,
                                             iters=67)),
              f"batched lane {i} != its solo run")
    print("run_batched: every lane bitwise equal to its solo run")


def main() -> None:
    smi, peaks = card()
    print(f"== phase 1: card: {smi} ==")
    t0 = time.perf_counter()
    libs = build.build_all()
    for name in libs:
        build.load(name)
    print(f"== phase 2: built {sorted(libs)} in "
          f"{time.perf_counter() - t0:.1f}s ==")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    stats: dict = {}
    phase_kernels(peaks, stats)
    phase_main(smi, stats)
    phase_paths(stats)
    kernels = []
    for policy, (kid, replaces) in KERNELS.items():
        s = stats[policy]
        kernels.append({
            "name": f"{kid} {policy}", "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": s["launches"],
            "path": s["path"], "max_abs_err": s["max_abs_err"],
            "dtype": "bfloat16", **s["bfloat16"],
            "float32": s["float32"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

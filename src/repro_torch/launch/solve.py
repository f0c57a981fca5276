"""Single-device Jacobi solve on the port: the paper's own workload.

Runs Laplace diffusion on a ringed grid under any engine policy and
reports wall time, GPt/s and the final residual. Runs on the card unless
``--device cpu`` is given; without a card it fails.

  PYTHONPATH=src python -m repro_torch.launch.solve --ny 1024 --nx 9216 \\
      --iters 1003 --dtype bfloat16 --check

``--kernel`` takes an engine policy name (default ``auto``) or one of
the paper's tags: ``v0|v1|v1db|v2`` are ``shifted|rowchunk|dbuf|temporal``
(``kernels.ops.VERSION_TO_POLICY``), and ``ref`` steps the plain oracle
through ``core.jacobi.jacobi_run``. ``--temporal`` is the fusion depth;
``--t`` overrides it.

``--serve`` routes the solve through
:class:`repro_torch.serve.SolveServer` as one request (admission,
bucketing, superblocks of batched launches, eviction on ``--tol``) and
prints its bucket, launches and realized iterations; ``--trace PATH``
writes the run's spans and counters as Chrome-trace JSON, which
``python -m repro_torch.obs summarize|validate PATH`` reads.

``--devices N`` decomposes the grid into a row mesh of ``N`` shards
(:class:`repro_torch.dist.ShardMesh`: on the card, shard ``i`` on
``cuda:{i % device_count()}``, so N cards take one shard each and one
card takes them all; ``--device cpu`` puts them on the CPU) and runs
``engine.run_distributed`` with ``--depth`` (or ``--t``) sweeps per
``t·r``-deep halo exchange and ``--overlap auto|on|off``; it prints the
schedule, the extended shard, the device of every shard and the modeled
exchange bill. With ``--trace`` the distributed run goes through its
span-per-phase executor, whose spans ``python -m repro_torch.obs
summarize PATH`` reconciles against the bill.

One process a shard: under ``torch.distributed.run`` (``WORLD_SIZE`` is
set) the solve runs one shard a rank over a
:class:`repro_torch.dist.ProcessMesh`, and ``--devices`` must equal
``WORLD_SIZE``::

  python -m torch.distributed.run --standalone --nproc-per-node 4 \
      -m repro_torch.launch.solve --devices 4 --ny 1024 --nx 9216 \
      --iters 1003 --depth 8 --check

``--dist-backend`` names the transport: ``nccl`` (the default on the
card: one rank a card) or ``gloo`` (the default with ``--device cpu``; on
the card the halos are staged through host memory, and ranks may share a
card). Rank 0 prints the results (and writes ``--trace PATH``; rank
``k`` writes ``PATH.rank<k>``); a rank that fails exits non-zero.

``--backend sim`` lowers the policy to a Tensix-style three-kernel
program and runs the functional simulator (:mod:`repro_torch.backends`)
on ``--device`` instead of the kernels, for the device model
``--device-model`` (default: the one detected), printing the program,
the modeled GPt/s, energy and per-kernel counters. ``--verify`` checks
the schedule (and, where the policy lowers, its Tensix program)
statically before the run and prints the report; a rejection exits 1.

``--check`` compares against the port's own ``reference`` policy (the
plain oracle) at the realized iteration count: max |err| < 1e-4 in f32,
5e-2 in bf16; a distributed solve must also equal the single-device
``engine.run`` under its resolved policy and ``t`` bit for bit. A bf16
solve may instead be within 5e-2 of the reference run in f32 from the
same start: the reference rounds to bf16 after every sweep and drifts
from the f32 solve over many sweeps, while the fused temporal policy
rounds once per block and stays near the f32 solve.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import os
import time

import torch

from repro_torch.core.jacobi import jacobi_run
from repro_torch.kernels.ops import VERSION_TO_POLICY
from repro_torch.obs.compare import reconcile
from repro_torch.obs.trace import Tracer, use_tracer

POLICIES = ["reference", "shifted", "rowchunk", "dbuf", "temporal", "auto",
            "tuned"]
#: The paper's kernel generations (``kernels.ops.VERSION_TO_POLICY``),
#: and ``ref``, the plain oracle stepped by ``core.jacobi.jacobi_run``.
LEGACY = ["ref", "v0", "v1", "v1db", "v2"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.solve")
    ap.add_argument("--ny", type=int, default=512)
    ap.add_argument("--nx", type=int, default=512)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--kernel", default="auto", choices=LEGACY + POLICIES,
                    help="engine policy name (legacy ref|v0|v1|v1db|v2 "
                         "tags still accepted)")
    ap.add_argument("--temporal", type=int, default=None,
                    help="temporal-policy fusion depth (default: the "
                         "engine's, 8)")
    ap.add_argument("--t", type=int, default=None,
                    help="sweeps per fused block / halo exchange; overrides "
                         "--temporal (single device) and --depth "
                         "(distributed)")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--tol", type=float, default=None,
                    help="stop at the first block of t sweeps whose "
                         "max-norm update delta is <= TOL "
                         "(engine.run_converged)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the grid lives; cuda launches the kernels")
    ap.add_argument("--backend", default="torch", choices=["torch", "sim"],
                    help="'torch' runs the engine (the CUDA kernels on the "
                         "card); 'sim' lowers the policy to a Tensix-style "
                         "three-kernel program and runs the functional "
                         "simulator (repro_torch.backends), reporting "
                         "modeled GPt/s and per-kernel counters for the "
                         "device model")
    ap.add_argument("--device-model", default=None,
                    help="device registry name the simulator plans for "
                         "(e.g. grayskull_e150; --backend sim only); "
                         "default: the detected one")
    ap.add_argument("--verify", action="store_true",
                    help="statically verify the chosen schedule (and, when "
                         "the policy lowers, the Tensix program) before "
                         "execution and print the diagnostic report")
    ap.add_argument("--check", action="store_true",
                    help="verify against the reference policy")
    ap.add_argument("--serve", action="store_true",
                    help="route the solve through SolveServer as one "
                         "request: admission, bucketing, superblocks of "
                         "batched launches, eviction on --tol")
    ap.add_argument("--devices", type=int, default=1,
                    help="shards in a row mesh (distributed solve when > "
                         "1): on the card shard i sits on cuda:{i % "
                         "device_count()}; under torch.distributed.run one "
                         "shard a rank, and it must equal WORLD_SIZE")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="the process group's backend under "
                         "torch.distributed.run (default: nccl on the card, "
                         "gloo with --device cpu); gloo on the card stages "
                         "the halos through host memory")
    ap.add_argument("--depth", type=int, default=1,
                    help="halo exchange depth in sweeps (distributed; --t "
                         "overrides it)")
    ap.add_argument("--overlap", default="auto", choices=["auto", "on", "off"],
                    help="hide each halo exchange behind the shards' "
                         "interior compute (distributed; bit-exact either "
                         "way); auto lets the schedule price it")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the run's spans and counters as Chrome-trace "
                         "JSON (inspect with 'python -m repro_torch.obs "
                         "summarize PATH')")
    args = ap.parse_args(argv)
    args.policy = VERSION_TO_POLICY.get(args.kernel, args.kernel)
    if args.policy == "ref":
        args.policy = "reference"
    args.fuse = args.t if args.t is not None else args.temporal
    rank = int(os.environ.get("RANK", 0))
    if rank:  # one process a shard: rank 0 prints; each rank traces
        if args.trace:
            args.trace = f"{args.trace}.rank{rank}"
        with contextlib.redirect_stdout(io.StringIO()):
            _main(args)
    else:
        _main(args)


def _main(args) -> None:
    if args.trace or args.serve:
        # --serve installs a tracer so the progress sink sees its
        # serve.block spans; the file is written on --trace.
        tracer = Tracer(sink=_serve_progress if args.serve else None)
        with use_tracer(tracer):
            _dispatch(args)
        if args.trace:
            tracer.write_trace(args.trace)
            print(f"trace: {len(tracer.events)} spans, "
                  f"{len(tracer.counters)} counter samples -> {args.trace}")
            print(tracer.describe())
            print(reconcile(tracer).describe())
    else:
        _dispatch(args)


def _serve_progress(ev) -> None:
    """Tracer sink: one line per completed ``serve.block`` span."""
    if ev.name != "serve.block":
        return
    a = ev.attrs
    mr = a.get("max_residual")
    print(f"[serve] launch={a.get('launch', '?')} "
          f"blocks={a.get('blocks', 1)}{' lone' if a.get('lone') else ''} "
          f"active={a.get('active')} queue={a.get('queue')} "
          f"max_residual={'?' if mr is None else format(mr, '.3e')} "
          f"wall={ev.dur_us / 1e3:.1f}ms")


def _dispatch(args) -> None:

    from repro_torch import engine
    from repro_torch.core.stencil import jacobi_2d_5pt, make_laplace_problem

    if "WORLD_SIZE" in os.environ:
        _ranks(args)
        return
    dtype = getattr(torch, args.dtype)
    u0 = make_laplace_problem(args.ny, args.nx, dtype=dtype, left=1.0,
                              right=0.0, device=args.device)
    dev = u0.device
    if dev.type == "cuda":
        print(f"card: {torch.cuda.get_device_name(dev)}")
    if args.device_model is not None and args.backend != "sim":
        raise SystemExit("--device-model plans the simulator; the engine "
                         "plans for the card it runs on (add --backend "
                         "sim)")
    if args.serve:
        if args.devices > 1 or args.backend != "torch":
            raise SystemExit("--serve drives the single-device engine; "
                             "drop --devices/--backend")
        if args.verify and args.policy != "reference":
            _verify(args, u0, args.policy)
        _serve(args, u0)
        return
    if args.backend == "sim":
        _simulate(args, u0)
        return
    if args.devices > 1:
        _distributed(args, u0)
        return
    if args.verify and args.policy != "reference":
        _verify(args, u0, args.policy)

    def solve():
        if args.tol is not None:
            return engine.run_converged(u0, tol=args.tol,
                                        max_iters=args.iters,
                                        policy=args.policy, t=args.fuse)
        if args.kernel == "ref":
            return jacobi_run(u0, args.iters), args.iters, None
        out = engine.run(u0, policy=args.policy, iters=args.iters,
                         t=args.fuse)
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
                                      policy=args.policy, t=args.fuse)
        print(f"schedule: {sched.describe()}")
    inner = out[1:-1, 1:-1].to(torch.float32)
    print(f"kernel={args.kernel} device={dev} grid={args.ny}x{args.nx} "
          f"dtype={args.dtype} iters={iters_done}/{args.iters}")
    gpts = args.ny * args.nx * max(iters_done, 1) / dt / 1e9
    print(f"wall={dt:.6f}s  GPt/s={gpts:.3f}  residual={res:.3e}  "
          f"mean={float(inner.mean()):.6f}  max={float(inner.max()):.6f}")

    if args.check:
        _check(args, u0, inner, iters_done)


def _verify(args, u0: torch.Tensor, policy: str,
            mesh_shape: tuple | None = None) -> None:
    """Static pre-flight: schedule feasibility + program protocol."""
    from repro_torch import engine
    from repro_torch.analysis import check_schedule
    from repro_torch.backends.lower import (LoweringError, lower,
                                            lowerable_policies)
    from repro_torch.core.stencil import jacobi_2d_5pt
    spec = jacobi_2d_5pt()
    device = args.device_model
    t = args.t if args.t is not None else (
        args.depth if mesh_shape is not None else args.temporal)
    sched = engine.build_schedule(
        args.iters, spec=spec, shape=u0.shape, dtype=u0.dtype,
        policy=policy, t=t, device=device, mesh_shape=mesh_shape,
        exchange_cadence=mesh_shape is not None,
        torch_device=u0.device.type)
    prog = None
    if sched.policy in lowerable_policies():
        try:
            prog = lower(u0.shape, u0.dtype, spec, sched.policy,
                         t=sched.t if sched.fused else None, device=device)
        except LoweringError as e:
            print(f"verify: lowering rejected — {e}")
            raise SystemExit(1)
    report = check_schedule(sched, shape=u0.shape, dtype=u0.dtype,
                            spec=spec, device=device,
                            mesh_shape=mesh_shape, program=prog)
    print(f"verify: {report.describe()}")
    if not report.ok:
        raise SystemExit(1)


def _simulate(args, u0: torch.Tensor) -> None:
    """Lower to the decoupled reader/compute/writer program and run the
    functional simulator on ``u0``'s device: numbers + modeled cost."""
    from repro_torch import backends, engine
    from repro_torch.backends.report import summarize
    if args.devices > 1:
        raise SystemExit("--backend sim models one chip's core grid; "
                         "drop --devices (cores are simulated inside)")
    policy = args.policy
    if policy == "reference":
        policy = "rowchunk"  # the oracle has no lowering; use §VI
    if args.verify:
        _verify(args, u0, policy)
    _sync(u0.device)
    t0 = time.perf_counter()
    res = backends.simulate(u0, policy=policy, iters=args.iters, t=args.fuse,
                            device=args.device_model)
    _sync(u0.device)
    dt = time.perf_counter() - t0
    s = summarize(res)
    inner = res.grid[1:-1, 1:-1].to(torch.float32)
    print(res.programs[0].describe())
    print(f"kernel={s['policy']} backend=sim device={s['device']} "
          f"grid={args.ny}x{args.nx} iters={args.iters} "
          f"cores={s['cores_used']}")
    print(f"sim_wall={dt:.3f}s  model={s['model_time_s']:.6f}s  "
          f"model_GPt/s={s['gpts']:.3f}  "
          f"model_energy_J={s['energy_j']:.3f} (MODELED)  "
          f"bytes/pt={s['bytes_per_point']:.2f}  "
          f"dram_txns={s['dram_txns']}")
    res_delta = float(engine.residual_for()(res.grid))
    print(f"residual={res_delta:.3e}  mean={float(inner.mean()):.6f}  "
          f"max={float(inner.max()):.6f}")
    if args.check:
        _check(args, u0, inner, args.iters)


def _serve(args, u0: torch.Tensor) -> None:
    """One request through the solve server; on the card it is timed on
    its second pass (the first builds the kernels)."""
    from repro_torch.serve import SolveRequest, SolveServer

    def serve():
        server = SolveServer(torch_device=u0.device)
        req = server.submit(SolveRequest(grid=u0, tol=args.tol,
                                         max_iters=args.iters,
                                         policy=args.policy, t=args.fuse))
        return server, req

    if u0.device.type == "cuda":
        serve()[0].drain()
    server, req = serve()
    print(f"bucket: {req.key.describe()}  "
          f"target_blocks={req.target_blocks}")
    _sync(u0.device)
    t0 = time.perf_counter()
    server.drain()
    dt = time.perf_counter() - t0
    stats = server.stats()
    inner = req.result[1:-1, 1:-1].to(torch.float32)
    gpts = args.ny * args.nx * req.iters_done / dt / 1e9
    print(f"kernel={args.kernel} serve=1 device={u0.device} "
          f"grid={args.ny}x{args.nx} iters={req.iters_done}/{args.iters} "
          f"(evicted_early={stats['evicted_early']} "
          f"launches={stats['launches']})")
    print(f"wall={dt:.6f}s  GPt/s={gpts:.3f}  residual={req.residual:.3e}  "
          f"mean={float(inner.mean()):.6f}  max={float(inner.max()):.6f}")
    if args.check:
        _check(args, u0, inner.to(u0.device), req.iters_done)


def _ranks(args) -> None:
    """One shard a rank under ``torch.distributed.run``: every rank makes
    the same grid on its device and runs the same distributed solve over a
    :class:`~repro_torch.dist.ProcessMesh`; rank 0 prints."""
    import torch.distributed as dist

    from repro_torch.core.stencil import make_laplace_problem
    from repro_torch.dist import ProcessMesh

    world = int(os.environ["WORLD_SIZE"])
    if args.devices != world:
        raise SystemExit(f"--devices {args.devices} != WORLD_SIZE {world}: "
                         f"under torch.distributed.run the solve runs one "
                         f"shard a rank")
    if args.serve or args.backend != "torch":
        raise SystemExit("one process a shard runs the distributed engine; "
                         "drop --serve/--backend")
    backend = args.dist_backend or (
        "nccl" if args.device == "cuda" else "gloo")
    owned = not dist.is_initialized()
    if owned:
        if backend == "nccl" and torch.cuda.device_count():
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                                  % torch.cuda.device_count())
        dist.init_process_group(backend)
    try:
        mesh = ProcessMesh((world,), ("x",),
                           device="cpu" if args.device == "cpu" else None)
        u0 = make_laplace_problem(args.ny, args.nx,
                                  dtype=getattr(torch, args.dtype), left=1.0,
                                  right=0.0, device=mesh.device_here)
        if u0.is_cuda:
            print(f"card: {torch.cuda.get_device_name(u0.device)}")
        _distributed(args, u0, mesh)
    finally:
        if owned:
            dist.destroy_process_group()


def _distributed(args, u0: torch.Tensor, mesh=None) -> None:
    """The solve over a row mesh of ``--devices`` shards: in this process
    (``mesh`` None: a :class:`~repro_torch.dist.ShardMesh` over the cards
    present, or the CPU) or one shard a rank (a ``ProcessMesh``)."""
    from repro_torch import engine
    from repro_torch.core.stencil import jacobi_2d_5pt
    from repro_torch.dist import ShardMesh

    if mesh is None:
        mesh = ShardMesh((args.devices,), ("x",),
                         ["cpu"] * args.devices if u0.device.type == "cpu"
                         else None)
    ranks = getattr(mesh, "backend", None)  # a ProcessMesh's transport
    t = args.t if args.t is not None else args.depth
    overlap = {"auto": None, "on": True, "off": False}[args.overlap]
    spec = jacobi_2d_5pt()
    if args.verify:
        _verify(args, u0, args.policy, mesh_shape=(args.devices,))
    sched, shard_shape, _ = engine.plan_distributed(
        u0.shape, u0.dtype, spec, mesh=mesh, policy=args.policy,
        iters=args.iters, t=t, overlap=overlap)
    where = (f"{args.devices} ranks over {ranks}" if ranks
             else "in one process")
    print(f"schedule: {sched.describe()}  shard={shard_shape} "
          f"mesh={args.devices}x1 {where} on "
          f"[{', '.join(map(str, mesh.devices))}]")
    bill = engine.price_exchange(sched, shard_shape=shard_shape,
                                 dtype=u0.dtype, spec=spec,
                                 mesh_shape=(args.devices,))
    print(f"exchange bill: {bill.describe()}")

    def solve():
        return engine.run_distributed(u0, spec, mesh=mesh, policy=args.policy,
                                      iters=args.iters, t=t, overlap=overlap)

    if u0.device.type == "cuda":
        with use_tracer(None):  # builds the kernels, warms the allocator
            solve()
    _sync(u0.device)
    t0 = time.perf_counter()
    out = solve()
    _sync(u0.device)  # the grid's card waits on every shard's copy
    dt = time.perf_counter() - t0
    inner = out[1:-1, 1:-1].to(torch.float32)
    res = float(engine.residual_for(spec)(out))
    print(f"kernel={args.kernel} devices={args.devices} device={u0.device} "
          f"grid={args.ny}x{args.nx} dtype={args.dtype} iters={args.iters}")
    gpts = args.ny * args.nx * args.iters / dt / 1e9
    print(f"wall={dt:.6f}s  GPt/s={gpts:.3f}  residual={res:.3e}  "
          f"mean={float(inner.mean()):.6f}  max={float(inner.max()):.6f}")
    if args.check and not (ranks and mesh.rank):  # one rank checks
        solo = engine.run(u0, spec, policy=sched.policy, iters=args.iters,
                          t=sched.t)
        if not torch.equal(out, solo):
            raise SystemExit(f"CHECK FAILED: the distributed solve != "
                             f"engine.run(policy={sched.policy!r}, "
                             f"t={sched.t})")
        print(f"distributed == engine.run(policy={sched.policy!r}, "
              f"t={sched.t}) bit for bit")
        _check(args, u0, inner, args.iters)


def _check(args, u0: torch.Tensor, inner: torch.Tensor,
           iters_done: int) -> None:
    """``inner`` (f32) against the reference policy at ``iters_done``
    sweeps, run in the grid's dtype and in f32; either may pass."""
    from repro_torch import engine
    limit = 1e-4 if u0.dtype == torch.float32 else 5e-2
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

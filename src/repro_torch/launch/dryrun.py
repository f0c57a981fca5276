"""The dry run: every (arch x shape x mesh) cell of the production meshes,
partitioned and counted on the ``meta`` device (twin of
``repro.launch.dryrun``).

The reference AOT-compiles each cell's jitted program with
``in_shardings`` from the rule tables against a mesh of 512 forced host
devices; XLA's SPMD partitioner inserts the collectives, and the
roofline reads each device's cost off the partitioned HLO. The port runs
each cell's program once on DTensors over the production mesh
(``launch.mesh.production_device_mesh``: 16 x 16 or 2 x 16 x 16
over PyTorch's ``fake`` process group, this process rank 0 of 256 or
512), its model built on ``meta`` (shapes, no storage) and laid out by
the same rules (``dist.sharding.distribute_model``, the state, cache and
batch by ``state_shardings``/``tree_shardings``/``batch_shardings``),
the layers' ``constrain`` sites active (``use_mesh``). DTensor
propagates the layouts op by op and issues the collectives; the cost
counter (``hlo_analysis``) sees rank 0's local ops and collectives, so
every term is per device as counted (``roofline.analyze``: the
collective term priced at ``ici_bw``, the cross-pod bytes at
``dci_bw``), and the memory is rank 0's: its arguments as laid out, its
outputs, and the peak of its live temporaries. A cell's program:

* ``train``: the train step with AdamW and ``warmup_cosine``,
  ``accum_steps`` microbatches, the optimizer included;
* ``prefill``: ``forward(last_only=True)``;
* ``decode``: one token against ``init_cache(global_batch, seq_len)``.

The fake mesh's device type is ``cuda`` in a PyTorch built for CUDA and
``cpu`` otherwise (``count_device_type``): DTensor re-lays a dimension
from one split to another with an all-to-all on a ``cuda`` mesh and with
an all-gather and a slice on a ``cpu`` one (gloo has no all-to-all), and
a ``cuda`` mesh's shape propagation needs a CUDA build; the record says
which (``mesh_device_type``).

Each record goes to ``<outdir>/<mesh>/<arch>.<shape>.json`` (resumable:
a cell on disk is skipped unless ``--force``) with the reference's fields
(``status``, ``reason`` for skips, ``accum_steps``, ``memory``,
``roofline``); the reference's ``lower_s``/``compile_s`` become
``count_s``, and ``cost`` holds the counter's own numbers, the
collectives by op and their count among them. A cell that DTensor
refuses is recorded as ``status: "error"`` with its message.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun            # everything
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh pod --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --backend sim --device cpu

``--device-model`` (default ``gpu_sm90``) picks the constants the
roofline prices a cell with; ``tpu_v5e`` sets the port's terms beside the
reference's. ``--backend sim`` runs the stencil cells through the
backends' lowering and simulator (on the card unless ``--device cpu``;
its device model defaults to the reference's ``tpu_v5e``).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch

from repro_torch import configs, roofline
from repro_torch.configs.shapes import (SHAPES, ShapeCell, cell_input_specs,
                                        cell_supported)
from repro_torch.dist import sharding as shd
from repro_torch.hlo_analysis import CostCounter
from repro_torch.launch import tuning
from repro_torch.launch.mesh import (make_production_mesh,
                                     production_device_mesh)
from repro_torch.models.registry import build_model, count_active_params

OUTDIR = os.path.join("experiments", "dryrun_torch")


def cell_inputs(cfg, cell: ShapeCell, device="meta",
                generator: torch.Generator | None = None) -> dict:
    """The cell's model inputs on ``device``: ``input_specs``' shapes and
    dtypes, integers widened to int64 (the port's models index with
    them), random values (tokens and labels in the vocab) off ``meta``."""
    out = {}
    for name, spec in cell_input_specs(cfg, cell).items():
        dtype = torch.int64 if not spec.dtype.is_floating_point \
            else spec.dtype
        if str(device) == "meta":
            out[name] = torch.empty(spec.shape, dtype=dtype, device="meta")
        elif dtype == torch.int64:
            out[name] = torch.randint(0, cfg.vocab_size, spec.shape,
                                      generator=generator, device=device)
        else:
            out[name] = torch.randn(spec.shape, generator=generator,
                                    device=device).to(dtype)
    return out


def cell_program(model, cell: ShapeCell, knobs, batch, cache=None):
    """``(run, arguments, their specs)`` for the cell: ``run()`` executes
    the cell's program once on ``model`` (see the module note); the
    arguments are what it reads and their logical axes mirror them. A
    decode cell runs against ``cache`` when given (else an empty one)."""
    from repro_torch.train.optimizer import adamw, warmup_cosine
    from repro_torch.train.trainstep import init_state, make_train_step
    axes = model.logical_axes()
    if cell.kind == "train":
        opt = adamw(warmup_cosine(3e-4, 2000, 100_000),
                    moments_dtype=tuning.torch_dtype(knobs.moments_dtype))
        step = make_train_step(model, opt, knobs.accum_steps,
                               accum_dtype=tuning.torch_dtype(
                                   knobs.accum_dtype))
        state = init_state(model, opt)
        return (lambda: step(state, batch)), {"state": state}, axes
    model.requires_grad_(False)
    params = dict(model.named_parameters())
    if cell.kind == "prefill":
        def run():
            with torch.no_grad():
                return model.forward(batch, last_only=True)[0]
        return run, {"params": params}, axes
    if cache is None:
        cache = model.init_cache(cell.global_batch, cell.seq_len)

    def run():
        with torch.no_grad():
            logits, new_cache, _ = model.forward(batch, cache)
            return logits, new_cache
    return run, {"params": params, "cache": cache}, axes


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)


def count_device_type() -> str:
    """The fake mesh's device type: ``cuda`` in a PyTorch built for CUDA
    (a card need not be visible), else ``cpu`` (see the module note)."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def _local_bytes(tree) -> dict:
    """``{id(storage): bytes}`` of the local block of every tensor in
    ``tree`` (a DTensor's on this rank)."""
    out = {}
    for t in _leaves(tree):
        st = getattr(t, "_local_tensor", t).untyped_storage()
        out[id(st)] = st.nbytes()
    return out


def count_cell(cfg, cell: ShapeCell, mesh, knobs,
               pod_size: int | None = None):
    """Build ``cfg``'s model on ``meta``, lay it and the cell's inputs out
    on the ``DeviceMesh`` ``mesh`` and run the cell's program once under
    the counter: ``(cost, memory)``, both of this rank (per device). With
    ``mesh=None``, one card's whole program (no collectives)."""
    model = build_model(cfg, device="meta")
    batch = cell_inputs(cfg, cell)
    cache = None
    if cell.kind == "decode":
        cache = model.init_cache(cell.global_batch, cell.seq_len)
    if mesh is not None:
        shd.distribute_model(model, mesh)
        batch = shd.distribute(batch, shd.batch_shardings(batch, mesh),
                               mesh)
        if cache is not None:
            cache = shd.distribute(cache, shd.tree_shardings(
                cache, model.cache_axes(), mesh), mesh)
    run, args, _ = cell_program(model, cell, knobs, batch, cache)
    per_dev = _local_bytes([args, batch])
    scope = shd.use_mesh(mesh) if mesh is not None else \
        contextlib.nullcontext()
    with scope, CostCounter(pod_size) as ctr:
        out = run()
    fresh = alias = 0
    for t in _leaves(out):
        st = getattr(t, "_local_tensor", t).untyped_storage()
        if id(st) in per_dev:
            alias += per_dev[id(st)]
        elif ctr.tracked(getattr(t, "_local_tensor", t)):
            fresh += st.nbytes()
    cost = ctr.cost
    mem = roofline.memory_per_device(
        sum(per_dev.values()), fresh + alias, alias,
        max(0, cost.peak_bytes - fresh))
    return cost, mem


def model_flops(cfg0, cell: ShapeCell) -> float:
    active = count_active_params(cfg0)
    if cell.kind == "train":
        return roofline.model_flops_train(active,
                                          cell.global_batch * cell.seq_len)
    if cell.kind == "prefill":
        return roofline.model_flops_infer(active,
                                          cell.global_batch * cell.seq_len)
    return roofline.model_flops_infer(active, cell.global_batch)


def run_cell(arch: str, shape: str, mesh_name: str,
             device_model: str = "gpu_sm90") -> dict:
    """One cell's record on the production mesh ``mesh_name``."""
    multi_pod = mesh_name == "multipod"
    shape_of = make_production_mesh(multi_pod=multi_pod)
    n_dev = len(shape_of.devices)
    cfg0 = configs.get_config(arch)
    rec: dict = {"arch": arch, "shape": shape, "mesh": mesh_name,
                 "n_devices": n_dev, "device_model": device_model}
    ok, why = cell_supported(cfg0, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    cell = SHAPES[shape]
    cfg, knobs = tuning.tuned(cfg0, shape, shape_of)
    pod_size = 256 if multi_pod else None
    t0 = time.time()
    with production_device_mesh(multi_pod=multi_pod,
                                device_type=count_device_type()) as mesh:
        cost, mem = count_cell(cfg, cell, mesh, knobs, pod_size)
    rl = roofline.analyze(cost, n_dev, model_flops(cfg0, cell),
                          pod_size=pod_size, hw=device_model)
    rec.update(status="ok", count_s=round(time.time() - t0, 1),
               mesh_device_type=count_device_type(),
               accum_steps=knobs.accum_steps, memory=mem,
               roofline=rl.as_dict(),
               cost={"ops": cost.ops, "kernels": cost.kernels,
                     "peak_bytes": cost.peak_bytes,
                     "collective_by_op": cost.collective_by_op,
                     "collective_count": cost.collective_count})
    return rec


def run_sim_cells(args) -> int:
    """``--backend sim``: dry-run the *stencil* cells through the backends
    lowering + functional simulator instead of counting model cells.

    One cell per registry policy on the jacobi2d smoke config: lower to
    the Tensix-style program, simulate a few sweeps, record the IR shape
    and the modeled roofline terms to ``<outdir>/sim/<policy>.json``.
    """
    from repro_torch import backends
    from repro_torch.backends.report import summarize
    from repro_torch.configs import jacobi2d
    from repro_torch.core.stencil import make_laplace_problem

    cfg = jacobi2d.smoke()
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    u = make_laplace_problem(cfg.ny, cfg.nx, dtype=dtype, left=1.0,
                             right=0.0, device=args.device)
    outdir = os.path.join(args.outdir, "sim")
    os.makedirs(outdir, exist_ok=True)
    failures = 0
    for policy in backends.lowerable_policies():
        path = os.path.join(outdir, f"{policy}.json")
        if os.path.exists(path) and not args.force:
            print(f"[cached ] sim      {policy}")
            continue
        t0 = time.time()
        try:
            res = backends.simulate(u, policy=policy, iters=cfg.iters,
                                    t=cfg.temporal,
                                    device=args.device_model)
            rec = {"backend": "sim", "policy": policy, "status": "ok",
                   "grid": [cfg.ny, cfg.nx], "iters": cfg.iters,
                   "sim_s": round(time.time() - t0, 2),
                   "program": res.programs[0].describe(),
                   "counters": res.counters.as_dict(),
                   "summary": summarize(res)}
            s = rec["summary"]
            extra = (f"model={s['model_time_s'] * 1e3:8.3f}ms "
                     f"gpts={s['gpts']:7.3f} "
                     f"bytes/pt={s['bytes_per_point']:6.2f} "
                     f"cores={s['cores_used']}")
        except Exception as e:  # a cell's failure is recorded, not fatal
            failures += 1
            rec = {"backend": "sim", "policy": policy, "status": "error",
                   "error": repr(e), "traceback": traceback.format_exc()}
            extra = rec["error"][:120]
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[{rec['status']:7s}] sim      {policy:12s} {extra}",
              flush=True)
    print(f"\ndone; {failures} failures")
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", action="append", default=None,
                    help="an arch (may repeat); default: every arch")
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None, choices=[None, "pod", "multipod"])
    ap.add_argument("--device-model", default=None,
                    help="device registry name whose roofline constants "
                         "price the cells (repro_torch.engine.device); "
                         "default gpu_sm90, and for --backend sim the "
                         "reference's tpu_v5e (the port's gpu_sm90 plan "
                         "tiles the temporal policy in 2-D blocks, which "
                         "a Tensix program does not take)")
    ap.add_argument("--backend", default="torch", choices=["torch", "sim"],
                    help="'torch' counts the model cells on meta; 'sim' "
                         "runs the stencil cells through the backends "
                         "lowering + functional simulator")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where --backend sim runs (model cells run on "
                         "meta)")
    ap.add_argument("--cell", action="append", default=None,
                    metavar="ARCH/SHAPE/MESH",
                    help="one cell (may repeat), in place of --arch, "
                         "--shape and --mesh")
    ap.add_argument("--outdir", default=OUTDIR)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    if args.backend == "sim":
        args.device_model = args.device_model or "tpu_v5e"
        return run_sim_cells(args)
    args.device_model = args.device_model or "gpu_sm90"

    archs = args.arch or sorted(configs.ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [args.mesh] if args.mesh else ["pod", "multipod"]
    cells = [(m, a, s) for m in meshes for a in archs for s in shapes]
    if args.cell:
        cells = [(m, a, s) for a, s, m in
                 (c.split("/") for c in args.cell)]

    failures = 0
    for mesh_name, arch, shape in cells:
        d = os.path.join(args.outdir, mesh_name)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{arch}.{shape}.json")
        if os.path.exists(path) and not args.force:
            print(f"[cached ] {mesh_name:8s} {arch:22s} {shape}")
            continue
        try:
            rec = run_cell(arch, shape, mesh_name,
                           device_model=args.device_model)
        except Exception as e:  # a cell's failure is recorded
            failures += 1
            rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                   "status": "error", "error": repr(e),
                   "traceback": traceback.format_exc()}
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        status = rec["status"]
        extra = ""
        if status == "ok":
            r = rec["roofline"]
            mb = rec["memory"]["total_nonalias"] / 2**30
            extra = (f"dom={r['dominant']:10s} "
                     f"bound={r['bound_s'] * 1e3:8.2f}ms "
                     f"coll={r['collective_s'] * 1e3:8.2f}ms "
                     f"mem={mb:6.2f}GiB count={rec['count_s']}s")
        elif status == "error":
            extra = rec["error"][:120]
        print(f"[{status:7s}] {mesh_name:8s} {arch:22s} "
              f"{shape:12s} {extra}", flush=True)
    print(f"\ndone; {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())

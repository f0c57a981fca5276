"""The dry run: every (arch x shape x mesh) cell of the production meshes,
counted on the ``meta`` device (twin of ``repro.launch.dryrun``).

The reference AOT-compiles each cell's jitted program against a mesh of
512 forced host devices and reads XLA's memory and cost analyses. The
port builds each cell's model on ``meta`` (shapes, no storage), runs the
cell's program once under the cost counter (``hlo_analysis``) and prices
it with the roofline (``roofline``), so it needs no card and no 512
devices (``XLA_FLAGS`` has no counterpart). A cell's program:

* ``train``: the train step with AdamW and ``warmup_cosine``,
  ``accum_steps`` microbatches, the optimizer included;
* ``prefill``: ``forward(last_only=True)``;
* ``decode``: one token against ``init_cache(global_batch, seq_len)``.

Each record goes to ``<outdir>/<mesh>/<arch>.<shape>.json`` (resumable:
a cell on disk is skipped unless ``--force``) with the reference's fields
(``status``, ``reason`` for skips, ``accum_steps``, ``memory``,
``roofline``); the reference's ``lower_s``/``compile_s`` become
``count_s``, and ``cost`` holds the counter's own numbers.

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
from repro_torch.launch.mesh import make_production_mesh
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


def argument_bytes(args: dict, axes: dict, model, batch, mesh) -> dict:
    """Bytes per device of every argument tensor, keyed by the id of its
    storage: the state by ``state_shardings``, the parameters and cache by
    ``tree_shardings``, the batch by ``batch_shardings``."""
    specs = {}
    if "state" in args:
        specs["state"] = shd.state_shardings(args["state"], axes, mesh)
    if "params" in args:
        specs["params"] = shd.tree_shardings(args["params"], axes, mesh)
    if "cache" in args:
        specs["cache"] = shd.tree_shardings(args["cache"],
                                            model.cache_axes(), mesh)
    out = {}
    trees = [(args[k], specs[k]) for k in specs]
    trees.append((batch, shd.batch_shardings(batch, mesh)))
    for tree, spec in trees:
        shd._map(lambda x, s: out.__setitem__(
            id(x.untyped_storage()),
            shd.shard_bytes(x.shape, x.element_size(), s, mesh))
            if isinstance(x, torch.Tensor) else None, tree, spec)
    return out


def count_cell(cfg, cell: ShapeCell, mesh, knobs):
    """Build ``cfg``'s model on ``meta`` and run the cell's program once
    under the counter: ``(cost, memory per device on mesh)``."""
    model = build_model(cfg, device="meta")
    batch = cell_inputs(cfg, cell)
    run, args, axes = cell_program(model, cell, knobs, batch)
    per_dev = argument_bytes(args, axes, model, batch, mesh)
    n_dev = len(mesh.devices)
    with CostCounter() as ctr:
        out = run()
    fresh = alias = 0
    for t in _leaves(out):
        key = id(t.untyped_storage())
        if key in per_dev:
            alias += per_dev[key]
        elif ctr.tracked(t):
            fresh += t.untyped_storage().nbytes()
    cost = ctr.cost
    mem = roofline.memory_per_device(
        sum(per_dev.values()), fresh // n_dev + alias, alias,
        max(0, cost.peak_bytes - fresh), n_dev)
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
    mesh = make_production_mesh(multi_pod=mesh_name == "multipod")
    n_dev = len(mesh.devices)
    cfg0 = configs.get_config(arch)
    rec: dict = {"arch": arch, "shape": shape, "mesh": mesh_name,
                 "n_devices": n_dev, "device_model": device_model}
    ok, why = cell_supported(cfg0, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    cell = SHAPES[shape]
    cfg, knobs = tuning.tuned(cfg0, shape, mesh)
    t0 = time.time()
    cost, mem = count_cell(cfg, cell, mesh, knobs)
    rl = roofline.analyze(cost, n_dev, model_flops(cfg0, cell),
                          hw=device_model)
    rec.update(status="ok", count_s=round(time.time() - t0, 1),
               accum_steps=knobs.accum_steps, memory=mem,
               roofline=rl.as_dict(),
               cost={"ops": cost.ops, "kernels": cost.kernels,
                     "peak_bytes": cost.peak_bytes})
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

    failures = 0
    for mesh_name in meshes:
        for arch in archs:
            for shape in shapes:
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
                             f"mem={mb:6.2f}GiB count={rec['count_s']}s")
                elif status == "error":
                    extra = rec["error"][:120]
                print(f"[{status:7s}] {mesh_name:8s} {arch:22s} "
                      f"{shape:12s} {extra}", flush=True)
    print(f"\ndone; {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The partitioned LM program run for real: one process a rank over
``torch.distributed``, the reference's ``jit`` with shardings on
DTensors.

Every rank builds the same model from one seed, lays it and its batch
out on a ``DeviceMesh`` over the real group by the rule tables
(``dist.sharding.distribute_model``/``batch_shardings``) and runs the
program under ``use_mesh``, the layers' ``constrain`` sites active; K8
runs through ``local_map`` (``kernels.ops.flash_attention``), once a
rank and layer. A program is ``prefill`` (``forward(last_only=True)``,
no grad) or ``train`` (one step: ``loss_and_grads`` over
``accum_steps`` microbatches, then AdamW's ``update_``). Its result
(the logits; or the metrics, the gradients and the updated parameters)
is gathered whole on every rank and held to the same program run
unpartitioned in one process, and each rank's collectives
(``CommDebugMode``'s counts by op, the cost counter's bytes by op) to
the same program counted on ``meta`` over a fake group of the same mesh
(:func:`fake_collectives`)::

  python -m torch.distributed.run --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.partition --device cpu

prints each program's bound and counts on rank 0 and ``PARTITION OK``
(the smoke qwen2.5-3b, ``(2, 2)`` over ``("data", "model")``;
``--arch``/``--layers``/``--batch``/``--seq``/``--full`` size the
model). On cards drop ``--device cpu``: NCCL, a card a rank (NCCL
refuses ranks that share a card; PyTorch 2.11's gloo ends a rank with
SIGSEGV in the functional all-gather DTensor issues on CUDA tensors).
The mesh's device type is the tensors' (``cpu`` or ``cuda``):
DTensor lowers a re-layout between two splits to an all-to-all on a
``cuda`` mesh and to an all-gather and a slice on a ``cpu`` one, and the
fake count uses the same type.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode

from repro_torch import configs
from repro_torch.dist import sharding as shd
from repro_torch.hlo_analysis import CostCounter
from repro_torch.launch.mesh import fake_device_mesh, make_device_mesh
from repro_torch.models.registry import build_model
from repro_torch.train.optimizer import adamw
from repro_torch.train.trainstep import init_state, loss_and_grads

MESH = ((2, 2), ("data", "model"))
KINDS = ("prefill", "train")
#: AdamW's rate, constant: the step moves each parameter by about 0.1,
#: far above f32's rounding of the parameters (1.2e-7 at 1.0), so a
#: step skipped or misapplied on a rank's block shows in :func:`check`
LR = 0.1


@dataclasses.dataclass(frozen=True)
class Program:
    """What every rank runs: ``kind`` on ``cfg`` at ``batch`` x ``seq``
    tokens (``accum_steps`` microbatches for train), the model drawn
    from ``seed``."""
    cfg: object
    kind: str
    batch: int
    seq: int
    accum_steps: int = 1
    seed: int = 0


def config(arch: str, *, layers: int | None = None, full: bool = False,
           **knobs):
    """``arch``'s smoke config (its full one with ``full``) in f32, cut
    to ``layers`` and with the execution ``knobs`` (``attn_impl``,
    ``attn_chunk``, ``remat``)."""
    cfg = configs.get_config(arch) if full else \
        configs.get_smoke_config(arch)
    upd = dict(dtype=torch.float32, param_dtype=torch.float32, **knobs)
    if layers is not None:
        upd["n_layers"] = layers
    return dataclasses.replace(cfg, **upd)


def inputs(prog: Program, device) -> dict:
    """The batch: tokens and labels drawn on the CPU from the seed."""
    g = torch.Generator().manual_seed(prog.seed + 1)
    shape = (prog.batch, prog.seq)
    out = {"tokens": torch.randint(0, prog.cfg.vocab_size, shape,
                                   generator=g)}
    if prog.kind == "train":
        out["labels"] = torch.randint(0, prog.cfg.vocab_size, shape,
                                      generator=g)
    return {k: v.to(device) for k, v in out.items()}


def _whole(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def run(prog: Program, device, mesh=None) -> dict:
    """``prog`` once on ``device``; partitioned on ``mesh`` when given
    (every rank of it calls this). Returns whole tensors: ``logits``;
    or ``ce``, ``grads.<name>`` and ``params.<name>``."""
    return {k: _whole(v) for k, v in _program(prog, device, mesh).items()}


def _program(prog: Program, device, mesh=None) -> dict:
    """:func:`run`'s tensors as the program leaves them (DTensors on
    ``mesh``)."""
    if str(device) == "meta":
        model = build_model(prog.cfg, device="meta")
    else:
        gen = torch.Generator(device).manual_seed(prog.seed)
        model = build_model(prog.cfg, device=device, generator=gen)
    batch = inputs(prog, "cpu" if str(device) == "meta" else device)
    if str(device) == "meta":
        batch = {k: torch.empty_like(v, device="meta")
                 for k, v in batch.items()}
    if mesh is not None:
        shd.distribute_model(model, mesh)
        batch = shd.distribute(batch, shd.batch_shardings(batch, mesh),
                               mesh)
    out = {}
    with shd.use_mesh(mesh) if mesh is not None else \
            contextlib.nullcontext():
        if prog.kind == "prefill":
            model.requires_grad_(False)
            with torch.no_grad():
                out["logits"] = model.forward(batch, last_only=True)[0]
        else:
            opt = adamw(LR)
            params, opt_state = init_state(model, opt)
            metrics, grads = loss_and_grads(model, params, batch,
                                            prog.accum_steps)
            out["ce"] = metrics["ce"]
            out.update({f"grads.{k}": g.detach().clone()
                        for k, g in grads.items()})
            opt.update_(grads, opt_state, params)
            out.update({f"params.{k}": p.detach()
                        for k, p in params.items()})
    return out


def step_from(prog: Program, device, grads: dict) -> tuple[dict, dict]:
    """The parameters before and after AdamW's step from ``grads`` (whole
    tensors by name), unpartitioned on ``device``: the optimizer alone,
    for :func:`check` to hold the partitioned step to on the same
    gradients."""
    gen = torch.Generator(device).manual_seed(prog.seed)
    model = build_model(prog.cfg, device=device, generator=gen)
    opt = adamw(LR)
    params, opt_state = init_state(model, opt)
    before = {k: p.detach().clone() for k, p in params.items()}
    opt.update_({k: g.clone() for k, g in grads.items()}, opt_state, params)
    return before, {k: p.detach() for k, p in params.items()}


class CommCounts(CommDebugMode):
    """``CommDebugMode``'s counts by op, without its module tracker:
    the tracker's forward hook pops a module it never pushed when a
    checkpointed layer replays in the backward (an ``IndexError``)."""

    def __enter__(self):
        out = super().__enter__()
        t = self.advanced_module_tracker
        for hook in (t._fw_pre_handle, t._fw_post_handle, t._bw_handle):
            hook.remove()
        return out


def _op_name(op) -> str:
    return str(op).split(".")[-1].rstrip("'>)")


def collectives(prog: Program, device, mesh) -> dict:
    """This rank's collectives of ``prog`` partitioned on ``mesh``: the
    counts by op of ``CommDebugMode`` and the bytes by op of the cost
    counter, each from a run of its own (the two modes are not
    nested)."""
    with CommCounts() as comm:
        _program(prog, device, mesh)
    with CostCounter() as ctr:
        _program(prog, device, mesh)
    return {"counts": {_op_name(k): int(v)
                       for k, v in comm.get_comm_counts().items()},
            "bytes": ctr.cost.collective_by_op,
            "count": ctr.cost.collective_count}


def fake_collectives(prog: Program, device_type: str,
                     mesh_shape=MESH) -> dict:
    """:func:`collectives` of ``prog`` on ``meta``, over a fake group of
    the mesh (rank 0's program; no process, no card)."""
    with fake_device_mesh(*mesh_shape, device_type) as mesh:
        return collectives(prog, "meta", mesh)


def rank_main(rank: int, outdir: str, progs: list, device_type: str,
              mesh_shape=MESH) -> None:
    """One rank (``dist.process.spawn``'s ``fn``): each of ``progs`` once
    partitioned (its result in ``<outdir>/<i>.npz`` from rank 0, K8's
    launches in its ``launches``) and once a mode for its collectives
    (``<outdir>/<i>.<rank>.json``)."""
    from repro_torch.kernels import flash_attention as k8
    device = torch.device(device_type)
    if device_type == "cuda":  # ranks may share a card (gloo)
        torch.cuda.set_device(rank % torch.cuda.device_count())
    mesh = make_device_mesh(*mesh_shape, device_type)
    for i, prog in enumerate(progs):
        k8.reset_launch_counts()
        out = run(prog, device, mesh)
        launches = k8.LAUNCHES["flash_attention"]
        rec = collectives(prog, device, mesh)
        rec["launches"] = launches
        with open(os.path.join(outdir, f"{i}.{rank}.json"), "w") as f:
            json.dump(rec, f)
        if rank == 0:
            np.savez(os.path.join(outdir, f"{i}.npz"),
                     **{k: v.float().cpu().numpy() for k, v in out.items()})


def check(progs: list, outdir: str, world: int, device,
          device_type: str, rtol: float) -> list[str]:
    """The lines of the comparison: each program's partitioned result
    against the unpartitioned run on ``device``, and every rank's
    collectives equal to the fake count. Raises on the first that does
    not hold. The bound is ``rtol`` of the largest magnitude: of the
    logits, of the loss and of each gradient. The updated parameters are
    held, leaf by leaf, to AdamW's step taken unpartitioned from the
    partitioned run's own gradients (:func:`step_from`), within ``rtol``
    of that leaf's largest change: the gradients are checked above, and
    from the same gradients the step is elementwise, so it must agree to
    rounding. (Held to the unpartitioned run's own step instead, a
    gradient that is zero up to rounding, as a key bias's, would move by
    a share of the rate that depends on its summation order:
    ``g / (|g| + eps)`` for ``|g|`` near ``eps``.)"""
    lines = []
    for i, prog in enumerate(progs):
        got = np.load(os.path.join(outdir, f"{i}.npz"))
        want = {k: v.float().cpu().numpy()
                for k, v in run(prog, device).items()}
        scale = {k: float(np.max(np.abs(w))) if w.size else 0.0
                 for k, w in want.items()}
        if prog.kind == "train":
            grads = {k[len("grads."):]: torch.from_numpy(got[k]).to(device)
                     for k in got.files if k.startswith("grads.")}
            before, after = step_from(prog, device, grads)
            for k, p in after.items():
                w, b = p.float().cpu().numpy(), before[k].float().cpu().numpy()
                want[f"params.{k}"] = w
                scale[f"params.{k}"] = (float(np.max(np.abs(w - b)))
                                        if w.size else 0.0)
        errs = {k: (float(np.max(np.abs(got[k] - w))) if w.size else 0.0)
                / max(scale[k], 1e-30) for k, w in want.items()}
        at = max(errs, key=errs.get)
        worst = errs[at]
        if not worst <= rtol:
            raise AssertionError(f"{prog.kind}: partitioned {at} off by "
                                 f"{worst:.3g} of its scale > {rtol}")
        fake = fake_collectives(prog, device_type)
        for r in range(world):
            with open(os.path.join(outdir, f"{i}.{r}.json")) as f:
                rec = json.load(f)
            for key in ("counts", "bytes", "count"):
                if rec[key] != fake[key]:
                    raise AssertionError(
                        f"{prog.kind} rank {r}: {key} {rec[key]} != fake "
                        f"{fake[key]}")
        launches = [json.load(open(os.path.join(outdir, f"{i}.{r}.json")))
                    ["launches"] for r in range(world)]
        lines.append(f"{prog.kind}: max err / max |y| = {worst:.3g} "
                     f"(bound {rtol}); collectives a rank {fake['counts']} "
                     f"= fake, bytes {fake['bytes']}; K8 launches a rank "
                     f"{launches}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.partition")
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--full", action="store_true",
                    help="the arch's full config, not its smoke one")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--kind", action="append", choices=KINDS, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="default: nccl on the card (a card a rank), gloo "
                         "with --device cpu")
    ap.add_argument("--outdir", default=os.path.join(
        "experiments", "partition"))
    args = ap.parse_args(argv)
    dist.init_process_group(args.backend or (
        "gloo" if args.device == "cpu" else "nccl"))
    rank, world = dist.get_rank(), dist.get_world_size()
    progs = [Program(config(args.arch, layers=args.layers, full=args.full),
                     kind, args.batch, args.seq,
                     accum_steps=2 if kind == "train" else 1)
             for kind in args.kind or KINDS]
    os.makedirs(args.outdir, exist_ok=True)
    try:
        rank_main(rank, args.outdir, progs, args.device)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        for line in check(progs, args.outdir, world, args.device,
                          args.device, 1e-5):
            print(line)
        print("PARTITION OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The sharded LM pieces one process a shard, as a launcher.

Under ``torch.distributed.run`` with four ranks, every rank runs each
sharded LM piece on its shard of small seeded inputs, over
:class:`~repro_torch.dist.ProcessMesh`\\ es ``(2, 2)`` (``data`` x
``model``) and ``(4,)``, and holds its result to the in-process piece
(a :class:`~repro_torch.dist.ShardMesh` of four shards on the rank's
device) bit for bit; rank 0 prints one line a piece and ``SHARDED OK``::

  python -m torch.distributed.run --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.sharded --backend gloo --device cpu

The pieces: K8 under ``use_mesh`` of the ``(2, 2)`` mesh (one launch a
rank on the card), K7 after the ``ppermute`` conv halo, the
sequence-parallel SSD, the 4-stage pipeline of a tanh MLP (forward and
each stage's gradients), ``compressed_psum`` int8 and bf16, and
``remesh_state`` from ``(2, 2)`` onto ``(2,)`` over ranks 0-1. Runs on
the card unless ``--device cpu`` is given. ``--backend`` names the
transport (default: ``nccl`` on the card, one rank a card; ``gloo``
with ``--device cpu``, or on the card with ranks sharing it). A rank
whose piece differs makes every rank exit non-zero.
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from repro_torch.core import ssm_sp
from repro_torch.core.stencil import require_device
from repro_torch.dist import ProcessMesh, ShardMesh
from repro_torch.dist import sharding as shd
from repro_torch.dist.pipeline import pipeline_forward, split_stages
from repro_torch.kernels import conv1d as k7
from repro_torch.kernels import flash_attention as k8
from repro_torch.kernels import ops
from repro_torch.train.compression import EFState, compressed_psum
from repro_torch.train.fault import remesh_state
from repro_torch.train.trainstep import TrainState

WORLD = 4
REMESH_SPECS = {"w": ("embed", "mlp"), "b": ("mlp",)}


def _draw(device) -> dict:
    """The pieces' inputs, drawn on the CPU from one seed and moved to
    ``device`` (every rank draws the same)."""
    g = torch.Generator().manual_seed(0)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(device)

    return {
        "qkv": [rand(4, 256, h, 64).bfloat16() for h in (8, 2, 2)],
        "conv": (rand(2, 256, 96), rand(4, 96, scale=0.5)),
        "ssd": (rand(2, 256, 1, 4, 8),
                torch.nn.functional.softplus(rand(2, 256, 1, 4)),
                -torch.exp(rand(1, 4, scale=0.3)),
                rand(2, 256, 1, 16, scale=0.3),
                rand(2, 256, 1, 16, scale=0.3)),
        "pipe": (rand(8, 32, 32, scale=32 ** -0.5), rand(6, 4, 32)),
        "psum": (rand(4, 16, 8), rand(4, 16, 8, scale=1e-3)),
        "state": (rand(8, 16), rand(16)),
    }


def _stage(p, h):
    for i in range(p["w"].shape[0]):
        h = torch.tanh(h @ p["w"][i])
    return h


def _blocks(state) -> list:
    """The blocks this process holds of each leaf, the step last."""
    return [list(state.params[n].shards) for n in sorted(state.params)] + [
        list(state.opt_state["step"].shards)]


def run_pieces(device) -> dict:
    """Every piece on this rank's shard against the in-process piece:
    piece name -> (equal bit for bit, K8/K7 launches on this rank)."""
    square = ProcessMesh((2, 2), ("data", "model"), device=device)
    row = ProcessMesh((4,), ("x",), device=device)
    small = ProcessMesh((2,), ("data",), ranks=[0, 1], device=device)
    dev, me = row.device_here, row.rank
    here = {"square": ShardMesh((2, 2), ("data", "model"), [dev] * WORLD),
            "row": ShardMesh((4,), ("x",), [dev] * WORLD),
            "small": ShardMesh((2,), ("data",), [dev] * 2)}
    x = _draw(dev)
    out = {}

    q, k, v = x["qkv"]
    k8.reset_launch_counts()
    with shd.use_mesh(square):
        got = ops.flash_attention(q, k, v)
    launches = k8.LAUNCHES["flash_attention"]
    with shd.use_mesh(here["square"]):
        out["K8 on (2, 2)"] = (torch.equal(got, ops.flash_attention(q, k, v)),
                               launches)

    xc, wc = x["conv"]
    k7.reset_launch_counts()
    ext = ssm_sp.conv_halo_exchange(shd.lay_out(xc, (None, "x"), row)
                                    .shards[0], 4, mesh=row, axis="x")
    got = k7.conv1d_depthwise_causal(ext, wc)[:, 3:]
    launches = k7.LAUNCHES["conv1d"]
    want = ssm_sp.conv_halo_exchange(
        shd.lay_out(xc, (None, "x"), here["row"]).shards, 4)[me]
    out["ppermute halo + K7 on (4,)"] = (torch.equal(
        got, k7.conv1d_depthwise_causal(want, wc)[:, 3:]), launches)

    xs, dt, a, bm, cm = x["ssd"]
    mine = [shd.lay_out(t, (None, "x"), row).shards[0]
            for t in (xs, dt, bm, cm)]
    got = ssm_sp.ssd_sequence_parallel(mine[0], mine[1], a, mine[2],
                                       mine[3], 32, mesh=row, axis="x")
    parts = [shd.lay_out(t, (None, "x"), here["row"]).shards
             for t in (xs, dt, bm, cm)]
    want = ssm_sp.ssd_sequence_parallel(*parts[:2], a, *parts[2:], 32)[me]
    out["sequence-parallel SSD on (4,)"] = (torch.equal(got, want), 0)

    w, h = x["pipe"]
    ws = split_stages({"w": w}, WORLD)["w"][me].clone().requires_grad_(True)
    y = pipeline_forward(_stage, row, axis="x")({"w": ws}, h)
    (g,) = torch.autograd.grad(torch.sum(y ** 2), [ws])
    w_all = w.clone().requires_grad_(True)
    y_all = pipeline_forward(_stage, here["row"], axis="x")(
        split_stages({"w": w_all}, WORLD), h)
    (g_all,) = torch.autograd.grad(torch.sum(y_all ** 2), [w_all])
    out["pipeline on (4,): forward"] = (torch.equal(y, y_all), 0)
    out["pipeline on (4,): this stage's gradients"] = (torch.equal(
        g, g_all.reshape(WORLD, -1, *g.shape[1:])[me]), 0)

    grads, res = x["psum"]
    for mode in ("int8", "bf16"):
        mean, ef = compressed_psum({"w": grads[me]}, EFState({"w": res[me]}),
                                   mode, mesh=row, axis="x")
        means, efs = compressed_psum(
            [{"w": t} for t in grads], [EFState({"w": t}) for t in res], mode)
        out[f"compressed_psum {mode} on (4,)"] = (
            torch.equal(mean["w"], means[me]["w"])
            and torch.equal(ef.residual["w"], efs[me].residual["w"]), 0)

    w, b = x["state"]
    state = TrainState({"w": w, "b": b},
                       {"step": torch.tensor(3, device=dev)})
    cur = remesh_state(state, square, REMESH_SPECS)
    new = remesh_state(cur, small, REMESH_SPECS)
    cur_all = remesh_state(state, here["square"], REMESH_SPECS)
    new_all = remesh_state(cur_all, here["small"], REMESH_SPECS)

    def same(mine, blocks, i):
        return all(torch.equal(m[0], bl[i]) for m, bl in zip(mine, blocks))

    held = _blocks(new)
    out["remesh_state (2, 2) -> (2,)"] = (
        same(_blocks(cur), _blocks(cur_all), me)
        and (same(held, _blocks(new_all), me) if me < 2
             else all(not h for h in held)), 0)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.sharded")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the card (default) or the CPU")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="the transport (default: nccl on the card, gloo "
                         "on the CPU)")
    args = ap.parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", 0))
    if world != WORLD:
        raise SystemExit(f"run under torch.distributed.run with "
                         f"--nproc-per-node {WORLD} (WORLD_SIZE {world})")
    require_device(args.device)
    backend = args.backend or ("nccl" if args.device == "cuda" else "gloo")
    owned = not dist.is_initialized()
    if owned:
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                                  % torch.cuda.device_count())
        dist.init_process_group(backend)
    try:
        out = run_pieces("cpu" if args.device == "cpu" else None)
        every = [None] * world
        dist.all_gather_object(every, out)
        bad = [(k, name) for k, res in enumerate(every)
               for name, (ok, _) in res.items() if not ok]
        if dist.get_rank() == 0:
            print(f"{world} ranks over {dist.get_backend()} on "
                  f"{args.device}")
            for name in out:
                launches = [res[name][1] for res in every]
                print(f"{name}: every rank bit for bit the in-process "
                      f"piece {[res[name][0] for res in every]}"
                      + (f", launches a rank {launches}"
                         if any(launches) else ""))
            print("SHARDED OK" if not bad else f"SHARDED FAILED: {bad}")
        if bad:
            raise SystemExit(1)
    finally:
        if owned:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()

"""The rank side of ``tests/test_torch_c2_process.py``: what each of four
gloo processes runs (started by ``repro_torch.dist.process.spawn``) on
the JAX script's seeded inputs. It imports only the port, so the ranks
start fast; the test compares what they save against the in-process
pieces and the JAX package.
"""
import contextlib
import io
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import ssm_sp
from repro_torch.dist import ProcessMesh, all_gather, ppermute, psum
from repro_torch.dist import sharding as shd
from repro_torch.dist.pipeline import pipeline_forward, split_stages
from repro_torch.kernels import ops
from repro_torch.kernels.conv1d import conv1d_depthwise_causal
from repro_torch.launch import sharded
from repro_torch.train.compression import EFState, compressed_psum
from repro_torch.train.fault import remesh_state
from repro_torch.train.trainstep import TrainState

RM_SPECS = {"w": ("embed", "mlp"), "b": ("mlp",)}
#: psum's operands by rank: in axis order ((1e8 + 1) - 1e8) + 1 is 1 in
#: f32; another order can give 0 or 2.
PSUM_VALUES = (1e8, 1.0, -1e8, 1.0)
#: ppermute's pairs: rank 3 receives nothing and gets zeros.
PERM = ((0, 1), (1, 2), (2, 0))


def stage_fn(p, h):
    """The reference test's stage: ``tanh(h @ w)`` a layer."""
    for i in range(p["w"].shape[0]):
        h = torch.tanh(h @ p["w"][i])
    return h


def module_stage_fn(layers, h):
    for layer in layers:
        h = torch.tanh(layer(h))
    return h


def linear_layers(n: int = 8, d: int = 32) -> list:
    """``n`` seeded ``Linear(d, d)`` layers: the pipeline's module form."""
    torch.manual_seed(7)
    return [torch.nn.Linear(d, d) for _ in range(n)]


def _pipeline(rank: int, t) -> dict:
    mesh = ProcessMesh((4,), ("stage",), device="cpu")
    x = t("pipe_x")
    ws = split_stages({"w": t("pipe_w")}, 4)["w"][rank].clone()
    ws.requires_grad_(True)
    pipe = pipeline_forward(stage_fn, mesh)
    y = pipe({"w": ws}, x)
    (g,) = torch.autograd.grad(torch.sum(y ** 2), [ws])
    with torch.no_grad():
        y_nograd = pipe({"w": ws}, x)
    layers = split_stages(linear_layers(), 4)[rank]
    ym = pipeline_forward(module_stage_fn, mesh)(layers, x)
    params = [p for layer in layers for p in layer.parameters()]
    gm = torch.autograd.grad(torch.sum(ym ** 2), params)
    return {"pipe_y": y.detach(), "pipe_g": g, "pipe_y_nograd": y_nograd,
            "pipe_mod_y": ym.detach(), "pipe_mod_g": list(gm)}


def _row(rank: int, t) -> dict:
    res = {}
    x_mesh = ProcessMesh((4,), ("x",), device="cpu")
    mine = torch.full((3,), float(rank + 1))
    res["ppermute"] = ppermute(mine, x_mesh, "x", PERM)
    res["all_gather"] = all_gather(mine, x_mesh, "x")
    res["psum"] = psum(torch.tensor(PSUM_VALUES[rank]), x_mesh, "x")
    res.update(_pipeline(rank, t))
    sp = ProcessMesh((4,), ("sp",), device="cpu")
    x, dt, b, c = (shd.lay_out(t(k), (None, "sp"), sp).shards[0]
                   for k in ("ssd_x", "ssd_dt", "ssd_b", "ssd_c"))
    res["ssd"] = ssm_sp.ssd_sequence_parallel(x, dt, t("ssd_a"), b, c, 32,
                                              mesh=sp, axis="sp")
    ext = ssm_sp.conv_halo_exchange(
        shd.lay_out(t("conv_x"), (None, "sp"), sp).shards[0], 4, mesh=sp,
        axis="sp")
    res["conv_ext"] = ext
    res["conv"] = conv1d_depthwise_causal(ext, t("conv_w"))[:, 3:]
    dp = ProcessMesh((4,), ("dp",), device="cpu")
    g, r = t("cp_g"), t("cp_r")
    for mode in ("int8", "bf16"):
        mean, ef = compressed_psum({"w": g[rank]}, EFState({"w": r[rank]}),
                                   mode, mesh=dp, axis="dp")
        res[f"cp_{mode}"] = (mean["w"], ef.residual["w"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        sharded.main(["--device", "cpu"])
    res["cli"] = buf.getvalue()
    return res


def _blocks(state) -> dict:
    return {name: (leaf.spec, list(leaf.shards))
            for name, leaf in [*state.params.items(),
                               ("step", state.opt_state["step"])]}


def _square(rank: int, t) -> dict:
    res = {}
    mesh = ProcessMesh((2, 2), ("data", "model"), device="cpu")
    res["coords"] = mesh.coords
    with shd.use_mesh(mesh):
        res["fa"] = ops.flash_attention(t("fa_q"), t("fa_k"), t("fa_v"),
                                        causal=True, bq=64, bk=64)
    state = TrainState({"w": t("rm_w"), "b": t("rm_b")},
                       {"step": torch.tensor(3)})
    cur = remesh_state(state, mesh, RM_SPECS)
    res["rm_22"] = _blocks(cur)
    small = ProcessMesh((2,), ("data",), ranks=[0, 1], device="cpu")
    new = remesh_state(cur, small, RM_SPECS)
    res["rm_2"] = _blocks(new)
    res["rm_2_rank"] = small.rank
    if small.rank is not None:
        res["rm_2_full"] = {k: v.full() for k, v in new.params.items()}
    else:
        try:
            all_gather(torch.zeros(1), small)
        except ValueError as e:
            res["outside"] = str(e)
    return res


def work(rank: int, out_dir: str, mesh_name: str, npz: str) -> None:
    """Run the pieces of ``mesh_name`` ("2x2": sharded K8 and the remesh;
    "4": the collectives, the pipeline, the sequence-parallel SSD and
    conv halo, the compressed sum, then ``launch.sharded``'s CLI) on
    this rank and save what came out."""
    arrays = np.load(npz)

    def t(key):
        return torch.from_numpy(np.ascontiguousarray(arrays[key]))

    res = _square(rank, t) if mesh_name == "2x2" else _row(rank, t)
    res["backend"] = dist.get_backend()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def fail_on_rank_one(rank: int) -> None:
    """Rank 1 raises while the others wait on it in a ``psum``."""
    mesh = ProcessMesh((2,), ("x",), device="cpu")
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    psum(torch.ones(1), mesh, "x")


def card_collectives(rank: int, out_dir: str) -> None:
    """On the card, gloo ranks sharing it: ``ppermute``, ``all_gather`` and
    ``psum`` of CUDA tensors staged through pinned host buffers, each
    result back on the card; saved on the CPU."""
    mesh = ProcessMesh((2,), ("x",))
    mine = torch.arange(4, dtype=torch.bfloat16, device=mesh.device_here)
    mine = mine + 10 * rank
    res = {"device": str(mesh.device_here),
           "ppermute": ppermute(mine, mesh, "x", [(0, 1)]),
           "all_gather": all_gather(mine, mesh, "x"),
           "psum": psum(mine.float(), mesh, "x")}
    res["on_card"] = all(v.is_cuda for v in [res["ppermute"], res["psum"],
                                             *res["all_gather"]])
    torch.save({k: v.cpu() if isinstance(v, torch.Tensor) else
                [p.cpu() for p in v] if isinstance(v, list) else v
                for k, v in res.items()},
               os.path.join(out_dir, f"rank{rank}.pt"))

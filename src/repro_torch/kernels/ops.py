"""Public wrappers over the port's kernels (twin of ``repro.kernels.ops``).

``jacobi_step(u, version=...)`` is the paper-facing entry point of the
stencil kernels: ``version`` selects the kernel generation (or the plain
reference), each an engine policy. :func:`conv1d` (K7) runs on one
device; :func:`flash_attention` (K8) too, unless a mesh is active
(``dist.sharding.use_mesh``): then it splits batch over data(/pod) and KV
heads over model and runs K8 on each shard, as the reference's
``shard_map`` branch does. Under a ``DeviceMesh`` (the partitioned
program on DTensors) that split is ``local_map``: the DTensors are laid
out by the reference's in/out specs and K8 runs once a rank on its
blocks, which the cost counter counts by K8's formula on the local
shapes.

K7 under a ``DeviceMesh``: the reference's ``conv1d`` has no
``shard_map``; its 8-device compile (mamba2-2.7b's smoke prefill on a
``(2, 4)`` mesh, the kernel in interpret mode) runs the kernel's loop on
each device's block, the batch split over data and the channels over
model as ``layers/ssm.py`` constrains its input (``("batch", None,
"ssm_inner")``), the sequence whole: its output there is
``bf16[2, 64, 40]`` of ``[4, 64, 160]``. The port lays ``x`` out so, the
weights and bias split by channel alike, and runs K7 (or, with
``use_kernel=False``, its plain version) once a rank on its blocks
through ``local_map``: a depthwise conv is channel by channel, so the
blocks' results are the whole one's.
"""
from __future__ import annotations

import functools

import torch

from repro_torch import engine
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.conv1d import (conv1d_depthwise_causal,
                                        conv1d_depthwise_causal_plain)
from repro_torch.kernels.flash_attention import flash_attention_local

VERSIONS = ("ref", "v0", "v1", "v1db", "v2")

# Historical version tags -> engine policy names (the engine registry is
# the source of truth; these aliases exist for paper-facing CLIs/tests).
VERSION_TO_POLICY = {
    "v0": "shifted",
    "v1": "rowchunk",
    "v1db": "dbuf",
    "v2": "temporal",
}


def jacobi_step(u: torch.Tensor, *, version: str = "v1",
                bm: int | None = None, t: int = 8) -> torch.Tensor:
    """One (or, for v2, ``t``) Jacobi sweep(s) with the selected kernel:
    v0 launches K4, v1 K2, v1db K3 and v2 K1 on a CUDA tensor.

    ``bm=None`` takes the planner's tile for the device. The reference's
    default of 256 rows is a TPU row block; on the card K1 cannot hold a
    256-row window at ``t = 8`` in shared memory.
    """
    if version == "ref":
        return _ref.jacobi_step(u)
    if version not in VERSION_TO_POLICY:
        raise ValueError(
            f"unknown jacobi kernel version {version!r}; one of {VERSIONS}")
    return engine.step(u, policy=VERSION_TO_POLICY[version], bm=bm, t=t)


def make_step_fn(version: str = "v1", **kw):
    """Partially-applied step function for the solver drivers."""
    return functools.partial(jacobi_step, version=version, **kw)


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           *, bl: int = 512, use_kernel: bool = True) -> torch.Tensor:
    """Depthwise causal conv1d: K7 on a CUDA tensor, or the plain version
    (``use_kernel=False``). x (B, L, D), w (K, D), b (D,) -> (B, L, D).
    Under a ``DeviceMesh``, on each rank's blocks (see the module note)."""
    from repro_torch.dist.sharding import (ACT_RULES, _device_mesh,
                                           placements, pspec_for)

    def fn(x_, w_, b_=None):
        if not use_kernel:
            return conv1d_depthwise_causal_plain(x_, w_, b_)
        return conv1d_depthwise_causal(x_, w_, b_, bl=bl)

    mesh = _device_mesh()
    if mesh is None:
        return fn(x, w, b)
    xspec = pspec_for(("batch", None, "ssm_inner"), x.shape, mesh,
                      ACT_RULES)
    args, specs = (x, w), [xspec, (None, xspec[2])]
    if b is not None:
        args, specs = args + (b,), specs + [(xspec[2],)]
    return _local_map(fn, mesh, args, specs, xspec, placements)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = 512,
                    bk: int = 512) -> torch.Tensor:
    """Fused attention forward, K8 on a CUDA tensor; sharded when a mesh
    is active: k/v by ``pspec_for(("batch", None, "kv_heads", None))``
    under ``ACT_RULES``, q's heads mirroring the KV heads' split (a q
    shard must own whole GQA groups), K8 on each shard's blocks on its
    device (``dist.sharding.shard_call``), the result put together.
    q (B,Sq,H,hd), k/v (B,Sk,K,hd) -> (B,Sq,H,hd)."""
    from repro_torch.dist.sharding import (ACT_RULES, _context_mesh,
                                           _device_mesh, placements,
                                           pspec_for, shard_call)

    def fn(a, b_, c):
        return flash_attention_local(a, b_, c, causal=causal, bq=bq, bk=bk)

    mesh = _context_mesh()
    if mesh is None:
        return fn(q, k, v)
    kvspec = pspec_for(("batch", None, "kv_heads", None), k.shape, mesh,
                       ACT_RULES)
    qspec = (kvspec[0], None, kvspec[2], None)
    if _device_mesh() is not None:
        return _local_map(fn, mesh, (q, k, v), (qspec, kvspec, kvspec),
                          qspec, placements)
    return shard_call(fn, mesh, (q, k, v), (qspec, kvspec, kvspec), qspec)


def _local_map(fn, mesh, args, in_specs, out_spec, placements):
    """``fn`` on each rank's blocks of the DTensors ``args`` laid out by
    ``in_specs``, its result a DTensor laid out by ``out_spec``."""
    from torch.distributed.tensor.experimental import local_map
    return local_map(fn, out_placements=(placements(out_spec, mesh),),
                     in_placements=tuple(placements(s, mesh)
                                         for s in in_specs),
                     device_mesh=mesh, redistribute_inputs=True)(*args)

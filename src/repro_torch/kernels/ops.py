"""Public wrappers over the port's kernels (twin of ``repro.kernels.ops``).

``jacobi_step(u, version=...)`` is the paper-facing entry point of the
stencil kernels: ``version`` selects the kernel generation (or the plain
reference), each an engine policy. :func:`conv1d` (K7) runs on one
device; :func:`flash_attention` (K8) too, unless a mesh is active
(``dist.sharding.use_mesh``): then it splits batch over data(/pod) and KV
heads over model and runs K8 on each shard, as the reference's
``shard_map`` branch does.
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
    (``use_kernel=False``). x (B, L, D), w (K, D), b (D,) -> (B, L, D)."""
    if not use_kernel:
        return conv1d_depthwise_causal_plain(x, w, b)
    return conv1d_depthwise_causal(x, w, b, bl=bl)


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
                                           pspec_for, shard_call)

    def fn(a, b_, c):
        return flash_attention_local(a, b_, c, causal=causal, bq=bq, bk=bk)

    mesh = _context_mesh()
    if mesh is None:
        return fn(q, k, v)
    kvspec = pspec_for(("batch", None, "kv_heads", None), k.shape, mesh,
                       ACT_RULES)
    qspec = (kvspec[0], None, kvspec[2], None)
    return shard_call(fn, mesh, (q, k, v), (qspec, kvspec, kvspec), qspec)

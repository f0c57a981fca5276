"""Mixture-of-Experts layer (Qwen3-MoE: 128 experts, top-8, SwiGLU experts).

Twin of ``repro.layers.moe``. GShard/GLaM-style capacity-based dispatch:
tokens are processed in groups of ``cfg.moe_group_size``; within a group
every token's top-k experts get a capacity slot (overflow drops,
underflow pads), earlier tokens first. Dispatch and combine are one-hot
products, the reference's einsums written as batched matmuls (one form
for plain tensors and DTensors); a gather/scatter dispatch is speed work
(ROADMAP Queue 2, P7). The reference's sharding constraints on the
expert inputs and outputs stand at its sites (``dist.sharding.
constrain``: under a ``DeviceMesh``, the expert-parallel re-layout).

Ties: the router's top-k keeps the lower expert id first among equal
probabilities, as ``jax.lax.top_k`` does; ``torch.topk`` does not
promise that order, so the port takes the first k of a stable
descending sort.

Aux losses: switch load-balance (``moe_lb_loss``) and router z-loss
(``moe_z_loss``), and the share of (token, choice) pairs that lost their
slot (``moe_drop_frac``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import constrain, on_mesh, view
from repro_torch.models.base import ModelConfig, ParamInit, Params


class MoE(Params):
    """The router (d, E) and the experts' SwiGLU slabs stacked on E."""

    AXES = {"router": ("embed", None), "gate": ("expert", "embed", "mlp"),
            "up": ("expert", "embed", "mlp"),
            "down": ("expert", "mlp", "embed")}

    def __init__(self, init: ParamInit, cfg: ModelConfig):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = init.normal((d, e), scale=0.02)
        self.gate = init.normal((e, d, f))
        self.up = init.normal((e, d, f))
        self.down = init.normal((e, f, d))

    def forward(self, x: torch.Tensor, cfg: ModelConfig):
        return moe_ffn(self, x, cfg)


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest along the last axis and their ids, lower ids
    first among ties (``jax.lax.top_k``'s order)."""
    # the values gathered, not sort's: sort's backward scatters into a
    # plain tensor (PyTorch 2.11), which DTensor refuses
    ids = torch.sort(probs, dim=-1, descending=True, stable=True)[1][..., :k]
    return torch.gather(probs, -1, ids), ids


def capacity(gs: int, cfg: ModelConfig) -> int:
    """Slots an expert has in a group of ``gs`` tokens (the reference's
    Python float arithmetic)."""
    return max(1, int(gs * cfg.experts_per_token / cfg.n_experts
                      * cfg.moe_capacity_factor))


def _one_hot(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(ids, n)`` as a comparison with the ids (PyTorch 2.11's
    ``one_hot`` of a DTensor scatters into a plain tensor)."""
    return (ids[..., None] == on_mesh(torch.arange(n, device=ids.device))
            ).to(torch.int64)


def _dispatch(disp: torch.Tensor, xg: torch.Tensor) -> torch.Tensor:
    """``einsum("gtec,gtd->gecd")`` as one batched product over the
    groups, ``(g, ec, t) @ (g, t, d)``: ``einsum`` flattens its operands'
    dims together, which DTensor (PyTorch 2.11) refuses where a
    flattened dim is split."""
    e, c = disp.shape[2:]
    return (disp.flatten(2).transpose(1, 2) @ xg).unflatten(1, (e, c))


def _combine(combine: torch.Tensor, eout: torch.Tensor) -> torch.Tensor:
    """``einsum("gtec,gecd->gtd")`` as one batched product, ``(g, t, ec)
    @ (g, ec, d)``, for :func:`_dispatch`'s reason."""
    return combine.flatten(2) @ eout.flatten(1, 2)


def moe_ffn(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, S, D) -> (out (B, S, D), aux dict with load-balance metrics)."""
    dt, f32 = cfg.dtype, torch.float32
    bsz, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    gs = min(cfg.moe_group_size, bsz * s)
    t = bsz * s
    if t % gs:
        raise ValueError(f"MoE groups of {gs} tokens must divide the "
                         f"{t} tokens (B {bsz} x S {s})")
    g = t // gs
    xg = view(x, (g, gs, d), ("batch", None, None))  # groups follow batch

    # Router (f32 for stable softmax).
    # Under a mesh the router's products split the experts over the
    # model axis, as XLA's partitioner does (the weight is replicated).
    router = constrain(p.w("router", f32), (None, "expert"))
    logits = torch.einsum("gsd,de->gse", xg.to(f32), router)
    logits = constrain(logits, ("batch", None, "expert"))
    probs = torch.softmax(logits, dim=-1)
    gate_vals, ids = top_k(probs, k)                       # (g, gs, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)          # renormalize top-k

    cap = capacity(gs, cfg)

    # Slot assignment: earlier tokens win capacity (switch-style priority).
    mask = _one_hot(ids, e)                                # (g, gs, k, e)
    mflat = mask.reshape(g, gs * k, e)
    pos = (torch.cumsum(mflat, dim=1) - 1).reshape(g, gs, k, e)
    keep = (pos < cap) & (mask > 0)                        # (g, gs, k, e)
    # Per-(token, k) slot one-hot, then fold k away: a token occupies at
    # most one slot per expert, so dispatch is (g, gs, e, cap).
    slots = keep[..., None] & (pos[..., None] ==
                               on_mesh(torch.arange(cap, device=x.device)))
    disp = slots.any(dim=2)                                # (g, gs, e, cap)
    combine = (gate_vals[..., None, None] *
               slots.to(f32)).sum(dim=2)                   # (g, gs, e, cap)
    # Under a mesh, the slot one-hots take the experts' split, so the
    # dispatch and combine products contract no split dimension.
    disp = constrain(disp, ("batch", None, "expert", None))
    combine = constrain(combine, ("batch", None, "expert", None))

    expert_in = _dispatch(disp.to(dt), xg.to(dt))
    # EP boundary: groups follow the batch axis, experts the model axis
    # (under a mesh, the dispatch's re-layout is issued here).
    expert_in = constrain(expert_in, ("batch", "expert", None, None))
    # Expert SwiGLU (E stacked weight slabs).
    gproj = torch.einsum("gecd,edf->gecf", expert_in, p.w("gate", dt))
    uproj = torch.einsum("gecd,edf->gecf", expert_in, p.w("up", dt))
    h = F.silu(gproj.to(f32)).to(dt) * uproj
    eout = torch.einsum("gecf,efd->gecd", h, p.w("down", dt))
    eout = constrain(eout, ("batch", "expert", None, None))

    out = _combine(combine.to(dt), eout)
    out = view(out, (bsz, s, d), ("batch", None, None))

    # Aux losses (Switch Transformer §2.2 + z-loss).
    frac_tokens = mask.sum(dim=(1, 2)).to(f32) / (gs * k)  # (g, e)
    frac_probs = probs.mean(dim=1)                          # (g, e)
    lb_loss = e * torch.mean(torch.sum(frac_tokens * frac_probs, dim=-1))
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    dropped = 1.0 - keep.sum() / torch.clamp(mflat.sum(), min=1)
    aux = {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss,
           "moe_drop_frac": dropped.to(f32)}
    return out.to(dt), aux

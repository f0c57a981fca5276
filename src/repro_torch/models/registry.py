"""Model factory + parameter accounting (twin of ``repro.models.registry``).

The port builds every family of the reference: dense (GQA and MLA), MoE,
the VLM backbone, SSM, hybrid and the encoder. :func:`count_params`
counts any config from its parameter shapes (a model made on the
``meta`` device holds shapes and no storage).
"""
from __future__ import annotations

import torch

from repro_torch.models.base import ModelConfig


def build_model(cfg: ModelConfig, *, device="cuda",
                generator: torch.Generator | None = None):
    """The model for ``cfg``'s family, its parameters made on ``device``
    from ``generator``; they require grad (serving turns that off with
    ``requires_grad_(False)``)."""
    kw = dict(device=device, generator=generator)
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models.lm import DecoderLM
        return DecoderLM(cfg, **kw)
    if cfg.family == "ssm":
        from repro_torch.models.ssm_lm import MambaLM
        return MambaLM(cfg, **kw)
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import HybridLM
        return HybridLM(cfg, **kw)
    if cfg.family == "encoder":
        from repro_torch.models.encoder import EncoderModel
        return EncoderModel(cfg, **kw)
    raise ValueError(f"unknown family {cfg.family!r}")


def count_params(cfg: ModelConfig) -> int:
    """Exact parameter count from the parameter shapes (no allocation)."""
    model = build_model(cfg, device="meta")
    return sum(p.numel() for p in model.parameters())



def count_active_params(cfg: ModelConfig) -> int:
    """Active (per-token) parameters: differs from the total only for MoE,
    whose tokens each run ``experts_per_token`` of ``n_experts`` SwiGLU
    slabs (the reference's count)."""
    total = count_params(cfg)
    if not cfg.n_experts:
        return total
    per_layer_expert = 3 * cfg.d_model * cfg.d_ff  # swiglu slab per expert
    inactive = (cfg.n_experts - cfg.experts_per_token) * per_layer_expert \
        * cfg.n_layers
    return total - inactive

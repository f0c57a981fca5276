"""Model factory + parameter accounting (twin of ``repro.models.registry``).

The port builds the dense (GQA and MLA), VLM-backbone, SSM and hybrid
families; :func:`count_params` counts any config the port builds, from its
parameter shapes (a model made on the ``meta`` device holds shapes and no
storage).
"""
from __future__ import annotations

import torch

from repro_torch.models.base import ModelConfig


def build_model(cfg: ModelConfig, *, device="cuda",
                generator: torch.Generator | None = None):
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models.lm import DecoderLM
        return DecoderLM(cfg, device=device, generator=generator)
    if cfg.family == "ssm":
        from repro_torch.models.ssm_lm import MambaLM
        return MambaLM(cfg, device=device, generator=generator)
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import HybridLM
        return HybridLM(cfg, device=device, generator=generator)
    if cfg.family == "encoder":
        raise NotImplementedError("family 'encoder' is not ported yet "
                                  "(ROADMAP Queue 1, D3)")
    raise ValueError(f"unknown family {cfg.family!r}")


def count_params(cfg: ModelConfig) -> int:
    """Exact parameter count from the parameter shapes (no allocation)."""
    model = build_model(cfg, device="meta")
    return sum(p.numel() for p in model.parameters())

"""Model factory + parameter accounting (twin of ``repro.models.registry``).

The port builds the dense and SSM families; :func:`count_params` counts
any config the port builds, from its parameter shapes (a model made on the
``meta`` device holds shapes and no storage).
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
    if cfg.family in ("hybrid", "encoder"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  f"(ROADMAP Queue 1)")
    raise ValueError(f"unknown family {cfg.family!r}")


def count_params(cfg: ModelConfig) -> int:
    """Exact parameter count from the parameter shapes (no allocation)."""
    model = build_model(cfg, device="meta")
    return sum(p.numel() for p in model.parameters())

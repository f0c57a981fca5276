"""Mamba2 language model, attention-free: SSD blocks only (twin of
``repro.models.ssm_lm``).

One layer = pre-norm Mamba2 block with a residual. The reference stacks
layer parameters and runs ``lax.scan``; the port keeps one module per
layer (``layers.<i>``) and loops over them. The cache (SSD state and conv
tail) stays stacked over layers, as the reference's is, and is written in
place, which stands in for the reference's buffer donation. Training:
:meth:`MambaLM.loss` is the reference's chunked CE; with grad enabled each
layer is checkpointed per ``cfg.remat`` (``models.lm.remat``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.layers import basic
from repro_torch.layers.ssm import SSM, SSMCache, init_ssm_cache, ssm_block
from repro_torch.models.base import (ModelConfig, ParamInit, logical_axes,
                                     with_config)
from repro_torch.models.lm import ce_from_hidden, detached, remat


class MambaLayer(nn.Module):
    def __init__(self, init: ParamInit, cfg: ModelConfig):
        super().__init__()
        self.ln = basic.RMSNorm(init, cfg.d_model)
        self.ssm = SSM(init, cfg)

    def forward(self, x, cfg: ModelConfig, cache: Optional[SSMCache] = None):
        h, new_cache = ssm_block(self.ssm,
                                 basic.rms_norm(self.ln, x, cfg.norm_eps),
                                 cfg, cache)
        return x + h, new_cache


class MambaLM(nn.Module):
    """mamba2 on PyTorch.

    Parameters are made on ``device`` (the card unless the caller asks
    for the CPU) from ``generator`` by the reference's init rule; they
    require grad (serving turns that off with ``requires_grad_(False)``).
    """

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        init = ParamInit(cfg, device=device, generator=generator)
        self.embedding = basic.Embedding(init, cfg)
        self.ln_f = basic.RMSNorm(init, cfg.d_model)
        self.layers = nn.ModuleList(MambaLayer(init, cfg)
                                    for _ in range(cfg.n_layers))

    logical_axes = logical_axes

    @property
    def device(self) -> torch.device:
        return self.embedding.table.device

    def with_config(self, cfg: ModelConfig) -> "MambaLM":
        """The same parameters run under other execution knobs
        (``ssm_conv_impl``, ``dtype``)."""
        return with_config(self, cfg, (
            "n_layers", "d_model", "vocab_size", "tie_embeddings",
            "ssm_state", "ssm_conv", "ssm_expand", "ssm_head_dim",
            "ssm_groups"))

    def forward_hidden(self, batch: Dict[str, torch.Tensor],
                       cache: Optional[SSMCache] = None):
        """Returns (final normed hidden (B, S, D), cache, aux); a given
        cache is updated in place and returned."""
        cfg = self.cfg
        x = basic.embed(self.embedding, batch["tokens"], cfg)
        for i, layer in enumerate(self.layers):
            if cache is None:
                x, _ = remat(layer, cfg.remat)(x, cfg)
                continue
            x, new = layer(x, cfg, SSMCache(cache.state[i], cache.conv[i]))
            cache.state[i].copy_(new.state)
            cache.conv[i].copy_(new.conv)
        x = basic.rms_norm(self.ln_f, x, cfg.norm_eps)
        return x, cache, {}

    def forward(self, batch: Dict[str, torch.Tensor],
                cache: Optional[SSMCache] = None, last_only: bool = False):
        """Returns (logits, cache, aux). ``last_only`` unembeds only the
        final position (prefill serving)."""
        x, cache, aux = self.forward_hidden(batch, cache)
        if last_only:
            x = x[:, -1:]
        return basic.unembed(self.embedding, x, self.cfg), cache, aux

    def loss(self, batch: Dict[str, torch.Tensor]):
        """Returns (ce, {"ce": ce}): the reference's chunked next-token CE."""
        cfg = self.cfg
        x, _, _ = self.forward_hidden(batch)
        ce = ce_from_hidden(x, basic.head_weight(self.embedding, cfg),
                            batch["labels"], cfg.padded_vocab, cfg.vocab_size)
        return ce, detached({"ce": ce})

    def init_cache(self, batch: int, max_len: int = 0) -> SSMCache:
        """An empty cache stacked over layers: state (L, B, G, M, P, N) f32,
        conv (L, B, K-1, conv_dim). Its size does not grow with
        ``max_len``."""
        return init_ssm_cache(self.cfg, batch, layers=self.cfg.n_layers,
                              device=self.device)

    def cache_axes(self) -> SSMCache:
        """The cache's logical axes, the reference's."""
        return SSMCache(state=("layers", "batch", None, "heads", None, None),
                        conv=("layers", "batch", None, "ssm_inner"))

"""Decoder-only transformer LM, dense family (twin of ``repro.models.lm``).

One layer = pre-norm GQA attention + pre-norm SwiGLU. The reference
stacks layer parameters and runs ``lax.scan``; the port keeps one module
per layer (``layers.<i>``) and loops over them. The KV cache stays
stacked over layers, as the reference's is.

MLA (minicpm3), MoE (qwen3-moe) and the VLM backbone (internvl2) raise
``NotImplementedError``: they are later slices (ROADMAP Queue 1).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from repro_torch.layers import basic
from repro_torch.layers.attention import GQA, KVCache, attention, init_kv_cache
from repro_torch.models.base import ModelConfig, ParamInit, with_config


class DecoderLayer(nn.Module):
    def __init__(self, init: ParamInit, cfg: ModelConfig):
        super().__init__()
        self.ln1 = basic.RMSNorm(init, cfg.d_model)
        self.attn = GQA(init, cfg)
        self.ln2 = basic.RMSNorm(init, cfg.d_model)
        self.ffn = basic.SwiGLU(init, cfg.d_model, cfg.d_ff)

    def forward(self, x, positions, cfg: ModelConfig,
                cache: Optional[KVCache] = None):
        h, new_cache = attention(self.attn,
                                 basic.rms_norm(self.ln1, x, cfg.norm_eps),
                                 positions, cfg, cache)
        x = x + h
        y = basic.rms_norm(self.ln2, x, cfg.norm_eps)
        return x + basic.swiglu(self.ffn, y, cfg), new_cache


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.attn_type == "mla":
        raise NotImplementedError("MLA attention (minicpm3) is not ported "
                                  "yet (ROADMAP Queue 1, MLA/MoE/VLM)")
    if cfg.n_experts:
        raise NotImplementedError("MoE FFNs (qwen3-moe) are not ported yet "
                                  "(ROADMAP Queue 1, MLA/MoE/VLM)")
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  f"(ROADMAP Queue 1); the port runs dense")


class DecoderLM(nn.Module):
    """Dense llama-likes and qwen2.5 on PyTorch.

    Parameters are made on ``device`` (the card unless the caller asks
    for the CPU) from ``generator`` by the reference's init rule.
    """

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        init = ParamInit(cfg, device=device, generator=generator)
        self.embedding = basic.Embedding(init, cfg)
        self.ln_f = basic.RMSNorm(init, cfg.d_model)
        self.layers = nn.ModuleList(DecoderLayer(init, cfg)
                                    for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embedding.table.device

    def with_config(self, cfg: ModelConfig) -> "DecoderLM":
        """The same parameters run under other execution knobs
        (``attn_impl``, ``attn_chunk``, ``dtype``)."""
        return with_config(self, cfg, (
            "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
            "vocab_size", "head_dim", "qkv_bias", "tie_embeddings"))

    # ---------------------------- forward ----------------------------

    def forward_hidden(self, batch: Dict[str, torch.Tensor],
                       cache: Optional[KVCache] = None):
        """Returns (final normed hidden (B, S, D), new_cache, aux)."""
        cfg = self.cfg
        x = basic.embed(self.embedding, batch["tokens"], cfg)
        bsz, s, _ = x.shape
        start = 0 if cache is None else cache_length(cache)
        positions = (start + torch.arange(s, device=x.device)).expand(bsz, s)
        for i, layer in enumerate(self.layers):
            lcache = None if cache is None else KVCache(
                cache.k[i], cache.v[i], cache.length)
            x, _ = layer(x, positions, cfg, lcache)
        x = basic.rms_norm(self.ln_f, x, cfg.norm_eps)
        new_cache = None if cache is None else KVCache(
            cache.k, cache.v, cache.length + s)
        return x, new_cache, {}

    def forward(self, batch: Dict[str, torch.Tensor],
                cache: Optional[KVCache] = None, last_only: bool = False):
        """Returns (logits, new_cache, aux). ``last_only`` unembeds only the
        final position (prefill serving — avoids a (B,S,V) tensor)."""
        x, new_cache, aux = self.forward_hidden(batch, cache)
        if last_only:
            x = x[:, -1:]
        return basic.unembed(self.embedding, x, self.cfg), new_cache, aux

    # --------------------------- serving ---------------------------

    def init_cache(self, batch: int, max_len: int) -> KVCache:
        """An empty KV cache stacked over layers: (L, B, max_len, K, hd)."""
        return init_kv_cache(self.cfg, batch, max_len,
                             layers=self.cfg.n_layers, device=self.device)


def cache_length(cache: Any) -> int:
    """All layers share the same length."""
    return int(cache.length)

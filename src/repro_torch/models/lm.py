"""Decoder-only transformer LM: dense, MLA and the VLM backbone (twin of
``repro.models.lm``).

One layer = pre-norm attention (GQA, or MLA for minicpm3) + pre-norm
SwiGLU. The reference stacks layer parameters and runs ``lax.scan``; the
port keeps one module per layer (``layers.<i>``) and loops over them. The
cache (a KV cache, or MLA's latent cache) stays stacked over layers, as
the reference's is. The VLM family (internvl2) is the text backbone plus
``vision_proj``, which projects precomputed patch embeddings
(``batch["image_embeds"]``) ahead of the text tokens.

MoE FFNs (qwen3-moe) raise ``NotImplementedError``: a later slice
(ROADMAP Queue 1, D3).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from repro_torch.layers import basic
from repro_torch.layers.attention import GQA, KVCache, attention, init_kv_cache
from repro_torch.layers.mla import MLA, MLACache, init_mla_cache, mla_attention
from repro_torch.models.base import ModelConfig, ParamInit, with_config

Cache = KVCache | MLACache


class DecoderLayer(nn.Module):
    def __init__(self, init: ParamInit, cfg: ModelConfig):
        super().__init__()
        self.ln1 = basic.RMSNorm(init, cfg.d_model)
        self.attn = (MLA if cfg.attn_type == "mla" else GQA)(init, cfg)
        self.ln2 = basic.RMSNorm(init, cfg.d_model)
        self.ffn = basic.SwiGLU(init, cfg.d_model, cfg.d_ff)

    def forward(self, x, positions, cfg: ModelConfig,
                cache: Optional[Cache] = None):
        attend = mla_attention if cfg.attn_type == "mla" else attention
        h, new_cache = attend(self.attn,
                              basic.rms_norm(self.ln1, x, cfg.norm_eps),
                              positions, cfg, cache)
        x = x + h
        y = basic.rms_norm(self.ln2, x, cfg.norm_eps)
        return x + basic.swiglu(self.ffn, y, cfg), new_cache


class VisionProj(nn.Module):
    """The VLM's projection of raw vision embeddings into the stream. Its
    parameters keep the reference's names, ``w`` and ``b``; ``w`` would
    shadow :meth:`Params.w`, so it is a plain module, cast at each use."""

    def __init__(self, init: ParamInit, cfg: ModelConfig):
        super().__init__()
        self.w = init.normal((cfg.vlm_vision_dim, cfg.d_model))
        self.b = init.zeros((cfg.d_model,))


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.n_experts:
        raise NotImplementedError("MoE FFNs (qwen3-moe) are not ported yet "
                                  "(ROADMAP Queue 1, D3)")
    if cfg.family not in ("dense", "vlm"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  f"(ROADMAP Queue 1, D3); DecoderLM runs "
                                  f"dense and vlm")


class DecoderLM(nn.Module):
    """Dense llama-likes, qwen2.5, chatglm3, minicpm3 (MLA) and the
    internvl2 text backbone (family ``"vlm"``) on PyTorch.

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
        if cfg.family == "vlm":
            self.vision_proj = VisionProj(init, cfg)
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
            "vocab_size", "head_dim", "qkv_bias", "tie_embeddings",
            "family", "attn_type", "q_lora_rank", "kv_lora_rank",
            "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim",
            "vlm_vision_dim"))

    # ---------------------------- forward ----------------------------

    def _embed_inputs(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Token embeddings; for the VLM with ``image_embeds`` (B, N,
        vlm_vision_dim), their projection put ahead of the text."""
        cfg = self.cfg
        x = basic.embed(self.embedding, batch["tokens"], cfg)
        if cfg.family == "vlm" and "image_embeds" in batch:
            p = self.vision_proj
            img = (batch["image_embeds"].to(cfg.dtype) @ p.w.to(cfg.dtype)
                   + p.b.to(cfg.dtype))
            x = torch.cat([img, x], dim=1)
        return x

    def forward_hidden(self, batch: Dict[str, torch.Tensor],
                       cache: Optional[Cache] = None):
        """Returns (final normed hidden (B, S, D), new_cache, aux)."""
        cfg = self.cfg
        x = self._embed_inputs(batch)
        bsz, s, _ = x.shape
        start = 0 if cache is None else cache_length(cache)
        positions = (start + torch.arange(s, device=x.device)).expand(bsz, s)
        for i, layer in enumerate(self.layers):
            lcache = None if cache is None else type(cache)(
                cache[0][i], cache[1][i], cache.length)
            x, _ = layer(x, positions, cfg, lcache)
        x = basic.rms_norm(self.ln_f, x, cfg.norm_eps)
        new_cache = None if cache is None else cache._replace(
            length=cache.length + s)
        return x, new_cache, {}

    def forward(self, batch: Dict[str, torch.Tensor],
                cache: Optional[Cache] = None, last_only: bool = False):
        """Returns (logits, new_cache, aux). ``last_only`` unembeds only the
        final position (prefill serving — avoids a (B,S,V) tensor)."""
        x, new_cache, aux = self.forward_hidden(batch, cache)
        if last_only:
            x = x[:, -1:]
        return basic.unembed(self.embedding, x, self.cfg), new_cache, aux

    # --------------------------- serving ---------------------------

    def init_cache(self, batch: int, max_len: int) -> Cache:
        """An empty cache stacked over layers: a KV cache (L, B, max_len,
        K, hd), or for MLA the latent cache (L, B, max_len, kv_lora) and
        its rope keys (L, B, max_len, rope_dim)."""
        init = init_mla_cache if self.cfg.attn_type == "mla" \
            else init_kv_cache
        return init(self.cfg, batch, max_len, layers=self.cfg.n_layers,
                    device=self.device)


def cache_length(cache: Any) -> int:
    """All layers share the same length."""
    return int(cache.length)

"""Zamba2-style hybrid: Mamba2 backbone + a shared attention block (twin of
``repro.models.hybrid``).

Structure (``cfg.n_layers`` mamba layers, period = ``cfg.hybrid_period``):
``n_groups = n_layers // period`` groups of ``period`` mamba layers, each
group preceded by an application of ONE shared transformer block (the
same weights at every application), plus ``n_layers % period`` trailing
mamba layers. The shared block works on ``concat([h, embeddings])``
(width 2d) and returns width d.

The reference stacks the mamba layers' parameters ``(n_groups, period,
...)`` and ``(n_tail, ...)`` and scans them; the port keeps one module
per layer (``groups.<g>.<i>``, ``tail.<i>``) and loops. The cache holds
one KV cache per application of the shared block (same weights,
different activations), stacked over groups with one length, and the
SSM state and conv tail of every mamba layer, stacked as the
reference's; both are written in place. The mamba layers are
``models.ssm_lm.MambaLayer``, so their conv runs through K7 with
``cfg.ssm_conv_impl == "pallas"``; a prefill longer than
``cfg.attn_chunk`` runs the shared block's attention through K8 with
``cfg.attn_impl == "flash"``.

Training: :meth:`HybridLM.loss` is the reference's chunked CE. With grad
enabled the mamba layers are checkpointed per ``cfg.remat``
(``models.lm.remat``) and the shared block fully unless ``cfg.remat`` is
``"none"``, as the reference's ``jax.checkpoint(self._shared)``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.dist.sharding import on_mesh
from repro_torch.layers import basic
from repro_torch.layers.attention import GQA, KVCache, attention, init_kv_cache
from repro_torch.layers.ssm import SSMCache, init_ssm_cache
from repro_torch.models.base import (ModelConfig, ParamInit, logical_axes,
                                     with_config)
from repro_torch.models.lm import ce_from_hidden, detached, remat
from repro_torch.models.ssm_lm import MambaLayer


class HybridLM(nn.Module):
    """zamba2 on PyTorch.

    Parameters are made on ``device`` (the card unless the caller asks
    for the CPU) from ``generator`` by the reference's init rule; they
    require grad (serving turns that off with ``requires_grad_(False)``).
    """

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        if cfg.attn_type != "gqa":
            raise NotImplementedError(f"the hybrid's shared block is GQA; "
                                      f"got attn_type {cfg.attn_type!r}")
        self.cfg = cfg
        self.n_groups = cfg.n_layers // cfg.hybrid_period
        self.n_tail = cfg.n_layers % cfg.hybrid_period
        d = cfg.d_model
        init = ParamInit(cfg, device=device, generator=generator)
        self.embedding = basic.Embedding(init, cfg)
        self.ln_f = basic.RMSNorm(init, d)
        self.shared_ln1 = basic.RMSNorm(init, 2 * d)
        self.shared_attn = GQA(init, cfg, in_dim=2 * d)
        self.shared_ln2 = basic.RMSNorm(init, 2 * d)
        self.shared_ffn = basic.SwiGLU(init, 2 * d, cfg.d_ff, d_out=d)
        self.groups = nn.ModuleList(
            nn.ModuleList(MambaLayer(init, cfg)
                          for _ in range(cfg.hybrid_period))
            for _ in range(self.n_groups))
        self.tail = nn.ModuleList(MambaLayer(init, cfg)
                                  for _ in range(self.n_tail))

    logical_axes = logical_axes

    @property
    def device(self) -> torch.device:
        return self.embedding.table.device

    def with_config(self, cfg: ModelConfig) -> "HybridLM":
        """The same parameters run under other execution knobs
        (``attn_impl``, ``attn_chunk``, ``ssm_conv_impl``, ``dtype``)."""
        return with_config(self, cfg, (
            "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
            "vocab_size", "head_dim", "qkv_bias", "tie_embeddings",
            "ssm_state", "ssm_conv", "ssm_expand", "ssm_head_dim",
            "ssm_groups", "hybrid_period"))

    def shared_block(self, x, emb, positions, kv: Optional[KVCache]):
        """One application of the shared block to the stream ``x`` beside
        the embeddings ``emb``; with ``kv``, its KV cache is written."""
        cfg = self.cfg
        cat = torch.cat([x, emb], dim=-1)
        h, _ = attention(self.shared_attn,
                         basic.rms_norm(self.shared_ln1, cat, cfg.norm_eps),
                         positions, cfg, kv)
        x = x + h
        cat2 = torch.cat([x, emb], dim=-1)
        f = basic.swiglu(self.shared_ffn,
                         basic.rms_norm(self.shared_ln2, cat2, cfg.norm_eps),
                         cfg)
        return x + f

    def mamba_layer(self, layer: MambaLayer, x,
                    cache: Optional[SSMCache] = None, idx=None):
        """``layer`` on ``x``; with a cache, its state and conv tail at
        ``idx`` are read and overwritten."""
        if cache is None:
            return remat(layer, self.cfg.remat)(x, self.cfg)[0]
        x, new = layer(x, self.cfg, SSMCache(cache.state[idx],
                                             cache.conv[idx]))
        cache.state[idx].copy_(new.state)
        cache.conv[idx].copy_(new.conv)
        return x

    def forward_hidden(self, batch: Dict[str, torch.Tensor],
                       cache: Optional[dict] = None):
        """Returns (final normed hidden (B, S, D), cache', aux). With a
        cache, its buffers are written in place and cache' holds them
        with the KV length advanced."""
        cfg = self.cfg
        emb = basic.embed(self.embedding, batch["tokens"], cfg)
        bsz, s, _ = emb.shape
        start = 0 if cache is None else cache["kv"].length
        positions = on_mesh((start + torch.arange(s, device=emb.device))
                            .expand(bsz, s))
        ssm_g = None if cache is None else cache["ssm_groups"]
        ssm_t = None if cache is None else cache.get("ssm_tail")
        x = emb
        shared = remat(self.shared_block,
                       "none" if cfg.remat == "none" else "full")
        for g, group in enumerate(self.groups):
            if cache is None:
                x = shared(x, emb, positions, None)
            else:
                x = self.shared_block(x, emb, positions, KVCache(
                    cache["kv"].k[g], cache["kv"].v[g], start))
            for i, layer in enumerate(group):
                x = self.mamba_layer(layer, x, ssm_g, (g, i))
        for i, layer in enumerate(self.tail):
            x = self.mamba_layer(layer, x, ssm_t, i)
        x = basic.rms_norm(self.ln_f, x, cfg.norm_eps)
        new_cache = None if cache is None else {
            **cache, "kv": KVCache(cache["kv"].k, cache["kv"].v, start + s)}
        return x, new_cache, {}

    def forward(self, batch: Dict[str, torch.Tensor],
                cache: Optional[dict] = None, last_only: bool = False):
        """Returns (logits, cache', aux). ``last_only`` unembeds only the
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

    def init_cache(self, batch: int, max_len: int) -> dict:
        """An empty cache, keyed as the reference's: ``kv`` (G, B, max_len,
        K, hd) with one length, ``ssm_groups`` state (G, period, B, ...)
        and conv (G, period, B, K-1, conv_dim), and with a tail
        ``ssm_tail`` (n_tail, B, ...)."""
        cfg, dev = self.cfg, self.device
        period = cfg.hybrid_period
        ssm = init_ssm_cache(cfg, batch, layers=self.n_groups * period,
                             device=dev)
        cache = {
            "kv": init_kv_cache(cfg, batch, max_len, layers=self.n_groups,
                                device=dev),
            "ssm_groups": SSMCache(*(t.view(self.n_groups, period,
                                            *t.shape[1:]) for t in ssm)),
        }
        if self.n_tail:
            cache["ssm_tail"] = init_ssm_cache(cfg, batch, layers=self.n_tail,
                                               device=dev)
        return cache

    def cache_axes(self) -> dict:
        """The cache's logical axes, keyed as the cache (the reference's)."""
        axes = {
            "kv": KVCache(k=("groups", "batch", "kv_seq", "kv_heads", None),
                          v=("groups", "batch", "kv_seq", "kv_heads", None),
                          length=("groups",)),
            "ssm_groups": SSMCache(
                state=("groups", None, "batch", None, "heads", None, None),
                conv=("groups", None, "batch", None, "ssm_inner")),
        }
        if self.n_tail:
            axes["ssm_tail"] = SSMCache(
                state=("layers", "batch", None, "heads", None, None),
                conv=("layers", "batch", None, "ssm_inner"))
        return axes

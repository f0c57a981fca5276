"""Decoder-only transformer LM: dense, MoE, MLA and the VLM backbone (twin
of ``repro.models.lm``).

One layer = pre-norm attention (GQA, or MLA for minicpm3) + pre-norm FFN
(SwiGLU, or the MoE layer for qwen3-moe). The reference stacks layer
parameters and runs ``lax.scan``; the port keeps one module per layer
(``layers.<i>``) and loops over them. The cache (a KV cache, or MLA's
latent cache) stays stacked over layers, as the reference's is. The VLM
family (internvl2) is the text backbone plus ``vision_proj``, which
projects precomputed patch embeddings (``batch["image_embeds"]``) ahead
of the text tokens.

Training: :meth:`DecoderLM.loss` is the reference's (chunked CE from the
hidden states over the padded vocab, plus ``0.01 * lb + 1e-3 * z`` for
MoE). With grad enabled each layer is checkpointed per ``cfg.remat``
(:func:`remat`): ``"full"`` keeps a layer's input and recomputes the
rest in the backward, ``"dots"`` also keeps the matmul outputs, as
``jax.checkpoint_policies.checkpoint_dots`` does.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.dist.sharding import constrain, on_mesh
from repro_torch.layers import basic
from repro_torch.layers.attention import GQA, KVCache, attention, init_kv_cache
from repro_torch.layers.mla import MLA, MLACache, init_mla_cache, mla_attention
from repro_torch.layers.moe import MoE, moe_ffn
from repro_torch.models.base import (ModelConfig, ParamInit, logical_axes,
                                     with_config)

Cache = KVCache | MLACache

MOE_AUX = ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")

# The matmul ops whose outputs ``remat="dots"`` keeps.
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn: Callable, mode: str) -> Callable:
    """``fn`` checkpointed per ``mode`` when grad is enabled (the
    reference's ``_remat``): ``"none"``, ``"full"`` or ``"dots"``."""
    if mode not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat mode {mode!r}")
    if mode == "none":
        return fn

    @functools.wraps(fn)
    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        kw = {} if mode == "full" else {"context_fn": functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)}
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)
    return run


class DecoderLayer(nn.Module):
    def __init__(self, init: ParamInit, cfg: ModelConfig):
        super().__init__()
        self.ln1 = basic.RMSNorm(init, cfg.d_model)
        self.attn = (MLA if cfg.attn_type == "mla" else GQA)(init, cfg)
        self.ln2 = basic.RMSNorm(init, cfg.d_model)
        self.ffn = (MoE(init, cfg) if cfg.n_experts
                    else basic.SwiGLU(init, cfg.d_model, cfg.d_ff))

    def forward(self, x, positions, cfg: ModelConfig,
                cache: Optional[Cache] = None):
        """Returns (x', cache', aux); aux holds the MoE metrics, or is
        empty."""
        attend = mla_attention if cfg.attn_type == "mla" else attention
        h, new_cache = attend(self.attn,
                              basic.rms_norm(self.ln1, x, cfg.norm_eps),
                              positions, cfg, cache)
        x = x + h
        y = basic.rms_norm(self.ln2, x, cfg.norm_eps)
        if cfg.n_experts:
            f, aux = moe_ffn(self.ffn, y, cfg)
        else:
            f, aux = basic.swiglu(self.ffn, y, cfg), {}
        return x + f, new_cache, aux


class DecoderLM(nn.Module):
    """Dense llama-likes, qwen2.5, chatglm3, minicpm3 (MLA), qwen3-moe
    (family ``"moe"``) and the internvl2 text backbone (family ``"vlm"``)
    on PyTorch.

    Parameters are made on ``device`` (the card unless the caller asks
    for the CPU) from ``generator`` by the reference's init rule; they
    require grad (serving turns that off with ``requires_grad_(False)``).
    """

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"DecoderLM runs the dense, moe and vlm "
                             f"families; got {cfg.family!r}")
        self.cfg = cfg
        init = ParamInit(cfg, device=device, generator=generator)
        self.embedding = basic.Embedding(init, cfg)
        self.ln_f = basic.RMSNorm(init, cfg.d_model)
        if cfg.family == "vlm":
            self.vision_proj = basic.Projection(init, cfg.vlm_vision_dim,
                                                cfg.d_model)
        self.layers = nn.ModuleList(DecoderLayer(init, cfg)
                                    for _ in range(cfg.n_layers))

    logical_axes = logical_axes

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
            "vlm_vision_dim", "n_experts"))

    # ---------------------------- forward ----------------------------

    def _embed_inputs(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Token embeddings; for the VLM with ``image_embeds`` (B, N,
        vlm_vision_dim), their projection put ahead of the text."""
        cfg = self.cfg
        x = basic.embed(self.embedding, batch["tokens"], cfg)
        if cfg.family == "vlm" and "image_embeds" in batch:
            img = self.vision_proj(batch["image_embeds"], cfg.dtype)
            x = torch.cat([img, x], dim=1)
        return x

    def forward_hidden(self, batch: Dict[str, torch.Tensor],
                       cache: Optional[Cache] = None):
        """Returns (final normed hidden (B, S, D), new_cache, aux); for
        MoE, aux holds each metric's mean over the layers."""
        cfg = self.cfg
        x = self._embed_inputs(batch)
        bsz, s, _ = x.shape
        start = 0 if cache is None else cache_length(cache)
        positions = on_mesh(
            (start + torch.arange(s, device=x.device)).expand(bsz, s))
        zero = on_mesh(torch.zeros((), dtype=torch.float32, device=x.device))
        aux = dict.fromkeys(MOE_AUX, zero) if cfg.n_experts else {}
        for i, layer in enumerate(self.layers):
            if cache is None:
                x, _, a = remat(functools.partial(
                    layer, positions=positions, cfg=cfg), cfg.remat)(x)
            else:
                lcache = type(cache)(cache[0][i], cache[1][i], cache.length)
                x, _, a = layer(x, positions, cfg, lcache)
            aux = {k: aux[k] + a[k] for k in aux}
        x = basic.rms_norm(self.ln_f, x, cfg.norm_eps)
        new_cache = None if cache is None else cache._replace(
            length=cache.length + s)
        if cfg.n_experts:
            aux = {k: v / cfg.n_layers for k, v in aux.items()}
        return x, new_cache, aux

    def forward(self, batch: Dict[str, torch.Tensor],
                cache: Optional[Cache] = None, last_only: bool = False):
        """Returns (logits, new_cache, aux). ``last_only`` unembeds only the
        final position (prefill serving — avoids a (B,S,V) tensor)."""
        x, new_cache, aux = self.forward_hidden(batch, cache)
        if last_only:
            x = x[:, -1:]
        return basic.unembed(self.embedding, x, self.cfg), new_cache, aux

    # ----------------------------- loss -----------------------------

    def loss(self, batch: Dict[str, torch.Tensor]):
        """Returns (loss, metrics): the next-token CE over the text (the
        VLM's image positions carry none), plus for MoE ``0.01 * lb +
        1e-3 * z``; metrics hold ``ce`` and the MoE aux, detached."""
        cfg = self.cfg
        x, _, aux = self.forward_hidden(batch)
        if cfg.family == "vlm" and "image_embeds" in batch:
            x = x[:, batch["image_embeds"].shape[1]:]
        ce = ce_from_hidden(x, basic.head_weight(self.embedding, cfg),
                            batch["labels"], cfg.padded_vocab, cfg.vocab_size)
        total = ce
        if aux:
            total = total + 0.01 * aux["moe_lb_loss"] \
                + 1e-3 * aux["moe_z_loss"]
        return total, detached({"ce": ce, **aux})

    # --------------------------- serving ---------------------------

    def init_cache(self, batch: int, max_len: int) -> Cache:
        """An empty cache stacked over layers: a KV cache (L, B, max_len,
        K, hd), or for MLA the latent cache (L, B, max_len, kv_lora) and
        its rope keys (L, B, max_len, rope_dim)."""
        init = init_mla_cache if self.cfg.attn_type == "mla" \
            else init_kv_cache
        return init(self.cfg, batch, max_len, layers=self.cfg.n_layers,
                    device=self.device)

    def cache_axes(self) -> Cache:
        """The cache's logical axes, the reference's (``dist.sharding``
        resolves them); ``length`` is a Python int here."""
        if self.cfg.attn_type == "mla":
            return MLACache(c_kv=("layers", "batch", "kv_seq", None),
                            k_rope=("layers", "batch", "kv_seq", None),
                            length=("layers",))
        return KVCache(k=("layers", "batch", "kv_seq", "kv_heads", None),
                       v=("layers", "batch", "kv_seq", "kv_heads", None),
                       length=("layers",))


def cache_length(cache: Any) -> int:
    """All layers share the same length."""
    return int(cache.length)


def detached(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in metrics.items()}


def _pad_mask(padded_vocab: int, true_vocab: int, device) -> torch.Tensor:
    """-1e30 additive bias over the padded vocab tail (f32)."""
    ids = torch.arange(padded_vocab, device=device)
    return on_mesh(torch.where(ids < true_vocab, 0.0, -1e30).to(torch.float32))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  padded_vocab: int, true_vocab: int) -> torch.Tensor:
    """Mean next-token CE; padded vocab ids masked out of the softmax."""
    logits = logits + _pad_mask(padded_vocab, true_vocab, logits.device)
    logz = torch.logsumexp(logits, dim=-1)
    gold = constrain(torch.gather(logits, -1, labels[..., None]),
                     ("batch", None, None))[..., 0]  # see ce_from_hidden
    return torch.mean(logz - gold)


def ce_from_hidden(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                   padded_vocab: int, true_vocab: int,
                   chunk: int = 512) -> torch.Tensor:
    """Sequence-chunked CE straight from hidden states (B, S, D) and the
    head ``w`` (D, V).

    Never materializes the (B, S, V) logits: each chunk's (B, chunk, V)
    logits are reduced to (logz, gold) and dropped. The logits are the
    f32 products of the compute-dtype operands (the reference's
    ``preferred_element_type=float32``: no rounding to the compute dtype).
    """
    bsz, s, _ = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        chunk = s  # fall back (small odd sequences in tests)
    mask = _pad_mask(padded_vocab, true_vocab, x.device)
    x = constrain(x, ("batch", None, None))  # TP's input, whole
    wf = w.to(torch.float32)
    total = on_mesh(torch.zeros((), dtype=torch.float32, device=x.device))
    for c0 in range(0, s, chunk):
        logits = x[:, c0:c0 + chunk].to(torch.float32) @ wf + mask
        logz = torch.logsumexp(logits, dim=-1)
        # Under a mesh the vocab-split gather is a masked partial sum,
        # summed here, before the select drops the axis its mask has.
        gold = constrain(torch.gather(logits, -1,
                                      labels[:, c0:c0 + chunk, None]),
                         ("batch", None, None))[..., 0]
        total = total + torch.sum(logz - gold)
    return total / (bsz * s)

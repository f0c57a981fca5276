"""HuBERT-style bidirectional encoder (twin of ``repro.models.encoder``).

The modality frontend (a conv feature extractor over the raw waveform)
is a stub, as in the reference: ``batch["features"]`` holds precomputed
frame features (B, S, audio_feat_dim); the model projects them to
d_model and runs a non-causal transformer encoder (pre-norm LayerNorm,
GQA attention with RoPE, GELU MLP). With ``cfg.attn_impl == "flash"`` a
sequence longer than ``cfg.attn_chunk`` attends through K8, non-causal.
Training objective: frame-level CE against cluster labels over the true
vocab. The reference stacks layer parameters and scans them; the port
keeps one module per layer (``layers.<i>``), each checkpointed per
``cfg.remat`` when grad is enabled.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.dist.sharding import constrain, on_mesh
from repro_torch.layers import basic
from repro_torch.layers.attention import GQA, attention
from repro_torch.models.base import (ModelConfig, ParamInit, logical_axes,
                                     with_config)
from repro_torch.models.lm import _pad_mask, detached, remat


class EncoderLayer(nn.Module):
    def __init__(self, init: ParamInit, cfg: ModelConfig):
        super().__init__()
        self.ln1 = basic.LayerNorm(init, cfg.d_model)
        self.attn = GQA(init, cfg)
        self.ln2 = basic.LayerNorm(init, cfg.d_model)
        self.ffn = basic.GeluMLP(init, cfg.d_model, cfg.d_ff)

    def forward(self, x, positions, cfg: ModelConfig):
        h, _ = attention(self.attn,
                         basic.layer_norm(self.ln1, x, cfg.norm_eps),
                         positions, cfg, None)
        x = x + h
        f = basic.gelu_mlp(self.ffn,
                           basic.layer_norm(self.ln2, x, cfg.norm_eps), cfg)
        return x + f


class EncoderModel(nn.Module):
    """hubert-xlarge on PyTorch.

    Parameters are made on ``device`` (the card unless the caller asks
    for the CPU) from ``generator`` by the reference's init rule; they
    require grad (serving turns that off with ``requires_grad_(False)``).
    """

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        if cfg.causal:
            raise ValueError("the encoder is non-causal: cfg.causal must be "
                             "False")
        self.cfg = cfg
        init = ParamInit(cfg, device=device, generator=generator)
        self.feature_proj = basic.Projection(init, cfg.audio_feat_dim,
                                             cfg.d_model)
        self.ln_f = basic.LayerNorm(init, cfg.d_model)
        self.head = basic.Projection(init, cfg.d_model, cfg.padded_vocab,
                                     bias=False, axes=("embed", "vocab"))
        self.layers = nn.ModuleList(EncoderLayer(init, cfg)
                                    for _ in range(cfg.n_layers))

    logical_axes = logical_axes

    @property
    def device(self) -> torch.device:
        return self.head.w.device

    def with_config(self, cfg: ModelConfig) -> "EncoderModel":
        """The same parameters run under other execution knobs
        (``attn_impl``, ``attn_chunk``, ``dtype``, ``remat``)."""
        return with_config(self, cfg, (
            "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
            "vocab_size", "head_dim", "qkv_bias", "audio_feat_dim",
            "causal"))

    def forward(self, batch: Dict[str, torch.Tensor], cache=None,
                last_only: bool = False):
        """Returns (frame logits (B, S, padded vocab) in f32, None, {})."""
        cfg = self.cfg
        if cache is not None:
            raise ValueError("the encoder-only model has no decode step")
        del last_only  # the encoder emits all frame logits (vocab is tiny)
        x = self.feature_proj(batch["features"], cfg.dtype)
        bsz, s, _ = x.shape
        positions = on_mesh(torch.arange(s, device=x.device).expand(bsz, s))
        for layer in self.layers:
            x = remat(layer, cfg.remat)(x, positions, cfg)
        x = basic.layer_norm(self.ln_f, x, cfg.norm_eps)
        return self.head(x, cfg.dtype).to(torch.float32), None, {}

    def loss(self, batch: Dict[str, torch.Tensor]):
        """Returns (ce, {"ce": ce}): frame CE against ``batch["labels"]``."""
        cfg = self.cfg
        logits, _, _ = self.forward(batch)
        if isinstance(logits, DTensor):
            # the vocab is split: mask its padded tail where it lies (a
            # slice of the split dim would gather the logits whole)
            logz = torch.logsumexp(logits + _pad_mask(
                cfg.padded_vocab, cfg.vocab_size, logits.device), dim=-1)
        else:
            logz = torch.logsumexp(logits[..., :cfg.vocab_size], dim=-1)
        gold = constrain(torch.gather(logits, -1, batch["labels"][..., None]),
                         ("batch", None, None))[..., 0]  # lm.ce_from_hidden
        ce = torch.mean(logz - gold)
        return ce, detached({"ce": ce})

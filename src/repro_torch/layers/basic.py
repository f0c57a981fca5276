"""Norms, MLPs, embedding (twin of ``repro.layers.basic``).

Each function takes ``p``, the module that holds its parameters, where
the reference takes a parameter dict; the modules' ``forward`` calls the
function. Projections stay ``torch.matmul``, as the reference leaves
them to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist.sharding import constrain, gathered, lookup

from repro_torch.models.base import ModelConfig, ParamInit, Params


class RMSNorm(Params):
    AXES = {"scale": (None,)}

    def __init__(self, init: ParamInit, dim: int):
        super().__init__()
        self.scale = init.ones((dim,))

    def forward(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        return rms_norm(self, x, eps)


def rms_norm(p: RMSNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p.scale.to(torch.float32)).to(x.dtype)


class LayerNorm(Params):
    AXES = {"scale": (None,), "bias": (None,)}

    def __init__(self, init: ParamInit, dim: int):
        super().__init__()
        self.scale = init.ones((dim,))
        self.bias = init.zeros((dim,))

    def forward(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        return layer_norm(self, x, eps)


def layer_norm(p: LayerNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    c = xf - mu
    var = torch.mean(c * c, dim=-1, keepdim=True)
    y = c * torch.rsqrt(var + eps)
    y = y * p.scale.to(torch.float32) + p.bias.to(torch.float32)
    return y.to(x.dtype)


class SwiGLU(Params):
    AXES = {"gate": ("embed", "mlp"), "up": ("embed", "mlp"),
            "down": ("mlp", "embed")}

    def __init__(self, init: ParamInit, d: int, f: int,
                 d_out: int | None = None):
        super().__init__()
        self.gate = init.normal((d, f))
        self.up = init.normal((d, f))
        self.down = init.normal((f, d_out or d))

    def forward(self, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        return swiglu(self, x, cfg)


def swiglu(p: SwiGLU, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = cfg.dtype
    x = constrain(x, ("batch", None, None))  # TP's input, whole
    g = x @ p.w("gate", dt)
    u = x @ p.w("up", dt)
    h = F.silu(g.to(torch.float32)).to(dt) * u
    h = constrain(h, ("batch", None, "mlp"))
    return constrain(h @ p.w("down", dt), ("batch", None, None))


class GeluMLP(Params):
    AXES = {"up": ("embed", "mlp"), "up_b": ("mlp",),
            "down": ("mlp", "embed"), "down_b": (None,)}

    def __init__(self, init: ParamInit, d: int, f: int):
        super().__init__()
        self.up = init.normal((d, f))
        self.up_b = init.zeros((f,))
        self.down = init.normal((f, d))
        self.down_b = init.zeros((d,))

    def forward(self, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        return gelu_mlp(self, x, cfg)


def gelu_mlp(p: GeluMLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The reference's ``jax.nn.gelu``: the tanh approximation, in f32."""
    dt = cfg.dtype
    x = constrain(x, ("batch", None, None))  # TP's input, whole
    h = x @ p.w("up", dt) + p.w("up_b", dt)
    h = F.gelu(h.to(torch.float32), approximate="tanh").to(dt)
    h = constrain(h, ("batch", None, "mlp"))
    return constrain(h @ p.w("down", dt), ("batch", None, None)) \
        + p.w("down_b", dt)


class Projection(nn.Module):
    """``x @ w (+ b)`` with the reference's parameter names ``w`` and
    ``b`` (the VLM's ``vision_proj``, the encoder's ``feature_proj`` and
    ``head``). ``w`` would shadow :meth:`Params.w`, so this is a plain
    module, cast at each use. ``axes`` are ``w``'s logical axes (``b``'s
    are ``(None,)``), which differ between those uses."""

    def __init__(self, init: ParamInit, d_in: int, d_out: int,
                 bias: bool = True, axes: tuple = (None, "embed")):
        super().__init__()
        self.AXES = {"w": axes, "b": (None,)}
        self.w = init.normal((d_in, d_out))
        if bias:
            self.b = init.zeros((d_out,))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = constrain(x.to(dtype), ("batch", None, None))
        y = x @ gathered(self.w.to(dtype))
        return y + self.b.to(dtype) if hasattr(self, "b") else y


class Embedding(Params):
    """The token table (padded vocab) and, when untied, the LM head."""

    AXES = {"table": ("vocab", "embed"), "head": ("embed", "vocab")}

    def __init__(self, init: ParamInit, cfg: ModelConfig):
        super().__init__()
        v, d = cfg.padded_vocab, cfg.d_model
        self.table = init.normal((v, d), scale=0.02)
        if not cfg.tie_embeddings:
            self.head = init.normal((d, v))


def embed(p: Embedding, tokens: torch.Tensor,
          cfg: ModelConfig) -> torch.Tensor:
    return lookup(p.w("table", cfg.dtype), tokens, ("batch", None, None))


def head_weight(p: Embedding, cfg: ModelConfig) -> torch.Tensor:
    """The (d, V) head in the compute dtype; the tied head is the table's
    transpose."""
    if cfg.tie_embeddings:
        return p.w("table", cfg.dtype).T
    return p.w("head", cfg.dtype)


def unembed(p: Embedding, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits in f32 over the padded vocab (softmax stability)."""
    x = constrain(x, ("batch", None, None))  # TP's input, whole
    return (x @ head_weight(p, cfg)).to(torch.float32)

"""Model configuration and parameter creation (twin of ``repro.models.base``).

The JAX package keeps parameters in nested dicts built by a
``ParamBuilder``; the port keeps them in ``nn.Module``s whose parameter
names follow the same tree (``layers.3.attn.wq`` here is
``params["layers"]["attn"]["wq"][3]`` there), so ``interop`` can carry a
JAX tree over name by name.

:class:`ParamInit` applies the reference's init rule with an explicit
``torch.Generator``: ``normal`` is a standard normal times
``1/sqrt(shape[0])`` (or the given scale), ``zeros`` and ``ones`` are
constant, ``const`` holds a given value, and every parameter is stored
in ``cfg.param_dtype``. The numbers differ from JAX's for the same seed
(the generators differ); the shapes and scales do not.

Parameters are trainable (``requires_grad=True``); the serving entry
points turn that off with ``model.requires_grad_(False)``.
:meth:`Params.w` returns a parameter in the compute dtype. The JAX model
casts at every use. With grad enabled and a parameter that requires
grad, so does the port: the cast stays in the autograd graph. Otherwise
(under ``torch.no_grad()`` or ``torch.inference_mode()``, as serving
runs) the port keeps one cast copy per parameter and remakes it when the
parameter's storage or version changes, so a load, an optimizer step or
an in-place edit is never served stale.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.core.stencil import require_device
from repro_torch.dist.sharding import gathered


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 2
    n_kv_heads: int = 2
    d_ff: int = 256
    vocab_size: int = 256
    head_dim: int = 0          # 0 -> d_model // n_heads

    # attention flavour
    attn_type: str = "gqa"     # gqa | mla
    qkv_bias: bool = False     # qwen2.5
    rope_frac: float = 1.0     # fraction of head dims rotated (chatglm: 0.5)
    rope_theta: float = 10000.0
    causal: bool = True        # False for encoder-only (hubert)

    # MLA (minicpm3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # MoE (qwen3-moe)
    n_experts: int = 0
    experts_per_token: int = 0
    moe_group_size: int = 256
    moe_capacity_factor: float = 1.25

    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_groups: int = 1

    # hybrid (zamba2): shared attention block applied every k mamba layers
    hybrid_period: int = 6

    # VLM (internvl2): number of image tokens and raw vision-embed width
    vlm_image_tokens: int = 0
    vlm_vision_dim: int = 1024

    # encoder stub (hubert): raw frame-feature width
    audio_feat_dim: int = 0

    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16      # activation/compute dtype
    param_dtype: Any = torch.float32  # parameter storage dtype

    # execution knobs
    remat: str = "full"        # none | full | dots (checkpointing a layer)
    attn_chunk: int = 1024     # kv-chunked attention threshold/chunk
    scan_layers: bool = True   # kept for parity; the port loops layers
    # "jnp" = the plain online-softmax chunked loop of tensor ops;
    # "flash" = the hand-written CUDA kernel (K8, forward-only: serving).
    attn_impl: str = "jnp"
    # Mamba2's depthwise causal conv: "jnp" = plain tensor ops (the
    # reference's default, read there with getattr); "pallas" = the
    # hand-written CUDA kernel (K7).
    ssm_conv_impl: str = "jnp"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to 256 (Megatron-style) so TP sharding divides."""
        return round_up(self.vocab_size, 256)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def n_params(self) -> int:
        """Parameter count from the parameter shapes."""
        from repro_torch.models import registry  # lazy; avoids a cycle
        return registry.count_params(self)


class ParamInit:
    """Makes parameters by the reference's init rule on ``device``.

    ``device="meta"`` makes shapes only (no storage, no random numbers).
    Each parameter is drawn in f32 and cast to ``cfg.param_dtype`` alone,
    so no temporary larger than one parameter's f32 draw is made.
    """

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: torch.Generator | None = None):
        self.cfg = cfg
        self.device = (torch.device("meta") if str(device) == "meta"
                       else require_device(device))
        if generator is None and self.device.type != "meta":
            generator = torch.Generator(self.device).manual_seed(0)
        self.generator = generator

    def _param(self, t: torch.Tensor) -> nn.Parameter:
        return nn.Parameter(t.to(self.cfg.param_dtype))

    def normal(self, shape: tuple[int, ...],
               scale: float | None = None) -> nn.Parameter:
        scale = scale if scale is not None else 1.0 / math.sqrt(
            max(1, shape[0]))
        if self.device.type == "meta":
            return self._param(torch.empty(shape, device=self.device))
        x = torch.randn(shape, generator=self.generator, device=self.device,
                        dtype=torch.float32)
        return self._param(x * scale)

    def zeros(self, shape: tuple[int, ...]) -> nn.Parameter:
        return self._param(torch.zeros(shape, device=self.device))

    def ones(self, shape: tuple[int, ...]) -> nn.Parameter:
        return self._param(torch.ones(shape, device=self.device))

    def const(self, value: torch.Tensor) -> nn.Parameter:
        """A parameter holding ``value`` (the reference's ``const``)."""
        if self.device.type == "meta":
            return self._param(torch.empty(value.shape, device=self.device))
        return self._param(value.to(self.device))


def with_config(model: nn.Module, cfg: ModelConfig,
                shape: tuple[str, ...]) -> nn.Module:
    """``model``'s parameters under ``cfg``, which may change execution
    knobs (``dtype``, ``attn_impl``, ...) but none of the ``shape`` fields."""
    if any(getattr(cfg, f) != getattr(model.cfg, f) for f in shape):
        raise ValueError("with_config changes execution knobs only, "
                         "not parameter shapes")
    twin = copy.copy(model)
    twin.cfg = cfg
    return twin


class Params(nn.Module):
    """A module whose parameters are read through :meth:`w`.

    ``AXES`` names each parameter's logical axes (the reference's
    ``ParamBuilder`` specs: ``"embed"``, ``"heads"``, ...), one entry a
    dimension; :func:`logical_axes` collects them for a model."""

    AXES: dict[str, tuple] = {}

    def __init__(self):
        super().__init__()
        self._cast: dict = {}

    def w(self, name: str, dtype: torch.dtype) -> torch.Tensor:
        """Parameter ``name`` in ``dtype``: the cast in the autograd graph
        when grad is enabled and ``name`` requires grad, else a cached
        cast copy."""
        p = getattr(self, name)
        if isinstance(p, DTensor):  # partitioned: cast, then gather
            return gathered(p if p.dtype == dtype else p.to(dtype))
        if p.dtype == dtype:
            return p
        if p.requires_grad and torch.is_grad_enabled():
            return p.to(dtype)
        key = (p.data_ptr(), p.device,
               0 if p.is_inference() else p._version)
        hit = self._cast.get((name, dtype))
        if hit is None or hit[0] != key:
            hit = self._cast[(name, dtype)] = (key, p.detach().to(dtype))
        return hit[1]


def logical_axes(model: nn.Module) -> dict[str, tuple]:
    """The reference's logical axes of every parameter of ``model``, keyed
    by the port's parameter name (``layers.3.attn.wq``).

    The reference stacks a family's layers and prepends ``"layers"`` (a
    hybrid's groups ``("groups", None)``) to each stacked leaf's axes; the
    port keeps one tensor a layer, so its axes are the reference's without
    the stacked prefix, one entry for each of the tensor's dimensions.
    ``dist.sharding`` resolves them against a mesh."""
    out = {}
    for prefix, mod in model.named_modules():
        axes = getattr(mod, "AXES", {})
        for name, p in mod.named_parameters(prefix=prefix, recurse=False):
            leaf = name.rsplit(".", 1)[-1]
            if leaf not in axes or len(axes[leaf]) != p.dim():
                raise KeyError(f"{name} {tuple(p.shape)}: no logical axes "
                               f"of its rank in {type(mod).__name__}.AXES")
            out[name] = tuple(axes[leaf])
    return out

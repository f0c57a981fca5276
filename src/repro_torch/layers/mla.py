"""Multi-head Latent Attention (MLA) — MiniCPM3 / DeepSeek-V2 style
(twin of ``repro.layers.mla``).

Prefill computes full K/V from the latent; decode uses the *absorbed*
form: the KV up-projections are folded into the query/output paths so
attention runs directly against the (kv_lora_rank + rope_dim)-wide latent
cache, which is ~(2·K·hd)/(kv_lora+rope) times smaller than GQA's.

The expanded prefill runs the plain attention of ``layers.attention``
(``_full_attention`` / ``_chunked_attention``), never K8, whatever
``cfg.attn_impl`` says, as the reference's does: its q/k head dim
(nope + rope, 96 for minicpm3-4b) differs from v's (64), and the flash
kernel takes one head dim for q, k and v. The cache is written in place,
as the port's KV cache is.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.dist.sharding import constrain, on_mesh, view, write_slice
from repro_torch.layers.attention import (NEG_INF, _chunked_attention,
                                          _full_attention)
from repro_torch.layers.basic import RMSNorm, rms_norm
from repro_torch.layers.rope import apply_rope
from repro_torch.models.base import ModelConfig, ParamInit, Params


class MLACache(NamedTuple):
    c_kv: torch.Tensor    # (B, S_max, kv_lora), or (L, B, S_max, kv_lora)
    k_rope: torch.Tensor  # (B, S_max, rope_dim), or (L, B, S_max, rope_dim)
    length: int           # tokens currently valid


class MLA(Params):
    """MLA's projections: a low-rank query (``q_down``, ``q_norm``,
    ``q_up``; or ``q_proj`` without ``q_lora_rank``), the KV latent with
    its shared rope key (``kv_down``, ``kv_norm``), its up-projections
    (``k_up``, ``v_up``) and ``wo``."""

    AXES = {"q_down": ("embed", None), "q_up": (None, "heads"),
            "q_proj": ("embed", "heads"), "kv_down": ("embed", None),
            "k_up": (None, "heads"), "v_up": (None, "heads"),
            "wo": ("heads", "embed")}

    def __init__(self, init: ParamInit, cfg: ModelConfig):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        if qr:
            self.q_down = init.normal((d, qr))
            self.q_norm = RMSNorm(init, qr)
            self.q_up = init.normal((qr, h * (nope + rope)))
        else:
            self.q_proj = init.normal((d, h * (nope + rope)))
        self.kv_down = init.normal((d, kvr + rope))
        self.kv_norm = RMSNorm(init, kvr)
        self.k_up = init.normal((kvr, h * nope))
        self.v_up = init.normal((kvr, h * cfg.v_head_dim))
        self.wo = init.normal((h * cfg.v_head_dim, d))

    def forward(self, x, positions, cfg: ModelConfig,
                cache: Optional[MLACache] = None):
        return mla_attention(self, x, positions, cfg, cache)


def _queries(p: MLA, x, positions, cfg: ModelConfig):
    dt = cfg.dtype
    bsz, s, _ = x.shape
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    x = constrain(x, ("batch", None, None))  # TP's input, whole
    if cfg.q_lora_rank:
        cq = rms_norm(p.q_norm, x @ p.w("q_down", dt), cfg.norm_eps)
        q = cq @ p.w("q_up", dt)
    else:
        q = x @ p.w("q_proj", dt)
    q = view(q, (bsz, s, cfg.n_heads, nope + rope),
             ("batch", "qseq", "heads", None))
    q_rope = apply_rope(q[..., nope:], positions, frac=1.0,
                        theta=cfg.rope_theta)
    return q[..., :nope], q_rope


def _latents(p: MLA, x, positions, cfg: ModelConfig):
    kvr = cfg.kv_lora_rank
    down = constrain(x @ p.w("kv_down", cfg.dtype), ("batch", None, None))
    c_kv = rms_norm(p.kv_norm, down[..., :kvr], cfg.norm_eps)
    # One shared rope "head" (broadcast over query heads).
    k_rope = apply_rope(down[:, :, None, kvr:], positions, frac=1.0,
                        theta=cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _append(cache: MLACache, c_kv, k_rope) -> MLACache:
    start, s, smax = cache.length, c_kv.shape[1], cache.c_kv.shape[1]
    if start + s > smax:
        raise ValueError(f"cache of {smax} tokens holds {start}; cannot "
                         f"append {s}")
    write_slice(cache.c_kv, 1, start, c_kv.to(cache.c_kv.dtype))
    write_slice(cache.k_rope, 1, start, k_rope.to(cache.k_rope.dtype))
    return MLACache(cache.c_kv, cache.k_rope, start + s)


def mla_attention(p: MLA, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig, cache: Optional[MLACache] = None
                  ) -> tuple[torch.Tensor, Optional[MLACache]]:
    """MLA over ``x`` (B, S, d) at ``positions`` (B, S).

    Three paths, as the reference's: a prompt longer than
    ``cfg.attn_chunk`` into a cache writes its latents and attends by the
    expanded path (exact for an empty cache, the serving engine's prefill
    contract); a shorter input with a cache attends in the absorbed form
    over the whole latent cache, its unwritten tail masked; without a
    cache, the expanded path. Returns (out (B, S, d), cache').
    """
    dt = cfg.dtype
    bsz, s, _ = x.shape
    h = cfg.n_heads
    nope, rope, vhd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                       cfg.v_head_dim)
    kvr = cfg.kv_lora_rank
    scale = (nope + rope) ** -0.5

    q_nope, q_rope = _queries(p, x, positions, cfg)
    c_kv, k_rope = _latents(p, x, positions, cfg)
    w_ku = view(p.w("k_up", dt), (kvr, h, nope), (None, "heads", None))
    w_vu = view(p.w("v_up", dt), (kvr, h, vhd), (None, "heads", None))

    if cache is not None and s > cfg.attn_chunk:
        new_cache = _append(cache, c_kv, k_rope)
        out, _ = mla_attention(p, x, positions, cfg, None)
        return out, new_cache

    if cache is not None:
        # -------- absorbed decode/serve path over the latent cache --------
        new_cache = _append(cache, c_kv, k_rope)
        c_all, r_all = new_cache.c_kv.to(dt), new_cache.k_rope.to(dt)
        smax = c_all.shape[1]
        k_pos = on_mesh(torch.arange(smax, device=x.device)[None, :])
        valid = k_pos < new_cache.length
        q_abs = torch.einsum("bshn,rhn->bshr", q_nope, w_ku)
        # f32 scores of the compute-dtype operands (the reference's
        # preferred_element_type=f32).
        scores = (torch.einsum("bshr,btr->bhst", q_abs.float(),
                               c_all.float())
                  + torch.einsum("bshr,btr->bhst", q_rope.float(),
                                 r_all.float())) * scale
        mask = ((k_pos[:, None, None, :] <= positions[:, None, :, None])
                & valid[:, None, None, :])
        scores = torch.where(mask, scores, NEG_INF)
        pr = torch.softmax(scores, dim=-1).to(dt)
        ctx_lat = torch.einsum("bhst,btr->bshr", pr, c_all)
        ctx = torch.einsum("bshr,rhv->bshv", ctx_lat, w_vu)
        out = view(ctx, (bsz, s, h * vhd), ("batch", None, "heads")) \
            @ p.w("wo", dt)
        return constrain(out, ("batch", None, None)), new_cache

    # -------- prefill/training path: expand latents to full K/V --------
    k_nope = torch.einsum("btr,rhn->bthn", c_kv, w_ku)
    v = torch.einsum("btr,rhv->bthv", c_kv, w_vu)
    heads = ("batch", None, "heads", None)
    k = torch.cat([constrain(k_nope, heads), constrain(
        k_rope[:, :, None, :].expand(bsz, s, h, rope), heads)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    attend = _chunked_attention if s > cfg.attn_chunk else _full_attention
    ctx = attend(q, k, constrain(v, heads), positions, positions,
                 cfg.causal, cfg)
    out = view(ctx, (bsz, s, h * vhd), ("batch", None, "heads")) \
        @ p.w("wo", dt)
    return constrain(out, ("batch", None, None)), None


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                   *, layers: int | None = None,
                   device="cuda") -> MLACache:
    """An empty latent cache; with ``layers``, stacked over a leading
    layer axis."""
    dtype = dtype or cfg.dtype
    lead = () if layers is None else (layers,)
    return MLACache(
        c_kv=torch.zeros((*lead, batch, max_len, cfg.kv_lora_rank),
                         dtype=dtype, device=device),
        k_rope=torch.zeros((*lead, batch, max_len, cfg.qk_rope_head_dim),
                           dtype=dtype, device=device),
        length=0)
